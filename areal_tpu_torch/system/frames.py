"""Multipart messages over TCP: the one framing of every socket of the port.

The reference carries its control and weight streams over zmq sockets;
the port carries the same multipart messages over plain TCP sockets (the
card's machine is not known to have zmq). A message is a little-endian u32
frame count, then for each frame a u64 length and its bytes.

 - :class:`FrameSocket` is a client's end: a connection to
   ``tcp://host:port``, made on first use, with the zmq socket methods the
   reference calls (``send_multipart``, ``recv_multipart``, ``poll``,
   ``close``).
 - :class:`FrameServer` is a server's end, as a zmq ROUTER has it: it
   accepts any number of clients, ``poll`` returns the next whole message
   with the connection it came from, and ``send`` answers on that
   connection.

Every blocking read waits at most its socket's timeout.
"""

from __future__ import annotations

import collections
import select
import socket
import struct
import time
from typing import Any, Deque, List, Optional, Sequence, Tuple

from areal_tpu_torch.base import network

_COUNT = struct.Struct("<I")  # frames in a message
_LEN = struct.Struct("<Q")  # bytes in a frame


def _encode(frames: Sequence[Any]) -> List[memoryview]:
    """One multipart message as buffers to send in order (payloads are not
    copied)."""
    out = [memoryview(_COUNT.pack(len(frames)))]
    for f in frames:
        m = memoryview(f).cast("B")
        out += [memoryview(_LEN.pack(m.nbytes)), m]
    return out


def _send(sock: socket.socket, frames: Sequence[Any]) -> None:
    """Send one message: the small buffers joined, payloads as they are."""
    head = bytearray()
    for m in _encode(frames):
        if m.nbytes < (1 << 16):
            head += m
            continue
        if head:
            sock.sendall(head)
            head = bytearray()
        sock.sendall(m)
    if head:
        sock.sendall(head)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = sock.recv_into(view[got:])
        if k == 0:
            raise ConnectionError("the peer closed the connection")
        got += k
    return buf


def _recv(sock: socket.socket) -> List[bytearray]:
    """One whole message (each read waits at most the socket's timeout)."""
    (n,) = _COUNT.unpack(_recv_exact(sock, _COUNT.size))
    return [_recv_exact(sock, _LEN.unpack(_recv_exact(sock, _LEN.size))[0])
            for _ in range(n)]


class FrameSocket:
    """A client's end of the frame transport: a TCP connection to
    ``endpoint``, made on first use, with the zmq socket methods the
    reference calls. Each blocking read waits at most ``timeout_secs``."""

    def __init__(self, endpoint: str, timeout_secs: float):
        self.endpoint = endpoint
        self.timeout_secs = timeout_secs
        self._sock: Optional[socket.socket] = None
        self._poller = select.poll()
        self._ready: Deque[List[bytearray]] = collections.deque()

    def _conn(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(network.parse_tcp(self.endpoint),
                                         timeout=self.timeout_secs)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._poller.register(s, select.POLLIN)
            self._sock = s
        return self._sock

    def send_multipart(self, frames: Sequence[Any]) -> None:
        _send(self._conn(), frames)

    def poll(self, timeout_ms: int) -> int:
        """1 once a whole message has arrived, 0 if none started arriving
        within ``timeout_ms``."""
        if self._ready:
            return 1
        self._conn()
        if not self._poller.poll(max(int(timeout_ms), 0)):
            return 0
        try:
            self._ready.append(_recv(self._sock))
        except ConnectionError as e:
            raise ConnectionError(f"{self.endpoint}: {e}") from None
        return 1

    def recv_multipart(self) -> List[bytearray]:
        if not self.poll(int(self.timeout_secs * 1000)):
            raise TimeoutError(f"no message from {self.endpoint} within "
                               f"{self.timeout_secs}s")
        return self._ready.popleft()

    def close(self, linger: int = 0) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None


class FrameServer:
    """A server's end of the frame transport, bound to a free port: it
    accepts clients as they come, ``poll`` returns the next whole message
    with its connection, ``send`` answers on a connection. One thread
    serves it. A client that leaves is dropped; a reply to it is lost, as a
    zmq ROUTER drops a message to a peer that is gone."""

    def __init__(self, timeout_secs: float = 60.0):
        self.timeout_secs = timeout_secs
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind((network.bind_addr(), 0))
        self._listen.listen(64)
        self.port = self._listen.getsockname()[1]
        self.endpoint = network.advertised_tcp(self.port)
        self._conns: List[socket.socket] = []

    def poll(self, timeout_ms: int = 0
             ) -> Optional[Tuple[socket.socket, List[bytearray]]]:
        """(connection, frames) of the next message, or None if none came
        within ``timeout_ms``."""
        deadline = time.monotonic() + max(int(timeout_ms), 0) / 1000
        while True:
            readable, _, _ = select.select(
                [self._listen] + self._conns, [], [],
                max(deadline - time.monotonic(), 0))
            if not readable:
                return None
            for s in readable:
                if s is self._listen:
                    conn, _ = self._listen.accept()
                    conn.settimeout(self.timeout_secs)
                    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    self._conns.append(conn)
                    continue
                try:
                    return s, _recv(s)
                except OSError:  # the client left (or broke a message off)
                    self._drop(s)

    def send(self, conn: socket.socket, frames: Sequence[Any]) -> None:
        if conn not in self._conns:
            return  # the client left
        try:
            _send(conn, frames)
        except OSError:
            self._drop(conn)

    def _drop(self, conn: socket.socket) -> None:
        if conn in self._conns:
            self._conns.remove(conn)
        conn.close()

    def close(self) -> None:
        for conn in list(self._conns):
            self._drop(conn)
        self._listen.close()
