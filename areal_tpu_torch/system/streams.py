"""The master ↔ trainer request/reply stream.

The port's counterpart of ``areal_tpu/system/streams.py:42-196``
(reference ``realhf/system/request_reply_stream.py``): ``Payload``, the
master's :class:`MasterRequestStream` and the worker's
:class:`WorkerRequestServer`, with the reference's semantics, over the
port's frames (``system/frames.py``) instead of a zmq DEALER/ROUTER pair:

 - one connection per handler, its address advertised in name_resolve
   under :func:`req_reply_addr_key` and withdrawn on ``close()``;
 - the server remembers which connection each ``request_id`` came from and
   answers there (a ROUTER's per-peer routing);
 - a reply completes because the worker set ``done``, whatever its output
   (a ``None`` output included);
 - ``gather`` re-raises a worker's exception as ``RuntimeError`` and times
   out; a worker that closes its end makes it raise ``ConnectionError``.

Payloads are pickled (trusted intra-cluster traffic, the reference's trust
model).

The rollout → trainer trajectory stream (``areal_tpu/system/streams.py:231
ZmqPuller``, ``:265 ZmqPusher``) rides the same frames: the trainer's
:class:`TrajectoryPuller` binds a free port and advertises it under
:func:`push_pull_addr_key` (leased by keepalive, withdrawn on close); a
rollout worker's :class:`TrajectoryPusher` resolves it and sends each
trajectory's ``as_json_compatible()`` dict as one pickled frame, where the
reference sends msgpack over a zmq PUSH socket. A push never wedges its
caller: a send that cannot finish within ``block_secs`` drops the
connection and raises ``TimeoutError``. With telemetry on, a pushed dict
carries the active trace under ``_trace`` (``telemetry.inject_payload``),
and a push that finds the socket's send buffer full counts
``stream/push_blocked``. With the durable spool (``system/sample_spool.py``)
a pushed dict also carries ``_spool`` (the worker and the record's seqno),
and the trainer acks settled seqnos back to each rollout worker's own
puller (``sample_spool.ack_channel_name``) over the same frames.
"""

from __future__ import annotations

import dataclasses
import pickle
import select
import socket
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence

from areal_tpu_torch.base import logging, name_resolve, network, telemetry
from areal_tpu_torch.system.frames import (
    FrameServer,
    _encode,
    _recv,
    _send,
)

logger = logging.getLogger("system.streams")

# The longest a started message may take to arrive in full.
IO_TIMEOUT_SECS = 60.0


def req_reply_addr_key(experiment: str, trial: str, handler: str) -> str:
    return f"areal_tpu/{experiment}/{trial}/req_reply/{handler}"


def push_pull_addr_key(experiment: str, trial: str, puller: str) -> str:
    return f"areal_tpu/{experiment}/{trial}/push_pull/{puller}"


@dataclasses.dataclass
class Payload:
    handler: str  # target worker name
    handle_name: str  # e.g. "fetch" / "mfc" / "clear" / "model_info"
    request_id: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex)
    data: Any = None  # SequenceSample metadata / small control values
    mb_spec: Any = None
    # hooks the worker runs around the MFC (weight update, param realloc,
    # save; reference request_reply_stream:47)
    pre_hooks: List[Dict] = dataclasses.field(default_factory=list)
    post_hooks: List[Dict] = dataclasses.field(default_factory=list)
    output: Any = None
    exception: Optional[str] = None
    # Set by WorkerRequestServer.reply: a reply is done because the worker
    # said so, not because its output happens to be non-None.
    done: bool = False


class MasterRequestStream:
    """The master's end: one connection per handler.

    Thread safety: the master runs ``post`` / ``gather`` / ``call`` from
    several ``asyncio.to_thread`` workers at once, and two threads must
    never read one socket. Every send and every read happens under
    ``_io_lock``, held only across one bounded wait and the reads of the
    messages that arrived, never across a whole gather; a thread files each
    reply it reads in ``_pending``, where its owner finds it (the wedge of
    ``areal_tpu/system/streams.py:64-74``)."""

    def __init__(self, experiment: str, trial: str, handlers: Sequence[str],
                 timeout: float = 300.0):
        self._socks: Dict[str, socket.socket] = {}
        self._pending: Dict[str, Payload] = {}
        self._io_lock = threading.Lock()
        for h in handlers:
            addr = name_resolve.wait(req_reply_addr_key(experiment, trial, h),
                                     timeout=timeout)
            s = socket.create_connection(network.parse_tcp(addr),
                                         timeout=timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.settimeout(IO_TIMEOUT_SECS)
            self._socks[h] = s
        self._handler_of = {s: h for h, s in self._socks.items()}

    def post(self, p: Payload) -> str:
        raw = pickle.dumps(p)
        with self._io_lock:
            _send(self._socks[p.handler], [raw])
            self._pending[p.request_id] = p
        return p.request_id

    def _drain(self, timeout_ms: int) -> None:
        with self._io_lock:
            readable, _, _ = select.select(list(self._socks.values()), [], [],
                                           timeout_ms / 1000)
            for sock in readable:
                try:
                    frames = _recv(sock)
                except OSError as e:
                    raise ConnectionError(
                        f"lost the connection to worker "
                        f"{self._handler_of[sock]}: {e}") from None
                reply: Payload = pickle.loads(frames[0])
                self._pending[reply.request_id] = reply

    def gather(self, request_ids: Sequence[str],
               timeout: float = 3600.0) -> List[Payload]:
        """Blocking gather; raises on a worker-side exception."""
        deadline = time.monotonic() + timeout
        out: Dict[str, Payload] = {}
        while len(out) < len(request_ids):
            for rid in request_ids:
                p = self._pending.get(rid)
                # The request parked here by post() has done=False.
                if p is not None and p.done:
                    out[rid] = self._pending.pop(rid)
            if len(out) >= len(request_ids):
                break
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"gather timed out; got {len(out)}")
            self._drain(int(min(left, 0.2) * 1000))
        for p in out.values():
            if p.exception:
                raise RuntimeError(
                    f"worker {p.handler} failed on {p.handle_name}: "
                    f"{p.exception}")
        return [out[rid] for rid in request_ids]

    def call(self, handler: str, handle_name: str, data: Any = None,
             **kw) -> Any:
        rid = self.post(Payload(handler=handler, handle_name=handle_name,
                                data=data, **kw))
        return self.gather([rid])[0].output

    def close(self):
        for s in self._socks.values():
            s.close()


class WorkerRequestServer:
    """The worker's end, bound to a free port and advertised in
    name_resolve. Under a supervisor the advertisement carries a liveness
    lease (AREAL_WORKER_KEEPALIVE_TTL) that the worker's control heartbeat
    keeps alive (``WorkerControl.lease(server._key)``)."""

    def __init__(self, experiment: str, trial: str, handler: str):
        from areal_tpu_torch.system.worker_base import env_keepalive_ttl

        self.handler = handler
        self._server = FrameServer(IO_TIMEOUT_SECS)
        self._key = req_reply_addr_key(experiment, trial, handler)
        self._addr = self._server.endpoint
        name_resolve.add(self._key, self._addr,
                         replace=True, keepalive_ttl=env_keepalive_ttl())
        self._peer_of: Dict[str, socket.socket] = {}

    def poll(self, timeout_ms: int = 0) -> Optional[Payload]:
        got = self._server.poll(timeout_ms)
        if got is None:
            return None
        conn, frames = got
        p: Payload = pickle.loads(frames[0])
        self._peer_of[p.request_id] = conn
        return p

    def reply(self, p: Payload) -> None:
        conn = self._peer_of.pop(p.request_id)
        p.done = True
        self._server.send(conn, [pickle.dumps(p)])

    def close(self):
        # Withdraw the advertisement first: a restarted experiment's master
        # must not resolve this (about-to-die) address.
        try:
            name_resolve.delete(self._key)
        except name_resolve.NameEntryNotFoundError:
            pass
        self._server.close()


# ---------------- push/pull (rollout → trainer) ----------------


def pack(obj: Any) -> bytes:
    """One pushed object's bytes on the trajectory stream (the reference's
    ``streams._pack``, msgpack there)."""
    return pickle.dumps(obj)


def unpack(raw: bytes) -> Any:
    return pickle.loads(raw)



class TrajectoryPuller:
    """The trainer's end of the trajectory stream: a frame server on a free
    port, advertised under :func:`push_pull_addr_key` with the worker's
    keepalive lease (AREAL_WORKER_KEEPALIVE_TTL; the trainer's control
    heartbeat keeps it alive)."""

    def __init__(self, experiment: str, trial: str, name: str):
        from areal_tpu_torch.system.worker_base import env_keepalive_ttl

        self._server = FrameServer(IO_TIMEOUT_SECS)
        self._key = push_pull_addr_key(experiment, trial, name)
        self._addr = self._server.endpoint
        name_resolve.add(self._key, self._addr, replace=True,
                         keepalive_ttl=env_keepalive_ttl())

    def pull(self, timeout_ms: int = 0) -> Optional[Any]:
        """The next pushed object, or None if none came within
        ``timeout_ms``."""
        got = self._server.poll(timeout_ms)
        if got is None:
            return None
        return unpack(got[1][0])

    def close(self) -> None:
        # Withdraw the advertisement first: a successor run must not
        # resolve this (about-to-die) address and push into the void.
        try:
            name_resolve.delete(self._key)
        except name_resolve.NameEntryNotFoundError:
            pass
        self._server.close()


class TrajectoryPusher:
    """A rollout worker's end: resolves the puller through name_resolve
    (reference ``NameResolvingZmqPusher``) and connects on first push.

    Sends never wedge the caller: each push gets ``block_secs`` to go out
    whole; past that the connection is dropped (the next push reconnects)
    and ``TimeoutError`` is raised, loud instead of silent. A puller that is
    gone (closed connection, withdrawn address) raises ``ConnectionError``;
    the next push resolves the address again."""

    def __init__(self, experiment: str, trial: str, puller: str,
                 timeout: float = 300.0, block_secs: float = 120.0):
        self._key = push_pull_addr_key(experiment, trial, puller)
        self.endpoint = name_resolve.wait(self._key, timeout=timeout)
        self.block_secs = block_secs
        self._sock: Optional[socket.socket] = None

    def push(self, obj: Any) -> None:
        # The trainer re-attaches the trace to the sample's metadata; with
        # telemetry off (or no trace) the object is untouched.
        self.push_packed(pack(telemetry.inject_payload(obj)))

    def push_packed(self, raw: bytes) -> None:
        """Send an object already packed with :func:`pack` (the durable
        spool sends its records as they are stored)."""
        budget = self.block_secs
        deadline = time.monotonic() + budget
        data = b"".join(bytes(m) for m in _encode([raw]))
        try:
            if self._sock is None:
                # a restarted puller registers a new address
                try:
                    self.endpoint = name_resolve.get(self._key)
                except name_resolve.NameEntryNotFoundError:
                    raise ConnectionError("the puller withdrew its address")
                s = socket.create_connection(network.parse_tcp(self.endpoint),
                                             timeout=budget)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._sock = s
            if telemetry.enabled():
                writable = select.poll()
                writable.register(self._sock, select.POLLOUT)
                if not writable.poll(0):
                    telemetry.inc("stream/push_blocked")  # buffer is full
            # sendall's timeout bounds the whole call
            self._sock.settimeout(max(deadline - time.monotonic(), 1e-3))
            self._sock.sendall(data)
        except socket.timeout:
            self.close()
            raise TimeoutError(
                f"push to {self.endpoint} blocked for {budget:.1f}s (the "
                "trainer is not pulling); the trajectory was not sent"
            ) from None
        except OSError as e:
            self.close()
            raise ConnectionError(
                f"push to {self.endpoint} failed: {e}") from None

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None
