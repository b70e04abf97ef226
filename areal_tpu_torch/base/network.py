"""Free-port discovery and host identification.

The port's copy of ``areal_tpu/base/network.py`` (``gethostip:20``,
``bind_addr:31``, ``advertised_tcp:37``, ``find_free_port:45``), over
``socket``.
"""

from __future__ import annotations

import socket
from contextlib import closing
from typing import Tuple


def gethostip() -> str:
    """The address of the interface that routes off this host, or
    127.0.0.1 without a route. ``connect`` on a UDP socket sends nothing: it
    only picks the route's interface."""
    try:
        with closing(socket.socket(socket.AF_INET, socket.SOCK_DGRAM)) as s:
            s.connect(("10.254.254.254", 1))
            return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"


def bind_addr() -> str:
    """Interface to bind servers on (all interfaces; peers connect via
    gethostip())."""
    return "0.0.0.0"


def advertised_tcp(port: int) -> str:
    """``tcp://<routable-ip>:<port>`` — the address peers should CONNECT to
    for a socket bound on :func:`bind_addr`."""
    return f"tcp://{gethostip()}:{port}"


def parse_tcp(endpoint: str) -> Tuple[str, int]:
    """``tcp://host:port`` → ``(host, port)``."""
    if not endpoint.startswith("tcp://"):
        raise ValueError(f"not a tcp://host:port endpoint: {endpoint!r}")
    host, _, port = endpoint[len("tcp://"):].rpartition(":")
    return host, int(port)


def find_free_port() -> int:
    """A TCP port that is free now (the reference's per-port lockfiles
    against concurrent callers come with the slice that launches workers)."""
    with closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("", 0))
        return s.getsockname()[1]
