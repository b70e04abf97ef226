"""JSON over HTTP with the standard library, for the async loop's hops.

The reference's manager, rollout client and rollout worker speak HTTP
through ``aiohttp``; the card's machine is not known to have it. The port
posts with ``urllib`` (never through a proxy: every peer is a fleet
member). :func:`request_json` is the blocking call the manager's threads
make; :class:`AsyncHttp` runs it on a thread pool of its own so that an
asyncio caller (the rollout worker and its chunked client) never blocks
its loop, with as many calls in flight as the pool has threads.
:class:`FleetHTTPServer` is the servers' side.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

# No proxy for any request: the fleet's URLs are its own hosts.
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _decode(raw: bytes) -> Any:
    try:
        return json.loads(raw or b"{}")
    except ValueError:
        return {}


def request_json(url: str, body: Optional[Any] = None,
                 timeout: float = 30.0,
                 headers: Optional[Dict[str, str]] = None) -> Tuple[int, Any]:
    """POST ``body`` as JSON (GET when it is None), with extra ``headers``
    (a trace context); returns (status, the reply's JSON). A reply with an
    error status returns too; a connection failure or a timeout raises
    ``OSError``."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, method="GET" if body is None else "POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with _OPENER.open(req, timeout=timeout) as r:
            return r.status, _decode(r.read())
    except urllib.error.HTTPError as e:
        return e.code, _decode(e.read())


class AsyncHttp:
    """:func:`request_json` for asyncio callers, on ``max_workers`` threads
    of its own (a chunked generation holds one for its whole chunk)."""

    def __init__(self, max_workers: int = 256):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers, thread_name_prefix="areal-http")
        self.closed = False

    async def post(self, url: str, body: Any, timeout: float = 300.0,
                   headers: Optional[Dict[str, str]] = None
                   ) -> Tuple[int, Any]:
        """``headers`` are computed by the caller: the pool's threads do
        not see the caller's context (its trace)."""
        return await asyncio.get_running_loop().run_in_executor(
            self._pool, request_json, url, body, timeout, headers)

    def close(self) -> None:
        self.closed = True
        self._pool.shutdown(wait=False, cancel_futures=True)


class FleetHTTPServer(ThreadingHTTPServer):
    """A thread per connection, and a listen backlog that holds a fleet's
    burst of connections (the standard library's default of 5 resets them:
    64 rollouts polling a closed gate, or 64 chunks at once)."""

    daemon_threads = True
    request_queue_size = 1024
