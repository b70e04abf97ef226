"""Streamed weight sync: trainer → generation servers over TCP, no disk.

The port's copy of ``areal_tpu/system/weight_stream.py``.

 - :class:`WeightStreamPublisher` (trainer): holds a host cache of the
   published tensors and serves them to any number of consumers — one d2h
   gather, replayed per server. ``publish()`` returns the manifest at once;
   a background *gather* thread copies the tensors to the host one at a
   time, so the d2h of tensor *i+1* overlaps the wire transfer of tensor
   *i*. The last ``keep_versions`` publishes stay replayable.
 - :class:`WeightStreamConsumer` (generation server): fetches the manifest,
   streams chunks with a bounded window of in-flight requests, reassembles
   tensors and verifies the whole transfer against the publisher's digest
   before the caller swaps anything live.

Wire protocol (the reference's frames, byte for byte):

 - ``[b"manifest", {"version": v}]`` → ``[b"ok", manifest-json]``: tensor
   names, shapes, dtypes (numpy's names: ``"bfloat16"``, ``"float32"``),
   bytes and chunk counts, the chunk size and the version.
 - ``[b"chunk", {"version", "tensor", "chunk"}]`` →
   ``[b"ok", {"version", "tensor", "chunk", "crc32"}, payload]``.
 - ``[b"digest", {"version": v}]`` → ``[b"ok", {"version", "crcs"}]``: the
   per-chunk CRC32s of the complete publish, served once the gather is done.
 - ``[b"err", message]`` for any error.

Every reply echoes its coordinates; a consumer that receives an echo out of
its request order aborts. Payloads are a tensor's raw little-endian bytes
(``view(torch.uint8)``: numpy has no bfloat16); CRCs are ``zlib.crc32``.

Transport: the reference carries these frames over a zmq DEALER/ROUTER
pair. Here they travel over a plain TCP socket as the port's multipart
messages (``system/frames.py``). The publisher serves each connection from a thread of its
own, answering its requests in order; a request that needs data the gather
has not produced yet waits for it (up to a deadline) without holding up
other consumers. The consumer's socket (:class:`FrameSocket`) has the four
methods the reference calls on its zmq socket — ``send_multipart``,
``recv_multipart``, ``poll``, ``close`` — and the publisher answers a
request through ``_handle(frames) -> frames``, so either side can be
bridged to the reference's. Endpoints are ``tcp://host:port``; every wait
is bounded.

Ownership: ``publish`` keeps references to the tensors it is given and
gathers them later, so the caller hands over tensors it will not modify
(the trainer passes fresh compute-dtype copies, never its masters). Device
tensors are synchronized before ``publish`` returns.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from areal_tpu_torch.base import name_resolve, names, network, telemetry
from areal_tpu_torch.system.frames import FrameSocket, _recv, _send

logger = logging.getLogger("areal_tpu_torch.weight_stream")

DEFAULT_CHUNK_BYTES = 32 << 20  # 32 MB wire chunks
DEFAULT_PIPELINE_DEPTH = 4  # in-flight chunk requests per consumer
# The longest a publisher's connection waits: for the gather to produce
# what a request needs, for the consumer's next request, or for it to
# take a reply.
CONN_WAIT_SECS = 300.0


class WeightStreamError(RuntimeError):
    """Torn / reordered / corrupted / timed-out weight stream."""


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``torch.bfloat16`` → ``"bfloat16"``),
    as the manifest carries it."""
    return str(dtype).removeprefix("torch.")


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise WeightStreamError(f"unknown dtype {name!r} in the manifest")
    return dt


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """Flat uint8 host view of ``t``'s bytes: the d2h copy for a device
    tensor, no copy for a contiguous CPU one."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.to("cpu")
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


# ---------------- publisher ----------------

class _PublishedVersion:
    """Host cache of one published weight version."""

    def __init__(self, version: int, tensors: Sequence[Tuple[str, torch.Tensor]],
                 chunk_bytes: int):
        self.version = version
        self.chunk_bytes = chunk_bytes
        self.names = [n for n, _ in tensors]
        self.leaves: List[Optional[torch.Tensor]] = [v for _, v in tensors]
        self.arrays: List[Optional[np.ndarray]] = [None] * len(tensors)
        self.crcs: List[List[int]] = [[] for _ in tensors]
        # Shapes and dtypes are known without any d2h: manifests are
        # servable the moment publish() is called.
        self.shapes = [tuple(int(d) for d in v.shape) for _, v in tensors]
        self.dtypes = [_dtype_name(v.dtype) for _, v in tensors]
        self.nbytes = [v.numel() * v.element_size() for _, v in tensors]
        self.n_chunks = [max(1, -(-nb // chunk_bytes)) for nb in self.nbytes]
        self.ready = [threading.Event() for _ in tensors]
        self.complete = threading.Event()
        self.gather_secs = 0.0

    def manifest(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "chunk_bytes": self.chunk_bytes,
            "total_bytes": int(sum(self.nbytes)),
            "tensors": [
                {"name": n, "shape": list(s), "dtype": d, "nbytes": nb,
                 "n_chunks": nc}
                for n, s, d, nb, nc in zip(
                    self.names, self.shapes, self.dtypes, self.nbytes,
                    self.n_chunks,
                )
            ],
        }

    def chunk_view(self, t: int, c: int) -> memoryview:
        cb = self.chunk_bytes
        return memoryview(self.arrays[t])[c * cb:(c + 1) * cb]


class WeightStreamPublisher:
    """The trainer's host cache + replay server for streamed publishes.

    One instance lives for the whole run; each ``publish()`` registers a
    new version. The endpoint is registered under
    ``names.weight_stream(experiment, trial, role)``."""

    def __init__(self, experiment: str, trial: str, role: str = "actor",
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 keep_versions: int = 2):
        self.chunk_bytes = int(chunk_bytes)
        self.keep_versions = keep_versions
        self._cache: Dict[int, _PublishedVersion] = {}
        self._lock = threading.Lock()
        self._closing = False
        self._conns: set = set()  # open connections, shut down by close()
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind((network.bind_addr(), 0))
        self._listen.listen(64)
        self._listen.settimeout(0.1)  # so that the accept loop sees close()
        self.endpoint = network.advertised_tcp(self._listen.getsockname()[1])
        self._key = names.weight_stream(experiment, trial, role)
        name_resolve.add(self._key, self.endpoint, replace=True)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="weight-stream-accept")
        self._accept_thread.start()
        logger.info(f"weight stream publisher for {role} at {self.endpoint}")

    # ---------------- publishing ----------------

    def publish(self, tensors: Sequence[Tuple[str, torch.Tensor]],
                version: int) -> Dict[str, Any]:
        """Register ``version`` and start gathering its tensors to the host
        in the background. ``tensors`` is an ordered [(name, tensor)] list
        that the publisher now owns. Returns the manifest."""
        for dev in {t.device for _, t in tensors if t.device.type == "cuda"}:
            # The gather thread copies these after whatever produced them.
            torch.cuda.synchronize(dev)
        pub = _PublishedVersion(version, tensors, self.chunk_bytes)
        with self._lock:
            self._cache[version] = pub
            for v in sorted(self._cache):
                if len(self._cache) <= self.keep_versions:
                    break
                if v != version:
                    del self._cache[v]
        threading.Thread(target=self._gather_loop, args=(pub,), daemon=True,
                         name=f"weight-stream-gather-v{version}").start()
        return pub.manifest()

    def _gather_loop(self, pub: _PublishedVersion) -> None:
        from areal_tpu_torch.system import memwatch

        t0 = time.monotonic()
        try:
            # The d2h gather holds the compute-dtype copy on the device
            # until each tensor's reference drops: the trainer's memory
            # high-water mark of a streamed publish.
            with memwatch.watermark("weight_stream/gather"):
                self._gather_leaves(pub)
            pub.gather_secs = time.monotonic() - t0
            pub.complete.set()
            total = float(sum(pub.nbytes))
            telemetry.set_gauge("weight_stream/gather_secs", pub.gather_secs)
            telemetry.set_gauge(
                "weight_stream/gather_mb_per_sec",
                total / max(pub.gather_secs, 1e-9) / (1 << 20))
            telemetry.inc("weight_stream/published_bytes", total)
        except Exception as e:  # noqa: BLE001 — surfaced via chunk errors
            logger.error(f"weight gather v{pub.version} failed: {e}")
            with self._lock:
                self._cache.pop(pub.version, None)
            for ev in pub.ready:  # waiting requests error out, not hang
                ev.set()
            pub.complete.set()

    def _gather_leaves(self, pub: _PublishedVersion) -> None:
        cb = pub.chunk_bytes
        for i, leaf in enumerate(pub.leaves):
            a = _host_bytes(leaf)
            if a.nbytes != pub.nbytes[i]:
                raise WeightStreamError(
                    f"tensor {pub.names[i]} gathered {a.nbytes} bytes, "
                    f"manifest promised {pub.nbytes[i]}")
            pub.arrays[i] = a
            pub.leaves[i] = None  # drop the device reference
            pub.crcs[i] = [zlib.crc32(memoryview(a)[c * cb:(c + 1) * cb])
                           for c in range(pub.n_chunks[i])]
            pub.ready[i].set()

    def wait_complete(self, version: int, timeout: float = 300.0) -> bool:
        with self._lock:
            pub = self._cache.get(version)
        return pub is not None and pub.complete.wait(timeout)

    # ---------------- serving ----------------

    def _lookup(self, version: int) -> _PublishedVersion:
        with self._lock:
            pub = self._cache.get(version)
            if pub is None:
                raise WeightStreamError(
                    f"version {version} not cached (have {sorted(self._cache)})")
        return pub

    def _wait(self, ready: threading.Event, version: int) -> None:
        """Wait until the gather has produced what a request needs; the
        version must still be cached then (a failed gather or ``close``
        evicts it and wakes every waiter)."""
        if not ready.wait(CONN_WAIT_SECS):
            raise WeightStreamError("timed out waiting for the gather thread")
        self._lookup(version)

    def _handle(self, frames: List[bytes]) -> List[Any]:
        """One request → reply frames. A chunk or digest request waits for
        the gather thread to produce its data."""
        cmd = bytes(frames[0])
        meta = json.loads(frames[1]) if len(frames) > 1 else {}
        version = int(meta.get("version", -1))
        pub = self._lookup(version)
        if cmd == b"manifest":
            return [b"ok", json.dumps(pub.manifest()).encode()]
        if cmd == b"digest":
            self._wait(pub.complete, version)
            return [b"ok", json.dumps(
                {"version": version, "crcs": pub.crcs}).encode()]
        if cmd == b"chunk":
            t, c = int(meta["tensor"]), int(meta["chunk"])
            if not (0 <= t < len(pub.names)) or not (0 <= c < pub.n_chunks[t]):
                raise WeightStreamError(f"chunk ({t},{c}) out of range")
            self._wait(pub.ready[t], version)
            telemetry.inc("weight_stream/chunks_served")
            return [
                b"ok",
                json.dumps({"version": version, "tensor": t, "chunk": c,
                            "crc32": pub.crcs[t][c]}).encode(),
                pub.chunk_view(t, c),
            ]
        raise WeightStreamError(f"unknown command {cmd!r}")

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                sock, _ = self._listen.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # closed
            threading.Thread(target=self._serve_conn, args=(sock,),
                             daemon=True, name="weight-stream-conn").start()

    def _serve_conn(self, sock: socket.socket) -> None:
        """Answer one consumer's requests in order until it leaves, stays
        silent past ``CONN_WAIT_SECS``, or the publisher closes."""
        sock.settimeout(CONN_WAIT_SECS)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._lock:
            if self._closing:
                sock.close()
                return
            self._conns.add(sock)
        try:
            while True:
                frames = _recv(sock)
                try:
                    reply = self._handle(frames)
                except Exception as e:  # noqa: BLE001 — answer it, keep serving
                    if not isinstance(e, WeightStreamError):
                        logger.error(f"weight stream request failed: {e!r}")
                    reply = [b"err", str(e).encode()]
                _send(sock, reply)
        except OSError:
            pass  # the consumer went away (mid-stream or done), or close()
        finally:
            with self._lock:
                self._conns.discard(sock)
            sock.close()

    def close(self) -> None:
        with self._lock:
            self._closing = True
            pubs, conns = list(self._cache.values()), list(self._conns)
            self._cache.clear()
        try:
            name_resolve.delete(self._key)
        except name_resolve.NameEntryNotFoundError:
            pass
        for pub in pubs:  # requests waiting on a gather error out
            for ev in pub.ready:
                ev.set()
            pub.complete.set()
        for sock in conns:  # wakes the connection threads' reads
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._accept_thread.join(timeout=2)
        self._listen.close()


# ---------------- consumer ----------------

class WeightStreamConsumer:
    """One server's view of a publisher: fetch the manifest, stream tensors
    with a bounded request window, verify the digest."""

    def __init__(self, endpoint: str,
                 pipeline_depth: int = DEFAULT_PIPELINE_DEPTH,
                 timeout_secs: float = 600.0):
        # timeout_secs bounds every wait for a reply; it must cover the
        # publisher's d2h gather of the largest tensor, since a chunk
        # request waits there until its tensor is gathered.
        self.endpoint = endpoint
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.timeout_secs = timeout_secs
        self._sock = FrameSocket(endpoint, timeout_secs)
        # Where the wall-clock went.
        self.bytes_received = 0
        self.checksum_secs = 0.0
        self.wire_wait_secs = 0.0

    def _request(self, cmd: bytes, meta: Dict[str, Any]) -> None:
        try:
            self._sock.send_multipart([cmd, json.dumps(meta).encode()])
        except OSError as e:
            raise WeightStreamError(f"cannot reach {self.endpoint}: {e}") from e

    def _recv(self) -> List[Any]:
        t0 = time.monotonic()
        try:
            if not self._sock.poll(int(self.timeout_secs * 1000)):
                raise WeightStreamError(
                    f"no reply from {self.endpoint} within {self.timeout_secs}s")
            frames = self._sock.recv_multipart()
        except OSError as e:
            raise WeightStreamError(f"lost {self.endpoint}: {e}") from e
        self.wire_wait_secs += time.monotonic() - t0
        if frames[0] == b"err":
            raise WeightStreamError(
                f"publisher error: {bytes(frames[1]).decode(errors='replace')}")
        if frames[0] != b"ok":
            raise WeightStreamError(f"bad reply frame {bytes(frames[0])!r}")
        return frames[1:]

    def fetch_manifest(self, version: int) -> Dict[str, Any]:
        self._request(b"manifest", {"version": version})
        manifest = json.loads(self._recv()[0])
        if int(manifest["version"]) != version:
            raise WeightStreamError(
                f"manifest version {manifest['version']} != requested {version}")
        return manifest

    def iter_tensors(self, version: int, manifest: Dict[str, Any]
                     ) -> Iterator[Tuple[str, torch.Tensor]]:
        """Yield (name, CPU tensor) in manifest order, keeping up to
        ``pipeline_depth`` chunk requests in flight, so the wire leg
        overlaps whatever the caller does with each tensor. Records the
        per-chunk CRC32s for :meth:`verify_digest`."""
        specs = manifest["tensors"]
        coords = [(t, c) for t, spec in enumerate(specs)
                  for c in range(spec["n_chunks"])]
        self._local_crcs: List[List[int]] = [[0] * s["n_chunks"] for s in specs]
        sent = 0
        for t, c in coords[:self.pipeline_depth]:
            self._request(b"chunk", {"version": version, "tensor": t,
                                     "chunk": c})
            sent += 1
        buf, filled = bytearray(), 0
        for t, c in coords:
            meta_raw, payload = self._recv()
            if sent < len(coords):
                nt, nc = coords[sent]
                self._request(b"chunk", {"version": version, "tensor": nt,
                                         "chunk": nc})
                sent += 1
            meta = json.loads(meta_raw)
            if (int(meta["version"]), int(meta["tensor"]),
                    int(meta["chunk"])) != (version, t, c):
                raise WeightStreamError(
                    f"out-of-order chunk: expected v{version} ({t},{c}), "
                    f"got v{meta['version']} ({meta['tensor']},{meta['chunk']})")
            t0 = time.monotonic()
            crc = zlib.crc32(payload)
            if crc != int(meta["crc32"]):
                raise WeightStreamError(
                    f"chunk ({t},{c}) checksum mismatch: wire {crc} != "
                    f"published {meta['crc32']}")
            self._local_crcs[t][c] = crc
            spec = specs[t]
            if c == 0:
                buf, filled = bytearray(spec["nbytes"]), 0
            n = len(payload)
            if filled + n > len(buf):
                raise WeightStreamError(
                    f"tensor {spec['name']}: more bytes than the manifest's "
                    f"{spec['nbytes']}")
            buf[filled:filled + n] = payload
            filled += n
            self.bytes_received += n
            self.checksum_secs += time.monotonic() - t0
            if c == spec["n_chunks"] - 1:
                if filled != spec["nbytes"]:
                    raise WeightStreamError(
                        f"tensor {spec['name']}: received {filled} bytes, "
                        f"manifest promised {spec['nbytes']}")
                dtype = _torch_dtype(spec["dtype"])
                arr = (torch.frombuffer(buf, dtype=dtype) if filled else
                       torch.empty(0, dtype=dtype)).reshape(spec["shape"])
                yield spec["name"], arr

    def verify_digest(self, version: int) -> None:
        """Compare the locally computed per-chunk CRCs with the publisher's
        complete digest. Raises if ANY chunk differs — the caller must not
        swap weights before this passes."""
        self._request(b"digest", {"version": version})
        digest = json.loads(self._recv()[0])
        if digest["crcs"] != self._local_crcs:
            raise WeightStreamError(
                f"digest mismatch for v{version}: stream was torn or "
                "reordered; aborting swap")

    def fetch(self, version: int) -> Tuple[Dict[str, Any],
                                           Dict[str, torch.Tensor]]:
        """A whole verified transfer → (manifest, {name: tensor})."""
        manifest = self.fetch_manifest(version)
        out = dict(self.iter_tensors(version, manifest))
        self.verify_digest(version)
        return manifest, out

    def close(self) -> None:
        self._sock.close(linger=0)
