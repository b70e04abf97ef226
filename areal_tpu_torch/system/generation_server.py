"""Generation server: batched prefill + chunked KV-cache decode over HTTP.

Counterpart of ``areal_tpu/system/generation_server.py`` (``_decode_batch``,
``_runner``, ``handle_generate``) with the default configuration
(``serving.enabled=false``). Every ``POST /generate`` decodes at most
``chunk_tokens`` new tokens and returns them tagged with the weight version;
the client re-submits prompt + accumulated tokens with the same ``rid`` and
the server continues from the retained KV state instead of re-prefilling.

The HTTP side is the standard library (``ThreadingHTTPServer``): handler
threads enqueue requests on a FIFO and wait; one runner thread forms batches
(``batch_window_ms``, up to ``max_batch_size``) and runs the decode under
``torch.inference_mode()``. JSON in: ``prompt_ids``, ``gconfig``,
``max_tokens``, ``rid``, ``tokens_done``; out: ``output_ids``,
``output_logprobs``, ``finished``, ``version``. ``GET /health`` reports
liveness and the weight version.

``POST /update_weights`` swaps the served weights (reference
``handle_update_weights:877``): ``{"path", "version"}`` loads a native
checkpoint (``disk``), ``{"endpoint", "version", "timeout"}`` pulls a
publish from a ``WeightStreamPublisher`` (``stream``). Either way the new
tensors (reference names, stacked ``[L, in, out]`` layers) are checked by
name and shape against the live model, converted into the live dtype on the
live device as a shadow model, and — for a stream, after the publisher's
digest verifies — published with the new version as one ``(model,
version)`` pair that each batch captures once. The retained KV states are
cleared. Any failure leaves the old pair live, the stats unchanged, and
answers 500 with ``{"ok": false, "version": <old>, "error"}``.

Telemetry, goodput, compile/memory watches, name-resolve registration,
request classes and prefix reuse wait for later slices.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch import resolve_device
from areal_tpu_torch.api.model import GenerationHyperparameters
from areal_tpu_torch.models import convert
from areal_tpu_torch.models import generate as genmod
from areal_tpu_torch.models import hf
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.transformer import Transformer
from areal_tpu_torch.ops.sampling import sampling_from_gconfigs
from areal_tpu_torch.system.serving import (
    KVStateStore,
    ReqState,
    ShapeBucketPolicy,
)
from areal_tpu_torch.system.weight_stream import (
    WeightStreamConsumer,
    WeightStreamError,
)

logger = logging.getLogger("areal_tpu_torch.generation_server")


@dataclasses.dataclass
class GenerationServerConfig:
    server_id: str = "gen0"
    chunk_tokens: int = 128  # most new tokens one /generate call decodes
    batch_window_ms: int = 5
    max_batch_size: int = 64
    prompt_bucket: int = 128
    eos_token_id: int = 1
    pad_token_id: int = 0
    host: str = "127.0.0.1"
    port: Optional[int] = None  # None: any free port
    # Retained decode states for chunk continuations (0 disables).
    kv_slots: int = 256
    kv_bucket: int = 256  # KV capacity granularity (slots)
    kv_bytes_budget: int = 4 << 30  # retained-KV bytes before LRU eviction
    # In-flight chunk requests of a streamed weight update.
    weight_stream_pipeline_depth: int = 4


class BadRequest(ValueError):
    """A /generate body the server cannot serve (HTTP 400)."""


class _Pending:
    __slots__ = ("rid", "prompt", "gconfig", "max_tokens", "tokens_done",
                 "future")

    def __init__(self, prompt, gconfig, max_tokens, rid=None, tokens_done=0):
        self.rid = rid
        self.prompt = prompt
        self.gconfig = gconfig
        self.max_tokens = max_tokens
        self.tokens_done = tokens_done
        self.future: concurrent.futures.Future = concurrent.futures.Future()


class GenerationServer:
    """Serves one model (``params``: the port's state dict) on ``device`` —
    CUDA unless the caller passes another (``resolve_device``)."""

    def __init__(self, cfg: GenerationServerConfig,
                 model_cfg: TransformerConfig, params: Dict[str, torch.Tensor],
                 device=None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        # The served (model, version) pair: each batch reads it once, and a
        # weight update replaces it in one assignment.
        self._published: Tuple[Transformer, int] = (Transformer.from_params(
            model_cfg, {k: v.to(self.device) for k, v in params.items()}), 0)
        # Reference names -> (shape, dtype) of the live weights: what an
        # update must deliver (the layout is fixed for the server's life).
        meta = {k: torch.empty_like(v, device="meta")
                for k, v in self.model.state_dict().items()}
        self._ref_specs = {k: (tuple(v.shape), v.dtype) for k, v in
                           convert.params_to_reference(meta, model_cfg).items()}
        self._update_lock = threading.Lock()
        self._last_update_latency = 0.0
        self._last_stream_stats: Dict[str, float] = {}
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        self.kv = KVStateStore(cfg.kv_slots, cfg.kv_bytes_budget)
        self.shapes = ShapeBucketPolicy(cfg.kv_bucket)
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._http: Optional[ThreadingHTTPServer] = None
        self._threads: List[threading.Thread] = []
        self._t_start = time.monotonic()
        # Counters read by stats(): prefill calls and the wall time of
        # prefill / decode work (device-synchronised on CUDA).
        self._tokens_out = 0
        self._prefill_tokens = 0
        self._prefill_calls = 0
        self._prefill_secs = 0.0
        self._decode_steps = 0
        self._decode_secs = 0.0

    @property
    def model(self) -> Transformer:
        return self._published[0]

    @property
    def version(self) -> int:
        return self._published[1]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------- decode core ----------------

    def _decode_batch(self, batch: List[_Pending]) -> List[Dict[str, Any]]:
        cfg, kv, shapes, dev = self.cfg, self.kv, self.shapes, self.device
        # One read of the pair: a swap mid-batch cannot tag new-weight
        # tokens with the old version.
        model, version = self._published
        # Rows with a smaller budget than the batch chunk stop early via
        # row_budget.
        chunk = shapes.round_chunk(
            min(cfg.chunk_tokens, max(p.max_tokens for p in batch)))

        # Continuations whose retained state matches (same weight version,
        # same prefix length) decode from their KV; the rest prefill.
        cont, fresh = [], []
        for p in batch:
            st = kv.get(p.rid) if p.rid is not None and cfg.kv_slots > 0 \
                else None
            if st is not None and st.version == version \
                    and st.cur_len == len(p.prompt):
                st.last_used = time.monotonic()
                cont.append((p, st))
            else:
                fresh.append(p)

        row_states: Dict[int, genmod.State] = {}
        if fresh:
            padded, plens = genmod.pad_prompts(
                [p.prompt for p in fresh], cfg.pad_token_id,
                bucket=cfg.prompt_bucket)
            # Pad prefill rows up to the row bucket with dummy one-token
            # prompts, sliced away below.
            B_pad = shapes.round_rows(len(fresh))
            if B_pad > len(fresh):
                padded = np.concatenate([padded, np.full(
                    (B_pad - len(fresh), padded.shape[1]), cfg.pad_token_id,
                    dtype=padded.dtype)])
                plens = np.concatenate(
                    [plens, np.ones(B_pad - len(fresh), plens.dtype)])
            S = shapes.round_capacity(padded.shape[1] + chunk)
            shapes.observe("prefill", B_pad, padded.shape[1], S)
            t0 = time.monotonic()
            st = genmod.prefill_state(
                model, torch.from_numpy(padded).to(dev),
                torch.from_numpy(plens).to(dev), S)
            self._sync()
            self._prefill_secs += time.monotonic() - t0
            self._prefill_calls += 1
            self._prefill_tokens += int(plens[:len(fresh)].sum())
            for i, p in enumerate(fresh):
                row_states[id(p)] = genmod.slice_state(st, i)
            del st
        for p, rs in cont:
            row_states[id(p)] = genmod.grow_state(
                rs.state, shapes.round_capacity(rs.cur_len + chunk))

        # Group rows by KV capacity: one decode call per capacity.
        groups: Dict[int, List[_Pending]] = {}
        for p in batch:
            groups.setdefault(row_states[id(p)]["kv_k"].shape[2], []).append(p)

        res_by_id: Dict[int, Dict[str, Any]] = {}
        for S, group in groups.items():
            # Pad the group to the row bucket with copies of row 0 given a
            # zero budget; their outputs are discarded.
            rows = shapes.round_rows(len(group))
            n_dummy = rows - len(group)
            states = [row_states[id(p)] for p in group]
            stacked = genmod.stack_states(states + states[:1] * n_dummy)
            done = torch.tensor([p.tokens_done for p in group] + [0] * n_dummy,
                                dtype=torch.int32, device=dev)
            sampling = sampling_from_gconfigs(
                [p.gconfig for p in group] + [group[0].gconfig] * n_dummy,
                device=dev)
            budget = torch.tensor(
                [min(p.max_tokens, chunk) for p in group] + [0] * n_dummy,
                dtype=torch.int32, device=dev)
            shapes.observe("decode", rows, S, chunk)
            t0 = time.monotonic()
            new_state, out = genmod.decode_chunk_rows(
                model, stacked, done, self._generator, sampling,
                n_tokens=chunk, eos_token_id=cfg.eos_token_id,
                pad_token_id=cfg.pad_token_id, row_budget=budget)
            ids = out["output_ids"].cpu().numpy()
            lps = out["output_logprobs"].cpu().numpy()
            lens = out["output_lens"].cpu().numpy()
            self._decode_secs += time.monotonic() - t0
            self._decode_steps += chunk
            for i, p in enumerate(group):
                # Never hand back more than the request's remaining budget.
                n = min(int(lens[i]), p.max_tokens)
                toks = ids[i][:n]
                # "finished" = the model ended the sequence (EOS); budget
                # exhaustion is the client's call.
                emitted_eos = bool((toks == cfg.eos_token_id).any())
                res_by_id[id(p)] = {
                    "output_ids": toks.tolist(),
                    "output_logprobs": lps[i][:n].tolist(),
                    "finished": emitted_eos,
                    "version": version,
                }
                self._tokens_out += n
                if p.rid is not None and cfg.kv_slots > 0:
                    # Keep only full-chunk continuations with budget left:
                    # the client's next prefix is exactly prompt + n.
                    keep = n == chunk and n < p.max_tokens
                    if emitted_eos or not keep:
                        kv.pop(p.rid)
                    else:
                        kv.put(p.rid, ReqState(
                            genmod.slice_state(new_state, i),
                            cur_len=len(p.prompt) + n, version=version))
        kv.evict()
        return [res_by_id[id(p)] for p in batch]

    def _runner(self) -> None:
        cfg = self.cfg
        while True:
            first = self._queue.get()
            if first is None:
                return
            batch = [first]
            time.sleep(cfg.batch_window_ms / 1000)
            stop = False
            while len(batch) < cfg.max_batch_size:
                try:
                    p = self._queue.get_nowait()
                except queue.Empty:
                    break
                if p is None:
                    stop = True
                    break
                batch.append(p)
            try:
                # inference_mode is thread-local: entered in this thread.
                with torch.inference_mode():
                    results = self._decode_batch(batch)
            except Exception as e:  # noqa: BLE001 — fail this batch, keep serving
                for p in batch:
                    p.future.set_exception(e)
            else:
                for p, r in zip(batch, results):
                    p.future.set_result(r)
            if stop:
                return

    # ---------------- requests ----------------

    def _parse(self, d: Dict[str, Any]) -> _Pending:
        try:
            gconfig = GenerationHyperparameters(**d.get("gconfig", {}))
            prompt = np.asarray(d["prompt_ids"], dtype=np.int64)
            max_tokens = int(d.get("max_tokens", gconfig.max_new_tokens))
            tokens_done = int(d.get("tokens_done", 0))
        except (KeyError, TypeError, ValueError) as e:
            raise BadRequest(f"malformed /generate body: {e!r}") from e
        if prompt.ndim != 1 or prompt.size == 0:
            raise BadRequest("prompt_ids must be a non-empty list of ints")
        if prompt.min() < 0 or prompt.max() >= self.model_cfg.vocab_size:
            raise BadRequest("prompt_ids out of the vocabulary range")
        if max_tokens < 1 or tokens_done < 0:
            raise BadRequest("max_tokens must be >= 1, tokens_done >= 0")
        rid = d.get("rid")
        return _Pending(prompt, gconfig, max_tokens,
                        rid=None if rid is None else str(rid),
                        tokens_done=tokens_done)

    def handle_generate(self, d: Dict[str, Any]) -> Dict[str, Any]:
        """Serve one /generate body: enqueue, wait for the batch it lands
        in, return the reply. Raises BadRequest for a malformed body."""
        p = self._parse(d)
        if self._http is None:
            raise RuntimeError("generation server is not running")
        self._queue.put(p)
        return p.future.result()

    def health(self) -> Dict[str, Any]:
        return {
            "ok": True,
            "version": self.version,
            "server_id": self.cfg.server_id,
            "uptime_secs": time.monotonic() - self._t_start,
            "queue_depth": self._queue.qsize(),
        }

    def stats(self) -> Dict[str, Any]:
        return {
            "generated_tokens": self._tokens_out,
            "prefill_tokens": self._prefill_tokens,
            "prefill_calls": self._prefill_calls,
            "prefill_secs": self._prefill_secs,
            "decode_steps": self._decode_steps,
            "decode_secs": self._decode_secs,
            "kv_states": self.kv.count,
            "kv_bytes": self.kv.nbytes,
            "shapes": self.shapes.shapes(),
            "version": self.version,
            "last_weight_update_latency_s": self._last_update_latency,
            # The last successful streamed update's legs (absent until one
            # lands; a later disk update does not describe them).
            **{f"last_stream_{k}": v
               for k, v in self._last_stream_stats.items()},
        }

    # ---------------- weight updates ----------------

    def _shadow(self, tensors: Iterable[Tuple[str, torch.Tensor]]
                ) -> Tuple[Dict[str, torch.Tensor], float]:
        """The port state dict of an update's tensors (reference names and
        layout), each checked by name and shape against the live weights
        and converted into the live dtype on the live device as it
        arrives; raises before anything live changes. Returns it with the
        seconds this thread spent in the conversions (h2d and layout)."""
        out: Dict[str, torch.Tensor] = {}
        seen = set()
        upload_secs = 0.0
        for name, t in tensors:
            spec = self._ref_specs.get(name)
            if spec is None:
                raise WeightStreamError(
                    f"update tensor {name!r} not in the live weights")
            if tuple(t.shape) != spec[0]:
                raise WeightStreamError(
                    f"tensor {name!r}: update shape {tuple(t.shape)} != "
                    f"live {spec[0]}")
            seen.add(name)
            t0 = time.monotonic()
            out.update(convert.params_from_jax(
                {name: t}, self.model_cfg, device=self.device, dtype=spec[1]))
            upload_secs += time.monotonic() - t0
        missing = sorted(set(self._ref_specs) - seen)
        if missing:
            raise WeightStreamError(f"incomplete update: {len(missing)} "
                                    f"tensors missing (e.g. {missing[:3]})")
        return out, upload_secs

    def _load_and_put_weights(self, path: str) -> Dict[str, torch.Tensor]:
        """Disk transport: a native checkpoint's tensors (or an HF
        checkpoint's, in the reference layout) into a shadow state dict."""
        if hf.is_native_checkpoint(path):
            flat = hf.load_hf_state_dict(path)
        else:
            _, params = hf.load_hf_checkpoint(path, device="cpu")
            flat = convert.params_to_reference(params, self.model_cfg)
        return self._shadow(flat.items())[0]

    def _stream_and_put_weights(self, endpoint: str, version: int,
                                timeout_secs: Optional[float] = None):
        """Stream transport: pull the publish into a shadow state dict, each
        tensor uploaded as it lands (its h2d overlaps the wire leg of the
        next), and verify the digest before returning. Returns (state
        dict, the consume's stats)."""
        consumer = WeightStreamConsumer(
            endpoint, pipeline_depth=self.cfg.weight_stream_pipeline_depth,
            **({} if timeout_secs is None
               else {"timeout_secs": float(timeout_secs)}))
        try:
            manifest = consumer.fetch_manifest(version)
            params, upload_secs = self._shadow(
                consumer.iter_tensors(version, manifest))
            # The gate: no swap without a checksum-verified stream.
            consumer.verify_digest(version)
            # The legs on this thread: waiting on the socket, CRCs with the
            # reassembly, and the conversions onto the device.
            return params, {
                "stream_bytes": float(consumer.bytes_received),
                "digest_verify_secs": consumer.checksum_secs,
                "wire_wait_secs": consumer.wire_wait_secs,
                "upload_secs": upload_secs,
            }
        finally:
            consumer.close()

    def handle_update_weights(self, d: Dict[str, Any]
                              ) -> Tuple[int, Dict[str, Any]]:
        """Serve one /update_weights body; returns (HTTP status, reply)."""
        t0 = time.monotonic()
        with self._update_lock:
            try:
                # The version first: a bad one fails before any load.
                version = int(d["version"] if d.get("endpoint")
                              else d.get("version", self.version + 1))
                stream_stats = None
                if d.get("device"):
                    raise NotImplementedError(
                        "the device transport is not ported yet (ROADMAP.md "
                        "Queue 1 item 8, multi-GPU parallelism)")
                if d.get("endpoint"):
                    params, stream_stats = self._stream_and_put_weights(
                        d["endpoint"], version, d.get("timeout"))
                else:
                    params = self._load_and_put_weights(d["path"])
                new = Transformer.from_params(self.model_cfg, params)
                # The upload ran on this thread's stream: the shadow weights
                # are complete before any batch can read them.
                self._sync()
            except Exception as e:  # noqa: BLE001 — keep old weights, report
                logger.error(f"weight update failed; keeping v{self.version}: "
                             f"{e!r}")
                return 500, {"ok": False, "version": self.version,
                             "error": repr(e)}
            # The swap: batches in flight captured the old pair and tag their
            # tokens with the old version.
            self._published = (new, version)
            # States decoded under the old weights are stale; a continuation
            # whose state survives a race re-prefills on its version check.
            self.kv.clear()
            dt = time.monotonic() - t0
            self._last_update_latency = dt
            if stream_stats is not None:
                self._last_stream_stats = stream_stats
        logger.info(f"weights updated to v{version} in {dt:.2f}s")
        return 200, {"ok": True, "version": version, "latency_s": dt}

    # ---------------- lifecycle ----------------

    def start(self) -> str:
        """Start the runner and the HTTP server; returns the base URL."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, status: int, body: Dict[str, Any]) -> None:
                data = json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):  # noqa: N802 (http.server naming)
                if self.path not in ("/generate", "/update_weights"):
                    return self._reply(404, {"ok": False, "error": "not found"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(body, dict):
                        raise BadRequest("body must be a JSON object")
                    if self.path == "/update_weights":
                        return self._reply(*server.handle_update_weights(body))
                    reply = server.handle_generate(body)
                except (BadRequest, json.JSONDecodeError) as e:
                    return self._reply(400, {"ok": False, "error": str(e)})
                except Exception as e:  # noqa: BLE001 — report, keep serving
                    return self._reply(500, {"ok": False, "error": repr(e)})
                self._reply(200, reply)

            def do_GET(self):  # noqa: N802
                if self.path != "/health":
                    return self._reply(404, {"ok": False, "error": "not found"})
                self._reply(200, server.health())

            def log_message(self, *args):
                pass

        self._http = ThreadingHTTPServer((self.cfg.host, self.cfg.port or 0),
                                         Handler)
        self._http.daemon_threads = True
        self._threads = [
            threading.Thread(target=self._runner, name="genserver-runner",
                             daemon=True),
            threading.Thread(target=self._http.serve_forever,
                             name="genserver-http", daemon=True),
        ]
        for t in self._threads:
            t.start()
        host, port = self._http.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self, timeout: float = 60.0) -> None:
        """Stop accepting requests, finish the batch in flight, fail any
        request still queued, and join both threads."""
        if self._http is None:
            return
        self._http.shutdown()
        self._http.server_close()
        self._queue.put(None)
        for t in self._threads:
            t.join(timeout)
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            if p is not None:
                p.future.set_exception(RuntimeError("generation server stopped"))
        self._http = None
        self._threads = []
