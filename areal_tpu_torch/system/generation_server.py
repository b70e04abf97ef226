"""Generation server: batched prefill + chunked KV-cache decode over HTTP.

Counterpart of ``areal_tpu/system/generation_server.py`` (``_decode_batch``,
``_try_seed_from_prefix``, ``_runner``, ``handle_generate``). Every
``POST /generate`` decodes at most ``chunk_tokens`` new tokens and returns
them tagged with the weight version; the client re-submits prompt +
accumulated tokens with the same ``rid`` and the server continues from the
retained KV state instead of re-prefilling.

The HTTP side is the standard library (``system/http.py``'s
``FleetHTTPServer``, a thread per connection): handler threads admit
requests into the serving engine's queue and wait; one runner thread forms
batches (``batch_window_ms``, up to ``max_batch_size``) and runs the decode
under ``torch.inference_mode()``. JSON in: ``prompt_ids``, ``gconfig``,
``max_tokens``, ``rid``, ``tokens_done``, and the chunked client's
``class`` and ``budget_total``; out: ``output_ids``, ``output_logprobs``,
``finished``, ``version``. ``GET /health`` carries the body the fleet
manager reads (``areal_tpu/system/generation_server.py:948``): liveness,
``server_id``, the weight ``version``, ``queue_depth``, ``inflight`` and the
EWMAs of the per-token decode time and of the time to first chunk.
``start()`` registers the URL under ``names.gen_servers`` (leased by a
heartbeat when ``AREAL_WORKER_KEEPALIVE_TTL`` is set) and ``stop()``
withdraws it.

Scheduling is the serving engine's (system/serving.py). With
``serving.enabled=false`` (the default) it is the rollout-only server: one
FIFO, no admission limits, a state kept only after a full chunk with
budget left. With ``serving.enabled=true``: an unknown ``class`` is served
as ``rollout``; a full class queue answers **429** with the reference's
body and an integer ``Retry-After`` header; a prompt whose bucketed width
(or, with ``budget_total``, the generation's last chunk) cannot fit the
largest capacity answers **413** with ``needed_slots`` / ``max_slots``;
batches drain interactive > eval > rollout; chunks are clamped under the
largest capacity bucket and prompt widths snapped to width buckets; a
state that used its whole allowance is kept, with its tokens in the prefix
trie; and a new request whose prompt shares at least
``min_prefix_tokens`` with a retained state clones the donor's KV and
prefills only the suffix (one B=1 ``extend_state``), unless the bucketed
suffix is no narrower than the prompt's own prefill width
(``serving/prefix_skipped_no_savings``). A donor's retained tensors are
never written: ``clone_prefix`` copies, and ``stack_states`` copies again
before ``decode_chunk_rows`` writes in place.

A model with a learned position table (GPT-2) answers **413** with the same
``prompt_too_long`` body, whatever the serving config, to a request whose
prompt plus its budget (``budget_total``, else ``max_tokens``) passes
``max_position_embeddings``, before any prefill. The reference clamps such
positions silently; the port refuses them (ROADMAP Queue 3).

``POST /update_weights`` swaps the served weights (reference
``handle_update_weights:877``): ``{"path", "version"}`` loads a native
checkpoint (``disk``), ``{"endpoint", "version", "timeout"}`` pulls a
publish from a ``WeightStreamPublisher`` (``stream``), and ``{"device":
true, "role", "digest", "version"}`` copies the trainer's device
publication (``parallel/reshard.py consume_device``: its gates, then a
device-to-device copy out of the publication's CUDA IPC buffer, under the
``genserver/device_consume`` watermark). Either way the new
tensors (reference names, stacked ``[L, in, out]`` layers) are checked by
name and shape against the live model, converted into the live dtype on the
live device as a shadow model, and — for a stream, after the publisher's
digest verifies — published with the new version as one ``(model,
version)`` pair that each batch captures once. The retained KV states and
the prefix trie are cleared. Any failure leaves the old pair live, the
stats unchanged, and answers 500 with ``{"ok": false, "version": <old>,
"error"}``.

Observability (``telemetry``, ``goodput``, ``compile_watch``; all off by
default), as the reference's server has it: a telemetry registry of the
server's own (several servers may share a process), the
``genserver/decode_chunk`` span and counters of every batch, the trace
spans of every traced request (``genserver/queue_wait``,
``genserver/prefill``, ``genserver/decode``, adopted from the
``X-Areal-Trace`` header), the weight-update span, gauges and watermark,
a goodput ledger (the runner thread owns idle <-> compute; weight updates
accrue as overlapping comm), live decode MFU and prefill TFLOP/s,
device-memory gauges, the serving engine's per-class counters, histograms
and queue gauges, and ``GET /metrics`` (Prometheus text: the live state as
``areal_genserver_*`` gauges plus the registry) and ``GET /metrics.json``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import json
import logging
import math
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch import resolve_device
from areal_tpu_torch.api.model import GenerationHyperparameters
from areal_tpu_torch.api.train_config import (
    CompileWatchConfig,
    GoodputConfig,
    ServingConfig,
    TelemetryConfig,
)
from areal_tpu_torch.base import compile_watch, monitor, name_resolve, names
from areal_tpu_torch.base import telemetry as telemetry_mod
from areal_tpu_torch.models import convert
from areal_tpu_torch.models import generate as genmod
from areal_tpu_torch.models import hf
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.transformer import Transformer
from areal_tpu_torch.ops.sampling import sampling_from_gconfigs
from areal_tpu_torch.system import goodput as goodput_mod
from areal_tpu_torch.system import memwatch as memwatch_mod
from areal_tpu_torch.system import serving as serving_mod
from areal_tpu_torch.system.http import FleetHTTPServer
from areal_tpu_torch.system.serving import (
    REQUEST_CLASSES,
    AdmissionReject,
    KVStateStore,
    PromptTooLong,
    ReqState,
    ServingEngine,
    ShapeBucketPolicy,
    round_up,
)
from areal_tpu_torch.system.weight_stream import (
    WeightStreamConsumer,
    WeightStreamError,
)
from areal_tpu_torch.system.worker_base import (
    HeartbeatThread,
    default_heartbeat_interval,
    env_keepalive_ttl,
)

logger = logging.getLogger("areal_tpu_torch.generation_server")


@dataclasses.dataclass
class GenerationServerConfig:
    experiment: str = "exp"
    trial: str = "trial"
    server_id: str = "gen0"
    # most new tokens one /generate call decodes
    chunk_tokens: int = serving_mod.GEN_CHUNK_TOKENS_DEFAULT
    batch_window_ms: int = 5
    max_batch_size: int = serving_mod.GEN_MAX_BATCH_SIZE_DEFAULT
    prompt_bucket: int = serving_mod.GEN_PROMPT_BUCKET_DEFAULT
    eos_token_id: int = 1
    pad_token_id: int = 0
    host: str = "127.0.0.1"
    port: Optional[int] = None  # None: any free port
    # Retained decode states for chunk continuations (0 disables).
    kv_slots: int = 256
    # KV capacity granularity (slots)
    kv_bucket: int = serving_mod.GEN_KV_BUCKET_DEFAULT
    kv_bytes_budget: int = 4 << 30  # retained-KV bytes before LRU eviction
    # In-flight chunk requests of a streamed weight update.
    weight_stream_pipeline_depth: int = 4
    # request classes, admission, prefix reuse, bounded shapes (off: the
    # rollout-only server)
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)
    telemetry: TelemetryConfig = dataclasses.field(
        default_factory=TelemetryConfig)
    goodput: GoodputConfig = dataclasses.field(default_factory=GoodputConfig)
    # arms the kernel-build watch and the device-memory gauges
    compile_watch: CompileWatchConfig = dataclasses.field(
        default_factory=CompileWatchConfig)


class BadRequest(ValueError):
    """A /generate body the server cannot serve (HTTP 400)."""


def rejection_reply(e: Exception) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
    """(status, body, headers) of an admission refusal, as the reference's
    ``handle_generate`` answers it: 429 with the exact retry-after in the
    body and RFC 9110 delay-seconds (an integer) in ``Retry-After``, or
    413."""
    if isinstance(e, AdmissionReject):
        return 429, {"ok": False, "reason": "admission", "class": e.cls,
                     "queue_depth": e.depth, "retry_after": e.retry_after}, \
            {"Retry-After": str(math.ceil(e.retry_after))}
    return 413, {"ok": False, "reason": "prompt_too_long",
                 "needed_slots": e.needed, "max_slots": e.cap}, {}


class _Pending:
    __slots__ = ("rid", "prompt", "gconfig", "max_tokens", "tokens_done",
                 "future", "t_enqueue", "t_enqueue_wall", "cls", "trace")

    def __init__(self, prompt, gconfig, max_tokens, rid=None, tokens_done=0,
                 cls="rollout", trace=None):
        self.rid = rid
        self.prompt = prompt
        self.gconfig = gconfig
        self.max_tokens = max_tokens
        self.tokens_done = tokens_done
        self.future: concurrent.futures.Future = concurrent.futures.Future()
        self.t_enqueue = time.monotonic()
        self.t_enqueue_wall = time.time()
        self.cls = cls  # request class (serving.REQUEST_CLASSES)
        # The caller's trace (telemetry.TraceContext), None if untraced.
        self.trace = trace


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
        self._http: Optional[FleetHTTPServer] = None
        self._threads: List[threading.Thread] = []
        self._t_start = time.monotonic()
        # Counters read by stats(): batched prefills and seeded suffix
        # extensions, the wall time of prefill / extend / decode work
        # (device-synchronised on CUDA), and the serving counters.
        self._tokens_out = 0
        self._prefill_tokens = 0
        self._prefill_calls = 0
        self._prefill_secs = 0.0
        self._extend_calls = 0
        self._extend_secs = 0.0
        self._decode_steps = 0
        self._decode_secs = 0.0
        self._counts: collections.Counter = collections.Counter()
        self._kv_peak_bytes = 0
        # /health's load and latency fields (the manager reads them)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._decode_ewma_secs: Optional[float] = None
        self._ttfc_ewma_secs: Optional[float] = None
        self._hb = None
        # Observability: a registry of this server's own (the fleet
        # process hosts several workers), keyed by the server id's digits;
        # a dynamic server ("dynN") from 1000 up, so that dyn1 never
        # overwrites gen1's series at the aggregator.
        idx = int("".join(c for c in cfg.server_id if c.isdigit()) or 0)
        if cfg.server_id.startswith("dyn"):
            idx += 1000
        self.telemetry = (
            telemetry_mod.Telemetry(cfg.experiment, cfg.trial,
                                    "generation_server", idx,
                                    cfg=cfg.telemetry)
            if cfg.telemetry.enabled else telemetry_mod.NULL)
        # idle is the base state (queue-empty waits), batches are compute,
        # weight updates accrue as overlapping comm
        self.ledger = goodput_mod.make_ledger(cfg.goodput, self.telemetry)
        self._mfu: Optional[goodput_mod.MfuEmitter] = None
        if self.ledger.enabled:
            self._mfu = goodput_mod.MfuEmitter(
                self.telemetry,
                goodput_mod.resolve_peak_flops(
                    cfg.goodput,
                    torch.cuda.get_device_name(self.device)
                    if self.device.type == "cuda" else str(self.device)),
                tflops_name="genserver/decode_tflops",
                mfu_name="genserver/decode_mfu",
                context=f"genserver {cfg.server_id}")
        arm_watch = cfg.compile_watch.enabled and cfg.telemetry.enabled
        self.memwatch = (
            memwatch_mod.MemWatch(
                self.telemetry,
                sample_interval_secs=cfg.compile_watch.mem_sample_interval_secs)
            if arm_watch else memwatch_mod.NULL)
        if arm_watch and not compile_watch.enabled():
            # The kernel libraries are built once per process: their build
            # is recorded on the first armed server's registry.
            compile_watch.configure(cfg.compile_watch, self.telemetry)
        # The serving engine owns the queue, the retained KV and the shape
        # set; the handlers and the runner delegate to it.
        self.serving = ServingEngine(
            cfg.serving, kv_slots=cfg.kv_slots,
            kv_bytes_budget=cfg.kv_bytes_budget, kv_bucket=cfg.kv_bucket,
            chunk_tokens=cfg.chunk_tokens, max_batch_size=cfg.max_batch_size,
            prompt_bucket=cfg.prompt_bucket, telemetry=self.telemetry)
        self._queue = self.serving.queue

    @property
    def model(self) -> Transformer:
        return self._published[0]

    @property
    def version(self) -> int:
        return self._published[1]

    @property
    def kv(self) -> KVStateStore:
        return self.serving.kv

    @property
    def shapes(self) -> ShapeBucketPolicy:
        return self.serving.shapes

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _count(self, name: str, n: int = 1) -> None:
        """A serving counter, in stats() and in the telemetry registry."""
        self._counts[name] += n
        self.telemetry.inc(name, n)

    # ---------------- decode core ----------------

    def _decode_batch(self, batch: List[_Pending]) -> List[Dict[str, Any]]:
        cfg, kv, shapes, dev = self.cfg, self.kv, self.shapes, self.device
        # One read of the pair: a swap mid-batch cannot tag new-weight
        # tokens with the old version (nor retained KV, which seeds others).
        model, version = self._published
        # Rows with a smaller budget than the batch chunk stop early via
        # row_budget.
        chunk = shapes.round_chunk(
            min(cfg.chunk_tokens, max(p.max_tokens for p in batch)))
        if shapes.capacity_buckets is not None:
            # The room left under the largest capacity bucket above the
            # widest bucketed prompt (what admission checked: >= 1 slot),
            # snapped down to a chunk bucket.
            widest = max(shapes.round_width(round_up(len(p.prompt),
                                                     cfg.prompt_bucket))
                         for p in batch)
            room = shapes.capacity_buckets[-1] - widest
            chunk = max(1, shapes.round_chunk_down(min(chunk, room)))

        # Continuations whose retained state matches (same weight version,
        # same prefix length) decode from their KV; the rest prefill, from
        # a shared-prefix donor where the engine finds one. The state object
        # is captured here: /update_weights may clear the store meanwhile.
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
                if p.tokens_done > 0:
                    self._counts["reprefilled_continuations"] += 1

        row_states: Dict[int, genmod.State] = {}
        fresh = [p for p in fresh if not self._try_seed_from_prefix(
            p, row_states, model, version, chunk)]
        if fresh:
            padded, plens = genmod.pad_prompts(
                [p.prompt for p in fresh], cfg.pad_token_id,
                bucket=cfg.prompt_bucket)
            # Snap the width to a width bucket (pass-through with serving
            # off).
            W = shapes.round_width(padded.shape[1])
            if W > padded.shape[1]:
                padded = np.concatenate([padded, np.full(
                    (padded.shape[0], W - padded.shape[1]), cfg.pad_token_id,
                    dtype=padded.dtype)], axis=1)
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
            t_wall = time.time()
            t0 = time.monotonic()
            st = genmod.prefill_state(
                model, torch.from_numpy(padded).to(dev),
                torch.from_numpy(plens).to(dev), S)
            self._sync()
            prefill_secs = time.monotonic() - t0
            n_prefill = int(plens[:len(fresh)].sum())
            self._prefill_secs += prefill_secs
            self._prefill_calls += 1
            self._prefill_tokens += n_prefill
            if self._mfu is not None and prefill_secs > 0 and n_prefill:
                # analytic forward-only FLOP/s (base/monitor.py formulas)
                pf = monitor.model_flops_per_token(
                    self.model_cfg, n_prefill / len(fresh),
                    backward=False) * n_prefill
                self.telemetry.set_gauge("genserver/prefill_tflops",
                                         pf / prefill_secs / 1e12)
            for i, p in enumerate(fresh):
                row_states[id(p)] = genmod.slice_state(st, i)
                if p.trace is not None:
                    # the shared batched prefill, tagged per request
                    self.telemetry.add_span(
                        "genserver/prefill", t_wall, prefill_secs,
                        trace=p.trace, prompt_len=len(p.prompt),
                        batch_size=len(fresh))
            del st
        for p, rs in cont:
            # the retained state itself when large enough: stack_states
            # copies it before the decode writes
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
            self._counts["decode_row_steps"] += rows * chunk
            self._counts["dummy_row_steps"] += n_dummy * chunk
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
                    allowance = min(p.max_tokens, chunk)
                    keep = (
                        # serving: the client's next prefix is prompt + n
                        # whenever the row used its allowance; a state whose
                        # client never returns still serves as a donor,
                        # and LRU and the byte budget reclaim it
                        (cfg.serving.enabled and n == allowance)
                        # default: a full chunk with budget left only
                        or (not cfg.serving.enabled
                            and n == chunk and n < p.max_tokens))
                    if emitted_eos or not keep:
                        kv.pop(p.rid)
                    else:
                        kv.put(p.rid, ReqState(
                            genmod.slice_state(new_state, i),
                            cur_len=len(p.prompt) + n, version=version,
                            # the sequence feeds only the prefix trie
                            tokens=np.concatenate([
                                np.asarray(p.prompt, np.int64),
                                toks.astype(np.int64)])
                            if kv.prefix_reuse else None))
        kv.evict()
        self._kv_peak_bytes = max(self._kv_peak_bytes, kv.nbytes)
        return [res_by_id[id(p)] for p in batch]

    def _try_seed_from_prefix(self, p: _Pending, row_states: Dict,
                              model: Transformer, version: int,
                              chunk: int) -> bool:
        """Cross-request prefix seeding: when a retained state's tokens
        share a prefix with this prompt, clone the donor's KV at the shared
        length and prefill only the suffix. True when ``row_states[id(p)]``
        was seeded."""
        cfg, shapes, kv = self.cfg, self.shapes, self.kv
        got = kv.acquire_prefix(p.prompt, version,
                                min_len=cfg.serving.min_prefix_tokens)
        if got is None:
            return False
        rid, shared = got
        try:
            T = None
            if shared < len(p.prompt):
                # Prefill and extend pad to the same width buckets: a clone
                # and extend saves work only when the bucketed suffix is
                # narrower than the prompt's own prefill width.
                try:
                    W_full = shapes.round_width(
                        round_up(len(p.prompt), cfg.prompt_bucket))
                    T = shapes.round_width(
                        round_up(len(p.prompt) - shared, cfg.prompt_bucket))
                except PromptTooLong:
                    return False  # near the capacity ceiling: plain prefill
                if T >= W_full:
                    self._count("serving/prefix_skipped_no_savings")
                    return False
            donor = kv.get(rid)
            if donor is None:
                # /update_weights cleared the store since the acquire
                return False
            # a copy: extending or decoding it never writes the donor
            st = genmod.clone_prefix(donor.state, shared)
            suffix = p.prompt[shared:]
            if len(suffix) == 0:
                # An exact match of the donor's whole sequence: its last
                # logits are this prompt's; a pure clone, no prefill.
                row_states[id(p)] = genmod.grow_state(
                    st, shapes.round_capacity(len(p.prompt) + chunk))
            else:
                try:
                    need = shapes.round_capacity(
                        max(len(p.prompt) + chunk, shared + T))
                except PromptTooLong:
                    return False  # near the capacity ceiling: plain prefill
                st = genmod.grow_state(st, need)
                padded = np.full((1, T), cfg.pad_token_id, np.int32)
                padded[0, :len(suffix)] = suffix
                shapes.observe("extend", 1, T, st["kv_k"].shape[2])
                t0 = time.monotonic()
                row_states[id(p)] = genmod.extend_state(
                    model, st, torch.from_numpy(padded).to(self.device),
                    torch.tensor([len(suffix)], dtype=torch.int32,
                                 device=self.device))
                self._sync()
                self._extend_secs += time.monotonic() - t0
                self._extend_calls += 1
                self._prefill_tokens += len(suffix)
            self._count("serving/prefix_hits")
            self._count("serving/prefix_tokens_saved", shared)
            return True
        finally:
            kv.release(rid)

    def _runner(self) -> None:
        cfg = self.cfg
        while True:
            # The runner owns the ledger's partition: queue-empty waits are
            # idle, batches compute.
            self.ledger.enter("idle")
            first = self._queue.get()
            if first is None:
                return  # closed and empty
            batch = [first]
            time.sleep(cfg.batch_window_ms / 1000)
            # up to max_batch_size, in class priority order (FIFO with
            # serving off); sampling is per row, so gconfigs mix freely
            batch += self._queue.drain(cfg.max_batch_size - 1)
            t_formed = time.monotonic()
            for p in batch:
                self.serving.record_queue_wait(
                    p.cls, t_formed - p.t_enqueue, trace=p.trace,
                    t_start_wall=p.t_enqueue_wall)
            try:
                with self.telemetry.span("genserver/decode_chunk",
                                         batch_size=len(batch)) as attrs, \
                        self.ledger.state("compute"):
                    # inference_mode is thread-local: entered in this thread.
                    with torch.inference_mode():
                        results = self._decode_batch(batch)
                    attrs["tokens"] = sum(len(r["output_ids"])
                                          for r in results)
            except Exception as e:  # noqa: BLE001 — fail this batch, keep serving
                for p in batch:
                    p.future.set_exception(e)
            else:
                dt = time.monotonic() - t_formed
                self._observe_latency(batch, results, dt)
                self._record_batch(batch, results, dt, attrs["tokens"])
                for p, r in zip(batch, results):
                    p.future.set_result(r)

    def _record_batch(self, batch: List[_Pending],
                      results: List[Dict[str, Any]], dt: float,
                      tokens: int) -> None:
        """One batch's counters, live decode MFU, per-request decode spans
        and the serving engine's latency histograms and gauges."""
        tel = self.telemetry
        if not tel.enabled:
            return
        tel.inc("genserver/decode_chunks")
        tel.inc("genserver/generated_tokens", tokens)
        if self._mfu is not None and tokens and dt > 0:
            # each new token runs one forward at about its row's context
            avg_ctx = sum(len(p.prompt) + p.tokens_done
                          for p in batch) / len(batch)
            self._mfu.emit(monitor.model_flops_per_token(
                self.model_cfg, avg_ctx, backward=False) * tokens / dt)
        t_wall = time.time() - dt
        for p, r in zip(batch, results):
            n_tok = len(r["output_ids"])
            if p.trace is not None:
                # this request's share of the batched decode window
                tel.add_span("genserver/decode", t_wall, dt, trace=p.trace,
                             tokens=n_tok, batch_size=len(batch),
                             version=r.get("version"))
            if p.tokens_done == 0:
                self.serving.record_first_chunk(
                    p.cls, time.monotonic() - p.t_enqueue)
            if n_tok:
                self.serving.record_token_latency(p.cls, dt / n_tok)
        self.serving.export_gauges()

    def _observe_latency(self, batch: List[_Pending],
                         results: List[Dict[str, Any]], dt: float) -> None:
        """The EWMAs of /health (reference ``_runner``): decode seconds per
        token of the batch's longest reply, and, for each new generation,
        the time from its enqueue to its first chunk."""
        chunk_tokens = max((len(r["output_ids"]) for r in results), default=0)
        if chunk_tokens > 0:
            sample = dt / chunk_tokens
            self._decode_ewma_secs = (
                sample if self._decode_ewma_secs is None
                else 0.7 * self._decode_ewma_secs + 0.3 * sample)
        now = time.monotonic()
        for p in batch:
            if p.tokens_done == 0:
                ttfc = now - p.t_enqueue
                self._ttfc_ewma_secs = (
                    ttfc if self._ttfc_ewma_secs is None
                    else 0.7 * self._ttfc_ewma_secs + 0.3 * ttfc)

    # ---------------- requests ----------------

    def _parse(self, d: Dict[str, Any], headers=None) -> _Pending:
        try:
            gconfig = GenerationHyperparameters(**d.get("gconfig", {}))
            prompt = np.asarray(d["prompt_ids"], dtype=np.int64)
            max_tokens = int(d.get("max_tokens", gconfig.max_new_tokens))
            tokens_done = int(d.get("tokens_done", 0))
            if d.get("budget_total") is not None:
                int(d["budget_total"])
        except (KeyError, TypeError, ValueError) as e:
            raise BadRequest(f"malformed /generate body: {e!r}") from e
        if prompt.ndim != 1 or prompt.size == 0:
            raise BadRequest("prompt_ids must be a non-empty list of ints")
        if prompt.min() < 0 or prompt.max() >= self.model_cfg.vocab_size:
            raise BadRequest("prompt_ids out of the vocabulary range")
        if max_tokens < 1 or tokens_done < 0:
            raise BadRequest("max_tokens must be >= 1, tokens_done >= 0")
        rid = d.get("rid")
        return _Pending(
            prompt, gconfig, max_tokens,
            rid=None if rid is None else str(rid), tokens_done=tokens_done,
            # any unknown class, of any JSON type, is served as rollout
            cls=serving_mod.normalize_class(d.get("class")),
            # the caller's trace (none without telemetry or the header)
            trace=(telemetry_mod.extract_headers(headers)
                   if self.telemetry.enabled and headers is not None
                   else None))

    def handle_generate(self, d: Dict[str, Any],
                        headers=None) -> Dict[str, Any]:
        """Serve one /generate body (``headers``: the request's, for its
        trace): admit, wait for the batch it lands in, return the reply.
        Raises BadRequest for a malformed body, and the serving engine's
        AdmissionReject (429) or PromptTooLong (413) for a refusal
        (:func:`rejection_reply` makes the answer)."""
        p = self._parse(d, headers)
        if self._http is None:
            raise RuntimeError("generation server is not running")
        budget = d.get("budget_total")
        if self.model_cfg.pos_embedding == "learned":
            # The generation's last position must stay inside the learned
            # table: refused before any prefill, as a prompt too long.
            limit = self.model_cfg.max_position_embeddings
            needed = len(p.prompt) + (int(budget) if budget else p.max_tokens)
            if needed > limit:
                raise PromptTooLong(needed, limit)
        # Admission and enqueue are one decision under the queue's lock.
        # budget_total (the chunked client's whole remaining budget) makes
        # the feasibility check cover the generation's last chunk.
        self.serving.admit(
            p, p.cls, prompt_len=len(p.prompt),
            planned_len=len(p.prompt) + int(budget) if budget else None)
        with self._inflight_lock:
            self._inflight += 1
        try:
            return p.future.result()
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def health(self) -> Dict[str, Any]:
        # the manager's probe doubles as the ledger's heartbeat
        self.ledger.poll()
        return {
            "ok": True,
            "version": self.version,
            "server_id": self.cfg.server_id,
            "uptime_secs": time.monotonic() - self._t_start,
            "queue_depth": self._queue.qsize(),
            "inflight": self._inflight,
            "decode_ewma_secs": self._decode_ewma_secs,
            "ttfc_ewma_secs": self._ttfc_ewma_secs,
        }

    def metrics_dict(self) -> Dict[str, Any]:
        """``GET /metrics.json``: the live state (reference
        ``_metrics_dict``); samples the device-memory gauges."""
        self.ledger.poll()  # scrape-time freshness for the idle state
        self.memwatch.sample()
        dt = max(time.monotonic() - self._t_start, 1e-6)
        d = {
            "generated_tokens": self._tokens_out,
            "prefill_tokens": self._prefill_tokens,
            "tokens_per_sec": self._tokens_out / dt,
            "kv_states": self.kv.count,
            "kv_bytes": self.kv.nbytes,
            "compiled_shapes": self.shapes.distinct_shapes,
            "version": self.version,
            "inflight_requests": self._inflight,
            "queue_depth": self._queue.qsize(),
            "decode_ewma_secs": self._decode_ewma_secs or 0.0,
            "ttfc_ewma_secs": self._ttfc_ewma_secs or 0.0,
            "last_weight_update_latency_s": self._last_update_latency,
            **{f"last_stream_{k}": v
               for k, v in self._last_stream_stats.items()},
        }
        if self.cfg.serving.enabled:
            for c in REQUEST_CLASSES:
                d[f"serving_queue_{c}"] = self._queue.depth(c)
        return d

    def metrics_text(self) -> str:
        """``GET /metrics``: the live state as ``areal_genserver_*``
        gauges plus this server's telemetry registry, labelled with its
        server id."""
        d = self.metrics_dict()
        extra = {f"genserver_{k}": v for k, v in d.items()}
        # the canonical name, present from boot
        extra["genserver_weight_version"] = d["version"]
        return telemetry_mod.render_prometheus(
            self.telemetry.snapshot(reset=False), extra_gauges=extra,
            labels={"server_id": self.cfg.server_id})

    def stats(self) -> Dict[str, Any]:
        return {
            "generated_tokens": self._tokens_out,
            "prefill_tokens": self._prefill_tokens,
            "prefill_calls": self._prefill_calls,
            "prefill_secs": self._prefill_secs,
            "extend_calls": self._extend_calls,
            "extend_secs": self._extend_secs,
            "decode_steps": self._decode_steps,
            "decode_secs": self._decode_secs,
            "kv_states": self.kv.count,
            "kv_bytes": self.kv.nbytes,
            "kv_peak_bytes": self._kv_peak_bytes,
            "shapes": self.shapes.shapes(),
            "version": self.version,
            "last_weight_update_latency_s": self._last_update_latency,
            # prefix hits, tokens saved and skipped seeds, decode and dummy
            # row-steps, continuations that found no state of their own
            **{k: self._counts[k] for k in (
                "serving/prefix_hits", "serving/prefix_tokens_saved",
                "serving/prefix_skipped_no_savings", "decode_row_steps",
                "dummy_row_steps", "reprefilled_continuations")},
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
        # The shadow swap is the server's device-memory high-water mark:
        # old and new weights coexist until the verified swap.
        with self.memwatch.watermark("genserver/shadow_swap"):
            return self._stream_shadow(consumer, version)

    def _stream_shadow(self, consumer: WeightStreamConsumer, version: int):
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

    def _reshard_published_weights(self, role: str, version: int,
                                   digest: str) -> Dict[str, torch.Tensor]:
        """Device transport: the trainer's publication, gated by version,
        digest, tree, shapes and a live publisher, copied device to device
        into a shadow state dict in the live dtypes (reference
        ``_reshard_published_weights:855``). A failed gate raises with the
        old weights still live."""
        from areal_tpu_torch.parallel import reshard as rsh

        with self.memwatch.watermark("genserver/device_consume"):
            return rsh.consume_device(
                self.cfg.experiment, self.cfg.trial, role, version, digest,
                self.model.state_dict())

    def handle_update_weights(self, d: Dict[str, Any]
                              ) -> Tuple[int, Dict[str, Any]]:
        """Serve one /update_weights body; returns (HTTP status, reply)."""
        t0 = time.monotonic()
        transport = ("device" if d.get("device")
                     else "stream" if d.get("endpoint") else "disk")
        with self._update_lock:
            try:
                with self.telemetry.span("genserver/weight_update",
                                         transport=transport,
                                         version=d.get("version", -1)):
                    # The version first: a bad one fails before any load.
                    version = int(d["version"] if d.get("endpoint")
                                  else d.get("version", self.version + 1))
                    stream_stats = None
                    if d.get("device"):
                        params = self._reshard_published_weights(
                            d.get("role", "actor"), version,
                            d.get("digest", ""))
                    elif d.get("endpoint"):
                        params, stream_stats = self._stream_and_put_weights(
                            d["endpoint"], version, d.get("timeout"))
                    else:
                        params = self._load_and_put_weights(d["path"])
                    new = Transformer.from_params(self.model_cfg, params)
                    # The upload ran on this thread's stream: the shadow
                    # weights are complete before any batch can read them.
                    self._sync()
            except Exception as e:  # noqa: BLE001 — keep old weights, report
                self.telemetry.inc("genserver/weight_update_failures")
                logger.error(f"weight update failed; keeping v{self.version}: "
                             f"{e!r}")
                return 500, {"ok": False, "version": self.version,
                             "error": repr(e)}
            finally:
                # Accrued, not a transition: the update overlaps decodes
                # whose runner owns the ledger's partition.
                self.ledger.add_overlap("comm", time.monotonic() - t0)
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
        self.telemetry.set_gauge("genserver/weight_version", version)
        self.telemetry.set_gauge("genserver/weight_update_secs", dt)
        if stream_stats is not None:
            # a disk update must not republish a stream's stats
            for k, v in stream_stats.items():
                self.telemetry.set_gauge(f"genserver/{k}", v)
        logger.info(f"weights updated to v{version} in {dt:.2f}s")
        return 200, {"ok": True, "version": version, "latency_s": dt}

    # ---------------- lifecycle ----------------

    def _key(self) -> str:
        return names.gen_servers(self.cfg.experiment, self.cfg.trial,
                                 self.cfg.server_id)

    def start(self) -> str:
        """Start the runner and the HTTP server, register the URL under
        ``names.gen_servers``; returns the URL."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, status: int, body: Dict[str, Any],
                       headers: Optional[Dict[str, str]] = None) -> None:
                data = json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
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
                    reply = server.handle_generate(body, self.headers)
                except (BadRequest, json.JSONDecodeError) as e:
                    return self._reply(400, {"ok": False, "error": str(e)})
                except (AdmissionReject, PromptTooLong) as e:
                    return self._reply(*rejection_reply(e))
                except Exception as e:  # noqa: BLE001 — report, keep serving
                    return self._reply(500, {"ok": False, "error": repr(e)})
                self._reply(200, reply)

            def do_GET(self):  # noqa: N802
                if self.path == "/health":
                    return self._reply(200, server.health())
                if self.path == "/metrics.json":
                    return self._reply(200, server.metrics_dict())
                if self.path != "/metrics":
                    return self._reply(404, {"ok": False, "error": "not found"})
                data = server.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self._http = FleetHTTPServer((self.cfg.host, self.cfg.port or 0),
                                         Handler)
        self._threads = [
            threading.Thread(target=self._runner, name="genserver-runner",
                             daemon=True),
            threading.Thread(target=self._http.serve_forever,
                             name="genserver-http", daemon=True),
        ]
        for t in self._threads:
            t.start()
        host, port = self._http.server_address[:2]
        url = f"http://{host}:{port}"
        ttl = env_keepalive_ttl() or 0.0
        name_resolve.add(self._key(), url, replace=True,
                         keepalive_ttl=ttl or None)
        if ttl:
            # A thread of its own keeps the lease: a long batch must not
            # let it lapse, and a killed process loses it with its threads.
            self._hb = HeartbeatThread(
                self.cfg.experiment, self.cfg.trial,
                f"genserver_{self.cfg.server_id}",
                interval=default_heartbeat_interval(ttl),
                # names.compile_inflight while a kernel library builds
                inflight_fn=compile_watch.inflight)
            self._hb.lease(self._key(), url, ttl)
        logger.info(f"generation server {self.cfg.server_id} at {url}"
                    + (f" (keepalive {ttl:.0f}s)" if ttl else ""))
        return url

    def stop(self, timeout: float = 60.0) -> None:
        """Stop accepting requests, serve what is queued, fail anything
        still queued after ``timeout``, and join both threads."""
        if self._http is None:
            return
        if self._hb is not None:
            self._hb.close()
            self._hb = None
        # Withdraw discovery first: the manager forgets this URL on its
        # next sweep instead of probing a stopped server.
        try:
            name_resolve.delete(self._key())
        except name_resolve.NameEntryNotFoundError:
            pass
        self._http.shutdown()
        self._http.server_close()
        self._queue.close()  # past every limit and the priority order
        for t in self._threads:
            t.join(timeout)
        while True:
            try:
                p = self._queue.get_nowait()
            except IndexError:
                break
            p.future.set_exception(RuntimeError("generation server stopped"))
        self._http = None
        self._threads = []
        self.ledger.flush()
        self.memwatch.close()
        self.telemetry.close()
