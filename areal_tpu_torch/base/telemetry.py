"""Unified telemetry: per-process metric registry, trace spans, cross-worker
aggregation, Prometheus rendering, and on-demand profiler capture.

The port's copy of ``areal_tpu/base/telemetry.py``. What the reference
has, with its semantics:

 - :class:`TelemetryRegistry` — per-process counters (monotonic), gauges
   (last value), histograms (fixed buckets, Prometheus-style cumulative),
   and trace spans (id / parent-id / wall-times, nested via a contextvar
   so asyncio tasks and threads each get a correct parent chain).
 - Cross-worker trace context (:class:`TraceContext`, :func:`start_trace`,
   :func:`inject_headers` / :func:`extract_headers`, :func:`inject_payload`
   / :func:`extract_payload`) and the per-worker :class:`FlightRecorder`.
 - :class:`TelemetryPusher` — a background thread that snapshots the
   registry every ``flush_interval_secs`` and sends it to the master,
   tagged ``(worker_kind, worker_index)``. Endpoint discovery is lazy (the
   aggregator may start after the worker); until it appears, snapshots
   accumulate spans up to a bounded buffer.
 - :class:`TelemetryAggregator` — the master's endpoint (registered under
   ``names.telemetry_aggregator``) merging per-worker snapshots into one
   state keyed by ``worker_kind:worker_index``, appending every snapshot
   to ``telemetry.jsonl``, stitching traces into ``traces.jsonl``
   (:class:`TraceStitcher`) and, with ``http_port > 0``, serving the
   merged fleet state as Prometheus text on ``GET /metrics`` (advertised
   under ``names.telemetry_http``).
 - :func:`render_prometheus` — registry snapshot → Prometheus exposition
   text (the generation server and the manager serve it themselves).
 - Profiler trigger — :func:`request_profiler_capture` writes
   ``names.profiler_trigger``; the trainer's :class:`ProfilerTriggerWatcher`
   polls it between requests, runs ``torch.profiler`` (CPU and CUDA
   activities) for the requested window and writes a Chrome trace under
   the requested directory, reporting under ``names.profiler_status``.

Differences from the reference, all on the wire or the profiler:

 - The pusher sends the reference's pickled snapshot as one frame of the
   port's multipart framing (``system/frames.py``) over TCP, where the
   reference uses a zmq PUSH socket with ``NOBLOCK``. The socket is
   non-blocking: a flush never waits on the aggregator. A snapshot the
   kernel's send buffer cannot take whole stays pending (the reference's
   one pending snapshot) and the registry is not drained again until it
   has gone out; a broken connection resends it whole on the next one.
 - ``torch.profiler`` writes a Chrome trace (``trace_<pid>.json``) where
   the reference's profiler writes an XPlane dump.

Disabled-by-default contract: until :func:`configure` is called with an
enabled config, the module-level API (:func:`inc`, :func:`set_gauge`,
:func:`observe`, :func:`span`) routes to a shared null object — no locks
taken beyond one attribute read, no sockets, no HTTP servers, no span
allocation.
"""

from __future__ import annotations

import collections
import contextvars
import dataclasses
import itertools
import json
import os
import pickle
import signal
import socket
import sys
import threading
import time
import uuid
import weakref
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence, Tuple

from areal_tpu_torch.base import logging, name_resolve, names, network

logger = logging.getLogger("base.telemetry")

# Latency-shaped default buckets (seconds): 1ms .. ~2min, Prometheus-style.
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

# A pusher's connect attempt to the aggregator (from its own thread).
CONNECT_TIMEOUT_SECS = 2.0
# The longest the aggregator waits for the rest of a message it started to
# read (a pusher sends each snapshot whole unless its connection breaks).
INGEST_TIMEOUT_SECS = 5.0

_span_ids = itertools.count(1)
# Current span id of the calling context (asyncio task / thread); copied
# into child tasks by asyncio, fresh (None) in new threads.
_CUR_SPAN: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "areal_tpu_torch_cur_span", default=None
)


# --------------------------------------------------------------------------
# cross-worker trace context (sample-lineage tracing)
# --------------------------------------------------------------------------
#
# Dapper-style propagation: a rollout worker ORIGINATES a trace when a
# prompt is admitted; every RPC that serves that sample carries the
# (trace_id, parent span ref) pair — an HTTP header on /generate and
# /allocate_rollout, an optional ``_trace`` dict on the rollout→trainer
# push stream — and every receiving worker's spans link back to the
# remote parent. Span ids are only unique per process, so a remote
# parent is referenced by its GLOBAL ref ``worker_kind:worker_index/
# span_id`` — exactly the key the aggregator files the span under,
# which is what lets the master-side TraceStitcher join the pieces.


@dataclasses.dataclass
class TraceContext:
    """The portable part of a trace: which trace, and which remote span
    to hang the next child off."""

    trace_id: str
    parent_span: Optional[str] = None  # global ref "kind:idx/span_id"

    def as_dict(self) -> Dict[str, str]:
        d = {"trace_id": self.trace_id}
        if self.parent_span:
            d["parent_span"] = self.parent_span
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> Optional["TraceContext"]:
        tid = d.get("trace_id")
        if not tid:
            return None
        return cls(trace_id=str(tid),
                   parent_span=d.get("parent_span") or None)


_CUR_TRACE: contextvars.ContextVar[Optional[TraceContext]] = (
    contextvars.ContextVar("areal_tpu_torch_cur_trace", default=None)
)

# Single wire header for both directions; value is "<trace_id>;<parent>"
# (the parent half may be empty). One header keeps the disabled-path
# contract trivially checkable: no trace ⇒ the header dict is empty ⇒
# the request bytes are identical to a build without tracing.
TRACE_HEADER = "X-Areal-Trace"
TRACE_FIELD = "_trace"  # optional key on pushed sample dicts (streams.py)


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def current_trace() -> Optional[TraceContext]:
    return _CUR_TRACE.get()


@contextmanager
def trace_scope(ctx: Optional[TraceContext]):
    """Adopt ``ctx`` (e.g. extracted from an incoming request) for the
    calling context; ``None`` is a no-op so call sites never branch."""
    if ctx is None:
        yield None
        return
    token = _CUR_TRACE.set(ctx)
    try:
        yield ctx
    finally:
        _CUR_TRACE.reset(token)


@contextmanager
def start_trace(trace_id: Optional[str] = None):
    """Originate a new trace (rollout worker, at prompt admission). With
    telemetry disabled this allocates nothing and yields None — spans
    stay un-traced and inject() stays empty."""
    if not _GLOBAL.enabled:
        yield None
        return
    ctx = TraceContext(trace_id=trace_id or new_trace_id())
    token = _CUR_TRACE.set(ctx)
    try:
        yield ctx
    finally:
        _CUR_TRACE.reset(token)


def _current_parent_ref(worker_ref: str,
                        ctx: TraceContext) -> Optional[str]:
    """The span ref a downstream child should link to: the caller's open
    span if there is one (qualified by this worker's identity), else
    whatever remote parent the context already carried."""
    sid = _CUR_SPAN.get()
    if sid is not None and worker_ref:
        return f"{worker_ref}/{sid}"
    return ctx.parent_span


def inject_headers() -> Dict[str, str]:
    """Trace context → HTTP headers. Empty dict when telemetry is
    disabled or no trace is active, so request bytes are unchanged."""
    ctx = _CUR_TRACE.get()
    if ctx is None or not _GLOBAL.enabled:
        return {}
    parent = _current_parent_ref(_GLOBAL.worker_ref, ctx) or ""
    return {TRACE_HEADER: f"{ctx.trace_id};{parent}"}


def extract_headers(headers) -> Optional[TraceContext]:
    """HTTP headers → TraceContext (None when absent/malformed)."""
    try:
        raw = headers.get(TRACE_HEADER)
    except Exception:  # noqa: BLE001 — header container without .get
        return None
    if not raw:
        return None
    tid, _, parent = str(raw).partition(";")
    if not tid:
        return None
    return TraceContext(trace_id=tid, parent_span=parent or None)


def inject_payload(obj: Any) -> Any:
    """Attach the active trace context to a pushed payload dict under
    ``_trace``. Returns ``obj`` untouched (same object, same bytes on
    the wire) when telemetry is disabled, no trace is active, or the
    payload is not a dict."""
    ctx = _CUR_TRACE.get()
    if ctx is None or not _GLOBAL.enabled or not isinstance(obj, dict):
        return obj
    parent = _current_parent_ref(_GLOBAL.worker_ref, ctx)
    obj[TRACE_FIELD] = TraceContext(ctx.trace_id, parent).as_dict()
    return obj


def extract_payload(obj: Any) -> Optional[TraceContext]:
    """Pop ``_trace`` off a payload dict (backward-compatible: absent
    field → None, payload otherwise untouched)."""
    if not isinstance(obj, dict):
        return None
    d = obj.pop(TRACE_FIELD, None)
    if not isinstance(d, dict):
        return None
    return TraceContext.from_dict(d)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Span:
    name: str
    span_id: int
    parent_id: Optional[int]
    t_start: float  # wall clock (time.time)
    dur_secs: float
    attrs: Dict[str, Any]
    # Sample-lineage tracing: which trace this span belongs to, and (for
    # a local root adopted from another worker) the remote parent's
    # global ref. None/absent for un-traced spans — the jsonl record
    # stays byte-identical to the pre-tracing format for them.
    trace_id: Optional[str] = None
    remote_parent: Optional[str] = None

    def as_dict(self) -> Dict[str, Any]:
        d = {
            "name": self.name, "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t_start": round(self.t_start, 6),
            "dur_secs": round(self.dur_secs, 6),
            "attrs": self.attrs,
        }
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
        if self.remote_parent is not None:
            d["remote_parent"] = self.remote_parent
        return d


class FlightRecorder:
    """Bounded ring of the most recent span/event records, kept OUTSIDE
    the flush-drained span buffer so the last moments before a crash are
    always reconstructible. Dumped to ``flight_<worker>.jsonl`` on
    SIGTERM/uncaught exception (when ``flight_dir`` is configured), on
    operator request (``names.flight_dump_trigger``, mirroring the
    profiler-trigger pattern), or explicitly (manager eviction path)."""

    def __init__(self, maxlen: int = 512):
        self._lock = threading.Lock()
        self._ring: "collections.deque[Dict[str, Any]]" = collections.deque(
            maxlen=maxlen
        )

    def record(self, kind: str, rec: Dict[str, Any]) -> None:
        with self._lock:
            self._ring.append({"kind": kind, **rec})

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def dump(self, path: str, reason: str = "") -> int:
        """Write the ring (oldest first) + a terminal marker record.
        Signal-safe enough: plain buffered writes, no locks held while
        touching the filesystem beyond the snapshot copy."""
        recs = self.snapshot()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
            f.write(json.dumps({
                "kind": "dump", "reason": reason,
                "time": round(time.time(), 6), "n_records": len(recs),
            }) + "\n")
        return len(recs)


class _Histogram:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float]):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # trailing +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def as_dict(self) -> Dict[str, Any]:
        return {
            "buckets": list(self.buckets), "counts": list(self.counts),
            "sum": self.sum, "count": self.count,
        }


class TelemetryRegistry:
    """Thread-safe per-process metric + span store.

    Counters/gauges/histograms are CUMULATIVE — a flush (or a Prometheus
    scrape) never resets them, so scraped counters stay monotonic and
    concurrent exporters cannot race each other's resets. Spans are the
    only drained state: ``snapshot(reset=True)`` hands back the buffered
    spans and clears the buffer (bounded by ``max_spans``; oldest drop
    first so a stalled aggregator cannot OOM a worker).
    """

    def __init__(self, max_spans: int = 4096):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Histogram] = {}
        self._spans: List[Span] = []
        self.max_spans = max_spans
        self.dropped_spans = 0
        # Optional crash-evidence ring (set by Telemetry when enabled):
        # finished spans/events are mirrored here, never drained.
        self.flight: Optional[FlightRecorder] = None

    # ---- metrics ----

    def inc(self, name: str, n: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + n

    def set_gauge(self, name: str, v: float) -> None:
        with self._lock:
            self._gauges[name] = float(v)

    def remove_gauge(self, name: str) -> None:
        """Withdraw a gauge from the exposition entirely. For derived
        gauges whose SUBJECT can disappear (a fleet side with no live
        workers): a frozen last value would lie on the scrape, and
        publishing 0.0 instead would read as a real collapse."""
        with self._lock:
            self._gauges.pop(name, None)

    def observe(self, name: str, v: float,
                buckets: Optional[Sequence[float]] = None) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Histogram(buckets or DEFAULT_BUCKETS)
            h.observe(float(v))

    # ---- spans ----

    def _store_span(self, s: Span) -> None:
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self._spans.pop(0)
                self.dropped_spans += 1
                # First-class drop counter (Prometheus:
                # areal_telemetry_spans_dropped_total) so truncated
                # traces are detectable, not silent. Direct dict write:
                # inc() would re-take the held lock.
                self._counters["telemetry/spans_dropped"] = (
                    self._counters.get("telemetry/spans_dropped", 0.0) + 1
                )
            self._spans.append(s)
        if self.flight is not None:
            self.flight.record("span", s.as_dict())
        # Every span doubles as a duration histogram point, so the
        # aggregate view exists even when span volume forces drops.
        self.observe(f"{s.name}/secs", s.dur_secs)

    @contextmanager
    def span(self, name: str, **attrs):
        sid = next(_span_ids)
        parent = _CUR_SPAN.get()
        trace = _CUR_TRACE.get()
        token = _CUR_SPAN.set(sid)
        t_wall = time.time()
        t0 = time.monotonic()
        try:
            yield attrs  # callers may add attrs["key"] = ... mid-span
        finally:
            _CUR_SPAN.reset(token)
            s = Span(name=name, span_id=sid, parent_id=parent,
                     t_start=t_wall, dur_secs=time.monotonic() - t0,
                     attrs=attrs)
            if trace is not None:
                s.trace_id = trace.trace_id
                if parent is None:
                    # Local root of a distributed trace: link to the
                    # remote span that caused this work.
                    s.remote_parent = trace.parent_span
            self._store_span(s)

    def add_span(self, name: str, t_start: float, dur_secs: float,
                 trace: Optional[TraceContext] = None,
                 parent_id: Optional[int] = None, **attrs) -> int:
        """Record a span whose window was measured by the caller (queue
        waits, per-request shares of a batched decode, terminal
        trained-sample marks). ``t_start`` is wall-clock (time.time).
        Parents under the caller's open span when there is one; a local
        root instead links to the trace's remote parent. Returns the
        span id so callers can chain children off it."""
        sid = next(_span_ids)
        if parent_id is None:
            parent_id = _CUR_SPAN.get()
        s = Span(name=name, span_id=sid, parent_id=parent_id,
                 t_start=t_start, dur_secs=float(dur_secs), attrs=attrs)
        if trace is not None:
            s.trace_id = trace.trace_id
            if parent_id is None:
                s.remote_parent = trace.parent_span
        self._store_span(s)
        return sid

    def event(self, name: str, **attrs) -> None:
        """Point-in-time record (failover fired, 429 backoff, eviction):
        a zero-duration span — it rides the same flush/stitch path and
        lands in the flight ring — under the ACTIVE trace context and
        nested below the caller's open span (if any)."""
        self.add_span(name, time.time(), 0.0, trace=_CUR_TRACE.get(),
                      parent_id=_CUR_SPAN.get(), **attrs)

    # ---- export ----

    def snapshot(self, reset: bool = True) -> Dict[str, Any]:
        with self._lock:
            out = {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "hists": {k: h.as_dict() for k, h in self._hists.items()},
                "spans": [s.as_dict() for s in self._spans],
                "dropped_spans": self.dropped_spans,
            }
            if reset:
                self._spans = []
        return out


# --------------------------------------------------------------------------
# Prometheus rendering
# --------------------------------------------------------------------------


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    s = "".join(out)
    return ("_" + s) if s and s[0].isdigit() else (s or "_")


def _metric_key_labels(key: str):
    """Split an optional inline label suffix off a registry metric key:
    ``supervisor/restarts{worker_kind=rollout}`` → (``supervisor/restarts``,
    {"worker_kind": "rollout"}). Lets call sites emit one metric FAMILY
    with several label values (the Prometheus idiom) through the flat
    string-keyed registry; keys without a suffix return (key, None)."""
    if not key.endswith("}"):
        return key, None
    base, brace, rest = key.partition("{")
    if not brace:
        return key, None
    labels: Dict[str, str] = {}
    for part in rest[:-1].split(","):
        k, eq, v = part.partition("=")
        if eq:
            labels[k.strip()] = v.strip().strip('"')
    return base, (labels or None)


def _prom_labels(labels: Optional[Dict[str, str]],
                 extra: Optional[Dict[str, str]] = None) -> str:
    merged = {**(labels or {}), **(extra or {})}
    if not merged:
        return ""

    def esc(v) -> str:
        # Exposition-format escaping for label values: backslash FIRST
        # (or it would double-escape the others), then quote, then
        # newline — an unescaped newline splits the sample line in two
        # and the scraper rejects the whole exposition.
        return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    inner = ",".join(
        f'{_prom_name(k)}="{esc(v)}"' for k, v in sorted(merged.items())
    )
    return "{" + inner + "}"


def render_prometheus(
    snapshot: Optional[Dict[str, Any]] = None,
    extra_gauges: Optional[Dict[str, float]] = None,
    labels: Optional[Dict[str, str]] = None,
    prefix: str = "areal",
) -> str:
    """Registry snapshot (+ ad-hoc gauges) → Prometheus exposition text.

    ``extra_gauges`` lets HTTP workers export live object state (queue
    sizes, versions) without mirroring it into the registry first. Values
    that are None or non-numeric are skipped.
    """
    lines: List[str] = []
    snapshot = snapshot or {}
    lab = _prom_labels(labels)
    typed = set()  # one # TYPE line per family, even with inline labels

    def emit(name: str, kind: str, value: float,
             label_str: Optional[str] = None) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name}{lab if label_str is None else label_str} "
                     f"{float(value):g}")

    emitted = set()
    for k, v in sorted((extra_gauges or {}).items()):
        if isinstance(v, bool):
            v = float(v)
        if not isinstance(v, (int, float)):
            continue  # None / strings have no Prometheus representation
        name = f"{prefix}_{_prom_name(k)}"
        emitted.add(name)
        emit(name, "gauge", float(v))
    for k, v in sorted(snapshot.get("gauges", {}).items()):
        base, kl = _metric_key_labels(k)
        name = f"{prefix}_{_prom_name(base)}"
        if name in emitted and kl is None:
            # extra_gauges win: a registry gauge sanitizing to the same
            # name (e.g. genserver/weight_version vs the live-state
            # gauge) must not produce a duplicate Prometheus sample.
            continue
        emit(name, "gauge", v,
             label_str=_prom_labels(labels, kl) if kl else None)
    for k, v in sorted(snapshot.get("counters", {}).items()):
        base, kl = _metric_key_labels(k)
        emit(f"{prefix}_{_prom_name(base)}_total", "counter", v,
             label_str=_prom_labels(labels, kl) if kl else None)
    for k, h in sorted(snapshot.get("hists", {}).items()):
        kbase, kl = _metric_key_labels(k)
        base = f"{prefix}_{_prom_name(kbase)}"
        if base not in typed:
            typed.add(base)
            lines.append(f"# TYPE {base} histogram")
        merged = {**(labels or {}), **(kl or {})}
        hlab = _prom_labels(merged) if merged else ""
        cum = 0
        for b, c in zip(h["buckets"], h["counts"]):
            cum += c
            lstr = _prom_labels(merged, {"le": f"{float(b):g}"})
            lines.append(f"{base}_bucket{lstr} {cum}")
        cum += h["counts"][-1]
        lines.append(f"{base}_bucket{_prom_labels(merged, {'le': '+Inf'})} "
                     f"{cum}")
        lines.append(f"{base}_sum{hlab} {h['sum']:g}")
        lines.append(f"{base}_count{hlab} {h['count']}")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------
# pusher (worker side)
# --------------------------------------------------------------------------


class TelemetryPusher:
    """Flush a registry to the master's aggregator on an interval.

    Discovery is lazy and non-fatal: the connection is made the first
    time ``names.telemetry_aggregator`` resolves; until then flushes are
    skipped (spans stay buffered in the registry, bounded)."""

    def __init__(self, registry: TelemetryRegistry, experiment: str,
                 trial: str, worker_kind: str, worker_index: int = 0,
                 flush_interval_secs: float = 2.0):
        self.registry = registry
        self.worker_kind = worker_kind
        self.worker_index = worker_index
        self.flush_interval_secs = flush_interval_secs
        self._key = names.telemetry_aggregator(experiment, trial)
        self._flight_key = names.flight_dump_trigger(experiment, trial)
        self._flight_nonce: Optional[str] = None  # last handled trigger
        self._t_start_wall = time.time()  # gates stale-trigger replay
        self._sock: Optional[socket.socket] = None
        self._flush_lock = threading.Lock()  # socket use is single-file
        # The unsent snapshot (one framed message) and how much of it
        # went out on the current connection.
        self._pending: Optional[memoryview] = None
        self._sent = 0
        self._closing = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"telemetry-push-{worker_kind}{worker_index}",
        )
        self._thread.start()

    def _connect(self) -> bool:
        if self._sock is not None:
            return True
        try:
            addr = name_resolve.get(self._key)
        except name_resolve.NameEntryNotFoundError:  # aggregator not up yet
            return False
        try:
            s = socket.create_connection(network.parse_tcp(addr),
                                         timeout=CONNECT_TIMEOUT_SECS)
        except OSError:  # gone, or not listening yet
            return False
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.setblocking(False)
        self._sock = s
        return True

    def _drop(self) -> None:
        """Forget a broken connection: the pending snapshot goes again,
        whole, on the next one (the aggregator drops a message cut off)."""
        if self._sock is not None:
            self._sock.close()
            self._sock = None
        self._sent = 0

    def _send_pending(self) -> bool:
        """Hand the pending message's unsent bytes to the kernel without
        blocking; True once all of it went out."""
        while self._sent < len(self._pending):
            try:
                n = self._sock.send(self._pending[self._sent:])
            except (BlockingIOError, InterruptedError):
                return False  # the send buffer is full: backlogged
            except OSError:
                self._drop()
                return False
            self._sent += n
        self._pending, self._sent = None, 0
        return True

    def flush(self) -> bool:
        """One snapshot push; returns False when no aggregator is known or
        it is backlogged. A snapshot that cannot be sent is kept (and the
        registry is NOT drained again until it goes out), so a stalled
        aggregator loses no spans — exactly the incident window an
        operator will want to see. The registry's bounded span buffer is
        the backstop if the outage outlasts ``max_buffered_spans``."""
        from areal_tpu_torch.system.frames import _encode

        with self._flush_lock:
            if not self._connect():
                return False
            if self._pending is not None and not self._send_pending():
                return False  # still backlogged; nothing drained
            payload = pickle.dumps({
                "worker_kind": self.worker_kind,
                "worker_index": self.worker_index,
                "time": time.time(),
                **self.registry.snapshot(reset=True),
            })
            self._pending = memoryview(
                b"".join(bytes(m) for m in _encode([payload])))
            return self._send_pending()

    def check_flight_trigger(self) -> Optional[str]:
        """On-demand flight dump (profiler-trigger pattern, but fan-out:
        the flag is NOT consumed — every worker acts on it once, keyed by
        its nonce, so one trigger dumps the whole fleet's rings). Returns
        the written path when this call dumped."""
        if self.registry.flight is None:
            return None
        try:
            raw = name_resolve.get(self._flight_key)
        except Exception:  # noqa: BLE001 — no trigger pending
            return None
        try:
            req = json.loads(raw)
            nonce = str(req.get("nonce", ""))
            if not nonce or nonce == self._flight_nonce:
                return None
            self._flight_nonce = nonce
            if float(req.get("time", 0.0)) < self._t_start_wall:
                # The flag predates this worker (it is deliberately not
                # consumed so the whole fleet can act on it) — a freshly
                # (re)started worker must not replay it and overwrite
                # the incident evidence with its near-empty ring.
                return None
            path = os.path.join(
                req["dir"],
                f"flight_{self.worker_kind}{self.worker_index}.jsonl",
            )
            n = self.registry.flight.dump(path, reason=f"trigger:{nonce}")
            logger.info(f"flight dump ({n} records) -> {path}")
            return path
        except Exception as e:  # noqa: BLE001 — telemetry never kills
            logger.warning(f"flight dump trigger failed: {e}")
            return None

    def _loop(self) -> None:
        while not self._closing.wait(self.flush_interval_secs):
            try:
                self.flush()
                self.check_flight_trigger()
            except Exception as e:  # noqa: BLE001 — telemetry never kills
                logger.warning(f"telemetry flush failed: {e}")

    def close(self) -> None:
        # Stop the flush thread BEFORE touching the socket from this
        # thread. If the join times out (thread wedged mid-flush), leave
        # the socket to the daemon thread rather than race it — the
        # process is exiting anyway.
        self._closing.set()
        self._thread.join(timeout=2)
        if self._thread.is_alive():
            return
        try:
            self.flush()  # final snapshot (best-effort)
        except Exception:  # noqa: BLE001
            pass
        if self._sock is not None:
            self._sock.close()
            self._sock = None


# --------------------------------------------------------------------------
# trace stitching (master side)
# --------------------------------------------------------------------------

# prompt→trained latencies live on a longer scale than RPCs.
E2E_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
               120.0, 300.0, 600.0)

# Span name → stage of the measured staleness decomposition. The
# "train" stage is the triggering terminal span alone (a group's other
# samples have their own terminals), and "train_wait" is derived
# (terminal start − rollout end), so neither lives in this map.
STAGE_OF_SPAN = {
    "rollout/gate": "gate",
    "rollout/generate": "generate",
    "genserver/queue_wait": "queue",
}
TERMINAL_SPAN = "trainer/train_sample"
TRACE_STAGES = ("generate", "queue", "gate", "train_wait", "train")


@dataclasses.dataclass
class _TraceEntry:
    spans: List[Dict] = dataclasses.field(default_factory=list)
    stitched: bool = False  # at least one terminal already processed


class TraceStitcher:
    """Joins spans by trace_id across workers into end-to-end sample
    timelines.

    Fed from the aggregator's ingest path; spans carrying a ``trace_id``
    are buffered per trace (bounded LRU — a trace whose terminal span
    never arrives, e.g. an abandoned rollout, eventually falls off and
    is counted in ``trace/unstitched_evicted``; traces that already
    stitched age out silently). A TERMINAL span (``trainer/train_sample``)
    schedules a stitch after ``grace_secs`` — sibling workers flush on
    their own ``flush_interval_secs`` cadence, so stitching immediately
    would record a truncated timeline whenever the trainer's snapshot
    outruns the rollout worker's. ``tick()`` (called from the
    aggregator's ingest loop, and with ``force=True`` on close) performs
    the due stitches: one record appended to ``traces.jsonl`` PER
    TRAINED SAMPLE and the derived first-class metrics — prompt→trained
    e2e latency and the per-stage generate/queue/gate/train-wait/train
    breakdown, one observation per trained sample — observed into
    ``registry`` (exported by the aggregator's /metrics).
    ``trace/stitched`` counts unique completed traces (prompts);
    per-sample multiplicity is visible as the e2e histogram count."""

    def __init__(self, traces_path: Optional[str],
                 registry: Optional[TelemetryRegistry] = None,
                 max_traces: int = 1024, grace_secs: float = 5.0):
        self.registry = registry or TelemetryRegistry()
        self.max_traces = max_traces
        self.grace_secs = grace_secs
        self._lock = threading.Lock()
        self._traces: "collections.OrderedDict[str, _TraceEntry]" = (
            collections.OrderedDict()
        )
        # (due_monotonic, trace_id, terminal span) awaiting their grace.
        self._deferred: List[Tuple[float, str, Dict]] = []
        self._file = None
        if traces_path:
            os.makedirs(os.path.dirname(traces_path) or ".", exist_ok=True)
            self._file = open(traces_path, "a", buffering=1)

    def feed(self, worker: str, spans: Sequence[Dict[str, Any]]) -> None:
        now = time.monotonic()
        with self._lock:
            for s in spans:
                tid = s.get("trace_id")
                if not tid:
                    continue
                rec = {**s, "worker": worker}
                entry = self._traces.get(tid)
                if entry is None:
                    entry = self._traces[tid] = _TraceEntry()
                self._traces.move_to_end(tid)
                entry.spans.append(rec)
                if s.get("name") == TERMINAL_SPAN:
                    self._deferred.append(
                        (now + self.grace_secs, tid, rec)
                    )
            scanned = 0
            while (len(self._traces) > self.max_traces
                   and scanned <= self.max_traces):
                tid, old = self._traces.popitem(last=False)
                scanned += 1
                if not old.stitched and any(
                    d[1] == tid for d in self._deferred
                ):
                    # Terminal already arrived; its stitch is merely
                    # waiting out the grace window — evicting now would
                    # silently drop a COMPLETED trace. Keep it (at MRU)
                    # until tick() stitches it.
                    self._traces[tid] = old
                    continue
                if not old.stitched:
                    # Only a trace that never saw a terminal span is a
                    # loss signal (abandoned rollout / dropped spans);
                    # completed traces aging out is normal turnover.
                    self.registry.inc("trace/unstitched_evicted")
        self.tick()

    def tick(self, force: bool = False) -> None:
        """Stitch every deferred terminal whose grace elapsed (all of
        them with ``force=True`` — shutdown must not drop stragglers)."""
        now = time.monotonic()
        with self._lock:
            due = [d for d in self._deferred if force or d[0] <= now]
            if not due:
                return
            self._deferred = [d for d in self._deferred
                              if not (force or d[0] <= now)]
        for _, tid, term in due:
            self._stitch(tid, term)

    def _stitch(self, trace_id: str, terminal: Dict[str, Any]) -> None:
        with self._lock:
            entry = self._traces.get(trace_id)
            if entry is None:
                return  # evicted before its grace elapsed
            first = not entry.stitched
            entry.stitched = True
            spans = sorted(entry.spans, key=lambda s: s["t_start"])
        root_start = min(s["t_start"] for s in spans)
        e2e = max(terminal["t_start"] + terminal["dur_secs"] - root_start,
                  0.0)
        stages = {k: 0.0 for k in TRACE_STAGES}
        # "train" is THIS sample's terminal alone — a group's sibling
        # samples stitch separately with their own terminals.
        stages["train"] = terminal["dur_secs"]
        rollout_end = None
        for s in spans:
            stage = STAGE_OF_SPAN.get(s["name"])
            if stage:
                stages[stage] += s["dur_secs"]
            if s["name"] == "rollout/rollout":
                rollout_end = s["t_start"] + s["dur_secs"]
        if rollout_end is not None:
            # Time between the sample leaving the rollout worker and the
            # trainer step that consumed it: the stream + buffer + MFC
            # gate wait — the part of staleness training speed controls.
            stages["train_wait"] = max(
                terminal["t_start"] - rollout_end, 0.0
            )
        r = self.registry
        if first:
            r.inc("trace/stitched")  # unique completed traces
        r.observe("trace/e2e_secs", e2e, buckets=E2E_BUCKETS)
        for k, v in stages.items():
            r.observe(f"trace/stage_{k}_secs", v, buckets=E2E_BUCKETS)
        if self._file is not None:
            self._file.write(json.dumps({
                "trace_id": trace_id,
                "sample_id": terminal.get("attrs", {}).get("sample_id"),
                "weight_version": terminal.get("attrs", {})
                                          .get("weight_version"),
                "t_start": round(root_start, 6),
                "e2e_secs": round(e2e, 6),
                "stages": {k: round(v, 6) for k, v in stages.items()},
                "workers": sorted({s["worker"] for s in spans}),
                "spans": spans,
            }) + "\n")

    def recent_trace_ids(self, n: int = 8) -> List[str]:
        """The most recently touched trace ids (newest last) — the
        sentinel pins these into alert evidence bundles so the operator
        can replay the samples that were in flight when an anomaly
        fired."""
        with self._lock:
            return list(self._traces)[-max(int(n), 0):]

    def close(self) -> None:
        self.tick(force=True)
        if self._file is not None:
            self._file.close()
            self._file = None


# --------------------------------------------------------------------------
# aggregator (master side)
# --------------------------------------------------------------------------


class TelemetryAggregator:
    """Merge of per-worker snapshots keyed by
    ``worker_kind:worker_index``; every received snapshot is appended to
    ``telemetry.jsonl`` and its scalars mirrored into ``metric_writer``
    (tensorboard) as ``telemetry/{worker}/{metric}``."""

    def __init__(self, experiment: str, trial: str,
                 jsonl_path: Optional[str] = None,
                 metric_writer=None, http_port: int = 0,
                 traces_path: Optional[str] = None,
                 stitch_grace_secs: float = 5.0,
                 sentinel=None, goodput=None):
        from areal_tpu_torch.system.frames import FrameServer

        self.jsonl_path = jsonl_path
        # Optional training-health sentinel (system/sentinel.Sentinel):
        # fed every ingested snapshot's gauges/counters and ticked from
        # the ingest loop — it owns no thread of its own. None (the
        # default) leaves ingest and the merged scrape bit-identical.
        self.sentinel = sentinel
        # Optional fleet-goodput stitcher (system/goodput.FleetGoodput):
        # fed every ingested snapshot's ledger counters; its derived
        # gauges join the merged scrape as the "fleet" pseudo-worker and
        # land in telemetry.jsonl on a slow cadence. None (the default)
        # leaves ingest and the scrape bit-identical.
        self.goodput = goodput
        self._last_fleet_rec = 0.0
        self._writer = metric_writer
        self._seq = 0
        self.state: Dict[str, Dict[str, Any]] = {}
        self._state_lock = threading.Lock()
        self._experiment, self._trial = experiment, trial
        # Sample-lineage stitching: spans with a trace_id are joined into
        # traces.jsonl (default: next to telemetry.jsonl) and the derived
        # e2e/stage histograms live in the aggregator's OWN registry,
        # exported under worker_kind="aggregator" on /metrics.
        if traces_path is None and jsonl_path:
            traces_path = os.path.join(
                os.path.dirname(jsonl_path) or ".", "traces.jsonl"
            )
        self.traces_path = traces_path
        self.stitcher = TraceStitcher(traces_path,
                                      grace_secs=stitch_grace_secs)
        if self.sentinel is not None \
                and getattr(self.sentinel, "stitcher", None) is None:
            # Evidence bundles pin recent stitched trace ids.
            self.sentinel.stitcher = self.stitcher
        self._server = FrameServer(INGEST_TIMEOUT_SECS)
        self._key = names.telemetry_aggregator(experiment, trial)
        name_resolve.add(self._key, self._server.endpoint, replace=True)
        self._jsonl_file = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._jsonl_file = open(jsonl_path, "a", buffering=1)
        self._closing = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="telemetry-aggregate"
        )
        self._thread.start()
        self._http = None
        if http_port:
            self._start_http(http_port)
        logger.info(f"telemetry aggregator up (jsonl={jsonl_path})")

    # ---- ingest ----

    def _ingest(self, payload: Dict[str, Any]) -> None:
        worker = f"{payload.get('worker_kind', '?')}:" \
                 f"{payload.get('worker_index', 0)}"
        self._derive_hbm_utilization(payload)
        with self._state_lock:
            prev = self.state.get(worker)
            spans = payload.get("spans", [])
            merged = {
                "time": payload.get("time"),
                "counters": payload.get("counters", {}),
                "gauges": payload.get("gauges", {}),
                "hists": payload.get("hists", {}),
                "n_spans": (prev["n_spans"] if prev else 0) + len(spans),
                "last_spans": spans or (prev["last_spans"] if prev else []),
            }
            self.state[worker] = merged
            self._seq += 1
            seq = self._seq
        self.stitcher.feed(worker, spans)
        if self.sentinel is not None:
            try:
                # Full "kind:index" identity: same-kind workers must be
                # DISTINCT sources or cross-worker agg (max/mean/sum)
                # collapses to whichever worker pushed last.
                self.sentinel.feed(
                    worker,
                    payload.get("gauges", {}),
                    payload.get("counters", {}),
                )
            except Exception as e:  # noqa: BLE001 — watcher never kills
                logger.warning(f"sentinel feed failed: {e}")
        if self.goodput is not None:
            try:
                fg = self.goodput.update(worker,
                                         payload.get("counters", {}))
                if fg:
                    if self.sentinel is not None:
                        # Fleet goodput is derived HERE, not flushed by
                        # any worker — feed it to the sentinel under its
                        # own source identity so goodput_collapse-style
                        # rules see the series. UNLABELED keys only: the
                        # sentinel folds {side=...} variants into the
                        # same family, and averaging the overall with
                        # the per-side splits would mis-weight the sides
                        # (and step-change when a side appears/expires).
                        self.sentinel.feed("fleet:0", {
                            k: v for k, v in fg.items() if "{" not in k
                        })
                    now = time.monotonic()
                    if self._jsonl_file is not None \
                            and now - self._last_fleet_rec > 5.0:
                        # Slow-cadence fleet record so telemetry.jsonl
                        # carries the stitched number without doubling
                        # the per-snapshot volume.
                        self._last_fleet_rec = now
                        # Same record shape as the per-worker snapshots
                        # so jsonl consumers never special-case the
                        # fleet row.
                        self._jsonl_file.write(json.dumps({
                            "worker": "fleet:0", "time": time.time(),
                            "counters": {}, "gauges": fg, "spans": [],
                            "dropped_spans": 0, "hists": {},
                        }) + "\n")
            except Exception as e:  # noqa: BLE001 — derived, never kills
                logger.warning(f"fleet goodput update failed: {e}")
        if self._jsonl_file is not None:
            rec = {"worker": worker, **{
                k: payload.get(k) for k in
                ("time", "counters", "gauges", "spans", "dropped_spans")
            }, "hists": payload.get("hists", {})}
            self._jsonl_file.write(json.dumps(rec) + "\n")
        if self._writer is not None:
            flat = {
                **{f"telemetry/{worker}/{k}": v
                   for k, v in merged["counters"].items()},
                **{f"telemetry/{worker}/{k}": v
                   for k, v in merged["gauges"].items()},
            }
            if flat:
                try:
                    self._writer.write(flat, seq)
                except Exception:  # noqa: BLE001 — TB is best-effort
                    pass

    @staticmethod
    def _derive_hbm_utilization(payload: Dict[str, Any]) -> None:
        """Inject per-device ``hbm/utilization{device=i}`` =
        bytes_in_use / limit_bytes into a snapshot that carries both
        memwatch gauges (system/memwatch.py) — derived HERE because only
        the aggregator-side series feeds the ``hbm_pressure`` sentinel
        rule as a ready-made ratio. No hbm gauges in the payload ⇒ no
        mutation at all: with the observatory disabled the merged scrape
        stays bit-identical."""
        gauges = payload.get("gauges")
        if not gauges:
            return
        limits = {}
        for k, v in gauges.items():
            base, labels = _metric_key_labels(k)
            if base == "hbm/limit_bytes" and labels \
                    and isinstance(v, (int, float)) and v > 0:
                limits[labels.get("device")] = float(v)
        if not limits:
            return
        derived = {}
        for k, v in gauges.items():
            base, labels = _metric_key_labels(k)
            dev = labels.get("device") if labels else None
            if base == "hbm/bytes_in_use" and dev in limits \
                    and isinstance(v, (int, float)):
                derived[f"hbm/utilization{{device={dev}}}"] = \
                    float(v) / limits[dev]
        gauges.update(derived)

    def _loop(self) -> None:
        while not self._closing.is_set():
            try:
                got = self._server.poll(100)
                if got is not None:
                    self._ingest(pickle.loads(got[1][0]))
                # Deferred stitches come due on wall time, not on new
                # snapshots — run them on idle poll timeouts too. Same
                # for the sentinel: absence-of-signal rules and `for:`
                # windows elapse without any snapshot arriving.
                self.stitcher.tick()
                if self.sentinel is not None:
                    self.sentinel.tick()
            except Exception as e:  # noqa: BLE001 — aggregator must survive
                if not self._closing.is_set():
                    logger.warning(f"telemetry ingest failed: {e}")

    def set_metric_writer(self, writer) -> None:
        """Attach (or swap) the tensorboard mirror after construction —
        the master builds its MetricWriter later in setup."""
        self._writer = writer

    # ---- views ----

    def merged(self) -> Dict[str, Dict[str, Any]]:
        with self._state_lock:
            return {k: dict(v) for k, v in self.state.items()}

    def render_prometheus(self) -> str:
        """Merged fleet state as ONE valid exposition: samples of the same
        metric family (e.g. two rollout workers' gauges) are grouped under
        a single ``# TYPE`` line — concatenating per-worker renderings
        would emit duplicate TYPE lines, which expfmt-based consumers
        (promtool etc.) reject wholesale."""
        fams: Dict[str, Dict[str, Any]] = {}

        def add(name: str, kind: str, line: str) -> None:
            fams.setdefault(name, {"kind": kind, "lines": []})["lines"] \
                .append(line)

        rows = dict(self.merged())
        # Derived trace metrics (prompt→trained e2e + stage breakdown)
        # join the fleet exposition as their own pseudo-worker.
        stitched = self.stitcher.registry.snapshot(reset=False)
        if stitched["counters"] or stitched["hists"]:
            rows["aggregator:0"] = stitched
        if self.sentinel is not None:
            # areal_alerts_total{rule,severity} + areal_alert_active join
            # the merged exposition as the sentinel pseudo-worker.
            sn = self.sentinel.registry.snapshot(reset=False)
            if sn["counters"] or sn["gauges"]:
                rows["sentinel:0"] = sn
        goodput = getattr(self, "goodput", None)  # duck-typed in tests
        if goodput is not None:
            # areal_fleet_goodput{side=...} joins the merged exposition
            # as the fleet pseudo-worker (system/goodput.FleetGoodput).
            fg = goodput.registry.snapshot(reset=False)
            if fg["gauges"]:
                rows["fleet:0"] = fg
        # Fleet rollups for the compile & HBM observatory: the total
        # compile seconds burned across every worker, and the worst HBM
        # utilization per worker kind (the capacity-planning numbers an
        # operator wants without a PromQL layer). Appended ONLY when the
        # source series exist — with compile_watch disabled nothing is
        # added and the scrape stays bit-identical.
        compile_secs = 0.0
        any_compile = False
        hbm_util: Dict[str, float] = {}
        for worker, st in rows.items():
            kind = worker.partition(":")[0]
            for k, v in st.get("counters", {}).items():
                if _metric_key_labels(k)[0] == "compile/secs":
                    compile_secs += float(v)
                    any_compile = True
            for k, v in st.get("gauges", {}).items():
                if _metric_key_labels(k)[0] == "hbm/utilization":
                    hbm_util[kind] = max(hbm_util.get(kind, 0.0), float(v))
        if any_compile:
            ls = _prom_labels({"worker_kind": "fleet", "worker_index": "0"})
            add("areal_compile_secs_total", "counter",
                f"areal_compile_secs_total{ls} {compile_secs:g}")
        for kind in sorted(hbm_util):
            ls = _prom_labels({"worker_kind": kind, "worker_index": "fleet"})
            add("areal_hbm_utilization", "gauge",
                f"areal_hbm_utilization{ls} {hbm_util[kind]:g}")
        for worker, st in sorted(rows.items()):
            kind, _, idx = worker.partition(":")
            labels = {"worker_kind": kind, "worker_index": idx}
            lab = _prom_labels(labels)
            for k, v in sorted(st["gauges"].items()):
                kb, kl = _metric_key_labels(k)
                n = f"areal_{_prom_name(kb)}"
                ls = _prom_labels(labels, kl) if kl else lab
                add(n, "gauge", f"{n}{ls} {float(v):g}")
            for k, v in sorted(st["counters"].items()):
                kb, kl = _metric_key_labels(k)
                n = f"areal_{_prom_name(kb)}_total"
                ls = _prom_labels(labels, kl) if kl else lab
                add(n, "counter", f"{n}{ls} {float(v):g}")
            for k, h in sorted(st["hists"].items()):
                kb, kl = _metric_key_labels(k)
                base = f"areal_{_prom_name(kb)}"
                hlabels = {**labels, **(kl or {})}
                hlab = _prom_labels(hlabels)
                cum = 0
                for b, c in zip(h["buckets"], h["counts"]):
                    cum += c
                    ls = _prom_labels(hlabels, {"le": f"{float(b):g}"})
                    add(base, "histogram", f"{base}_bucket{ls} {cum}")
                cum += h["counts"][-1]
                ls = _prom_labels(hlabels, {"le": "+Inf"})
                add(base, "histogram", f"{base}_bucket{ls} {cum}")
                add(base, "histogram", f"{base}_sum{hlab} {h['sum']:g}")
                add(base, "histogram", f"{base}_count{hlab} {h['count']}")
        if not fams:
            return "# no telemetry received yet\n"
        out: List[str] = []
        for name in sorted(fams):
            out.append(f"# TYPE {name} {fams[name]['kind']}")
            out.extend(fams[name]["lines"])
        return "\n".join(out) + "\n"

    # ---- optional unified /metrics over plain http ----

    def _start_http(self, port: int) -> None:
        import http.server

        agg = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = agg.render_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # noqa: D102 — silence stdlib logs
                pass

        self._http = http.server.ThreadingHTTPServer(
            (network.bind_addr(), port), Handler
        )
        threading.Thread(target=self._http.serve_forever, daemon=True,
                         name="telemetry-http").start()
        # Advertise the merged endpoint so tools can find it without
        # knowing the port.
        self._http_key = names.telemetry_http(self._experiment, self._trial)
        name_resolve.add(
            self._http_key,
            f"http://{network.gethostip()}:{port}", replace=True,
        )

    def close(self) -> None:
        # Stop the ingest thread BEFORE this thread touches the server
        # for the final drain. A wedged ingest thread (slow tensorboard
        # or NFS write) keeps the server — skip the drain rather than
        # race a live poll.
        self._closing.set()
        self._thread.join(timeout=2)
        try:
            name_resolve.delete(self._key)
        except Exception:  # noqa: BLE001 — already gone / repo reset
            pass
        if not self._thread.is_alive():
            # One last drain so snapshots pushed during shutdown land.
            try:
                while (got := self._server.poll(50)) is not None:
                    self._ingest(pickle.loads(got[1][0]))
            except Exception:  # noqa: BLE001
                pass
            self._server.close()
        if self._http is not None:
            try:
                name_resolve.delete(self._http_key)
            except Exception:  # noqa: BLE001 — already gone / repo reset
                pass
            self._http.shutdown()
            self._http.server_close()
        if self._jsonl_file is not None:
            self._jsonl_file.close()
        self.stitcher.close()
        if self.sentinel is not None:
            self.sentinel.close()


# --------------------------------------------------------------------------
# process-global facade
# --------------------------------------------------------------------------


class _NullSpanCtx:
    """Reusable no-op span context (allocation-free disabled path)."""

    _attrs: Dict[str, Any] = {}

    def __enter__(self):
        return {}

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpanCtx()

# Live enabled Telemetry instances in this process (the gen-fleet process
# hosts several) — the crash hooks dump every ring at once.
_LIVE: "weakref.WeakSet" = weakref.WeakSet()
_EXCEPTHOOK_INSTALLED = False
_SIGTERM_INSTALLED = False


def _dump_all_flight(reason: str) -> List[str]:
    paths = []
    for t in list(_LIVE):
        p = t.flight_dump(reason=reason)
        if p:
            paths.append(p)
    return paths


def _install_crash_hooks() -> None:
    """Chain a SIGTERM handler + sys.excepthook that dump every live
    flight ring before the process dies. Installed only when a
    ``flight_dir`` is configured — test processes and disabled runs never
    have their signal disposition touched. The two halves latch
    separately: a first install off the main thread (where
    ``signal.signal`` raises) still gets excepthook coverage, and a later
    main-thread install retries the signal half."""
    global _EXCEPTHOOK_INSTALLED, _SIGTERM_INSTALLED
    if not _EXCEPTHOOK_INSTALLED:
        _EXCEPTHOOK_INSTALLED = True
        prev_hook = sys.excepthook

        def hook(tp, value, tb):
            try:
                _dump_all_flight(f"uncaught:{tp.__name__}: {value}")
            except Exception:  # noqa: BLE001 — never mask the real crash
                pass
            prev_hook(tp, value, tb)

        sys.excepthook = hook
    if not _SIGTERM_INSTALLED:
        try:
            prev_term = signal.getsignal(signal.SIGTERM)

            def on_term(signum, frame):
                try:
                    _dump_all_flight("sigterm")
                except Exception:  # noqa: BLE001
                    pass
                if callable(prev_term):
                    prev_term(signum, frame)
                elif prev_term == signal.SIG_IGN:
                    # The process deliberately ignored SIGTERM before;
                    # dumping must not turn an ignored signal fatal.
                    return
                else:
                    # Restore the default disposition and re-deliver so
                    # the exit status still says "killed by SIGTERM".
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signal.SIGTERM)

            signal.signal(signal.SIGTERM, on_term)
            _SIGTERM_INSTALLED = True
        except ValueError:
            # Off the main thread: excepthook coverage only; a later
            # main-thread Telemetry construction retries this half.
            pass


class Telemetry:
    """A (registry, pusher) bundle — the unit each worker owns.

    The gen-fleet process hosts generation servers AND the manager in one
    process, so they each construct their own instance (distinct
    ``worker_kind`` keys at the aggregator) rather than sharing the
    process-global one."""

    def __init__(self, experiment: str, trial: str, worker_kind: str,
                 worker_index: int = 0, cfg: Optional["TelemetryConfig"] = None,
                 push: bool = True):
        from areal_tpu_torch.api.train_config import TelemetryConfig

        cfg = cfg or TelemetryConfig(enabled=True)
        self.cfg = cfg
        self.worker_kind = worker_kind
        self.worker_index = worker_index
        # Global span-ref prefix for cross-worker parent links: matches
        # the key the aggregator files this worker's spans under.
        self.worker_ref = f"{worker_kind}:{worker_index}"
        self.registry = TelemetryRegistry(max_spans=cfg.max_buffered_spans)
        if getattr(cfg, "flight_recorder_len", 0) > 0:
            self.registry.flight = FlightRecorder(cfg.flight_recorder_len)
        self.flight_dir = getattr(cfg, "flight_dir", None)
        _LIVE.add(self)
        if self.flight_dir and self.registry.flight is not None:
            _install_crash_hooks()
        self.pusher = (
            TelemetryPusher(
                self.registry, experiment, trial, worker_kind, worker_index,
                flush_interval_secs=cfg.flush_interval_secs,
            ) if push else None
        )

    enabled = True

    def inc(self, name: str, n: float = 1.0) -> None:
        self.registry.inc(name, n)

    def set_gauge(self, name: str, v: float) -> None:
        self.registry.set_gauge(name, v)

    def observe(self, name: str, v: float, buckets=None) -> None:
        self.registry.observe(name, v, buckets)

    def span(self, name: str, **attrs):
        return self.registry.span(name, **attrs)

    def add_span(self, name: str, t_start: float, dur_secs: float,
                 trace: Optional[TraceContext] = None, **attrs) -> int:
        return self.registry.add_span(name, t_start, dur_secs,
                                      trace=trace, **attrs)

    def event(self, name: str, **attrs) -> None:
        self.registry.event(name, **attrs)

    def flight_dump(self, out_dir: Optional[str] = None,
                    reason: str = "") -> Optional[str]:
        """Dump this worker's flight ring to
        ``<dir>/flight_<kind><index>.jsonl``; None when no ring or no
        directory is configured (never raises — crash-path safe)."""
        d = out_dir or self.flight_dir
        if d is None or self.registry.flight is None:
            return None
        path = os.path.join(
            d, f"flight_{self.worker_kind}{self.worker_index}.jsonl"
        )
        try:
            self.registry.flight.dump(path, reason=reason)
        except Exception as e:  # noqa: BLE001 — evidence is best-effort
            logger.warning(f"flight dump failed: {e}")
            return None
        return path

    def snapshot(self, reset: bool = False) -> Dict[str, Any]:
        return self.registry.snapshot(reset=reset)

    def close(self) -> None:
        if self.pusher is not None:
            self.pusher.close()
            self.pusher = None
        _LIVE.discard(self)


class _NullTelemetry:
    """Shared disabled sink: no sockets, no threads, no span objects."""

    enabled = False
    registry = None
    pusher = None
    worker_ref = ""
    flight_dir = None

    def inc(self, name: str, n: float = 1.0) -> None:
        pass

    def set_gauge(self, name: str, v: float) -> None:
        pass

    def observe(self, name: str, v: float, buckets=None) -> None:
        pass

    def span(self, name: str, **attrs):
        return _NULL_SPAN

    def add_span(self, name: str, t_start: float, dur_secs: float,
                 trace=None, **attrs) -> int:
        return 0

    def event(self, name: str, **attrs) -> None:
        pass

    def flight_dump(self, out_dir=None, reason: str = "") -> Optional[str]:
        return None

    def snapshot(self, reset: bool = False) -> Dict[str, Any]:
        return {"counters": {}, "gauges": {}, "hists": {}, "spans": [],
                "dropped_spans": 0}

    def close(self) -> None:
        pass


NULL = _NullTelemetry()
_GLOBAL: Any = NULL


def configure(experiment: str, trial: str, worker_kind: str,
              worker_index: int = 0, cfg=None, push: bool = True):
    """Install the process-global telemetry sink. A disabled (or absent)
    config keeps the null sink — callers never need to re-check."""
    global _GLOBAL
    if cfg is not None and not cfg.enabled:
        return NULL
    if _GLOBAL is not NULL:
        _GLOBAL.close()
    _GLOBAL = Telemetry(experiment, trial, worker_kind, worker_index,
                        cfg=cfg, push=push)
    return _GLOBAL


def get():
    return _GLOBAL


def enabled() -> bool:
    return _GLOBAL.enabled


def shutdown() -> None:
    global _GLOBAL
    if _GLOBAL is not NULL:
        _GLOBAL.close()
        _GLOBAL = NULL


def inc(name: str, n: float = 1.0) -> None:
    _GLOBAL.inc(name, n)


def set_gauge(name: str, v: float) -> None:
    _GLOBAL.set_gauge(name, v)


def observe(name: str, v: float, buckets=None) -> None:
    _GLOBAL.observe(name, v, buckets)


def span(name: str, **attrs):
    return _GLOBAL.span(name, **attrs)


def add_span(name: str, t_start: float, dur_secs: float,
             trace: Optional[TraceContext] = None, **attrs) -> int:
    return _GLOBAL.add_span(name, t_start, dur_secs, trace=trace, **attrs)


def event(name: str, **attrs) -> None:
    _GLOBAL.event(name, **attrs)


def request_flight_dump(experiment: str, trial: str, out_dir: str) -> str:
    """Operator entry: ask EVERY worker
    to dump its flight ring into ``out_dir``. Unlike the profiler trigger
    the flag is not consumed — each worker's pusher acts once per nonce —
    so one request snapshots the whole fleet. Returns the nonce."""
    nonce = uuid.uuid4().hex[:12]
    name_resolve.add(
        names.flight_dump_trigger(experiment, trial),
        json.dumps({"dir": out_dir, "nonce": nonce, "time": time.time()}),
        replace=True,
    )
    return nonce


# --------------------------------------------------------------------------
# on-demand profiler capture
# --------------------------------------------------------------------------


def request_profiler_capture(experiment: str, trial: str, out_dir: str,
                             secs: float = 5.0) -> None:
    """Operator entry: ask the trainer for one ``torch.profiler`` capture
    of ~``secs`` seconds into ``out_dir`` (a Chrome trace)."""
    name_resolve.add(
        names.profiler_trigger(experiment, trial),
        json.dumps({"dir": out_dir, "secs": float(secs)}),
        replace=True,
    )


def read_profiler_status(experiment: str, trial: str) -> Optional[Dict]:
    try:
        return json.loads(name_resolve.get(
            names.profiler_status(experiment, trial)
        ))
    except Exception:  # noqa: BLE001 — never captured yet
        return None


class ProfilerTriggerWatcher:
    """Trainer-side poller for the profiler-trigger flag.

    ``poll()`` is called once per serve-loop iteration; it rate-limits
    the name-resolve read to ``poll_secs`` so the hot loop never pays a
    filesystem stat per iteration. On pickup: consume the flag, start a
    ``torch.profiler`` capture (CPU, and CUDA when this process uses the
    card), and stop it once the requested window has elapsed (checked on
    subsequent polls), writing ``<dir>/trace_<pid>.json`` and publishing
    the outcome under ``names.profiler_status``. One capture at a time:
    while one runs the flag is not read, so a second request waits for
    it to end. ``start_fn``/``stop_fn`` are injectable for tests.
    """

    def __init__(self, experiment: str, trial: str, poll_secs: float = 1.0,
                 start_fn=None, stop_fn=None):
        self.experiment = experiment
        self.trial = trial
        self.poll_secs = poll_secs
        self._trigger_key = names.profiler_trigger(experiment, trial)
        self._status_key = names.profiler_status(experiment, trial)
        self._next_check = 0.0
        self._deadline: Optional[float] = None
        self._out_dir: Optional[str] = None
        self._start_fn = start_fn
        self._stop_fn = stop_fn
        self._prof = None  # the running torch.profiler.profile

    def _start(self, out_dir: str) -> None:
        if self._start_fn is not None:
            self._start_fn(out_dir)
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_initialized():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        self._prof = prof

    def _stop(self) -> None:
        if self._stop_fn is not None:
            self._stop_fn()
            return
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self._out_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self._out_dir, f"trace_{os.getpid()}.json"))

    def _set_status(self, state: str, **extra) -> None:
        name_resolve.add(
            self._status_key,
            json.dumps({"state": state, "dir": self._out_dir,
                        "time": time.time(), **extra}),
            replace=True,
        )

    @property
    def capturing(self) -> bool:
        return self._deadline is not None

    def poll(self) -> None:
        now = time.monotonic()
        if self.capturing:
            if now >= self._deadline:
                self._deadline = None
                try:
                    self._stop()
                    self._set_status("done")
                    logger.info(f"profiler capture done -> {self._out_dir}")
                except Exception as e:  # noqa: BLE001 — never kill serving
                    self._set_status("failed", error=str(e))
                    logger.warning(f"profiler stop failed: {e}")
            return
        if now < self._next_check:
            return
        self._next_check = now + self.poll_secs
        try:
            raw = name_resolve.get(self._trigger_key)
        except Exception:  # noqa: BLE001 — no trigger pending
            return
        try:
            name_resolve.delete(self._trigger_key)  # consume exactly once
        except Exception:  # noqa: BLE001 — raced another consumer
            return
        try:
            req = json.loads(raw)
            self._out_dir = req["dir"]
            secs = float(req.get("secs", 5.0))
            self._start(self._out_dir)
            self._deadline = now + secs
            self._set_status("capturing", secs=secs)
            logger.info(
                f"profiler capture started ({secs}s) -> {self._out_dir}"
            )
        except Exception as e:  # noqa: BLE001 — bad request / no profiler
            self._deadline = None
            self._set_status("failed", error=str(e))
            logger.warning(f"profiler trigger failed: {e}")
