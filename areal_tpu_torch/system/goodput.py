"""Goodput ledger: live per-device utilization for the async pipeline.

The port's copy of ``areal_tpu/system/goodput.py``, in three layers:

 - :class:`GoodputLedger` — per-worker time-in-state accounting. Each
   worker classifies its wall clock into ``compute / comm / data_wait /
   idle`` monotonic counters (trainer fwd-bwd and optimizer vs data-wait
   vs weight-publish; generation server prefill/decode vs queue-empty
   idle vs weight-update; rollout worker gate-wait vs grading vs
   generation-wait), exported into the worker's telemetry registry as
   ``goodput/secs{state=...}`` counters — ``areal_goodput_secs_total``
   on the scrape, so Prometheus ``rate()`` yields live utilization
   fractions without any server-side windowing.
 - :class:`MfuEmitter` + :func:`resolve_peak_flops` — live achieved
   FLOP/s and MFU gauges against the card's peak
   (``base/monitor.device_peak_flops``, the one home of the FLOPs
   formulas). On an unknown device the emitter degrades to
   achieved-TFLOP/s-only with a one-time warning instead of exporting
   ``mfu=0.0`` (a hard zero would trip baseline sentinel rules as a
   false divergence).
 - :class:`FleetGoodput` — master-side stitching inside the
   TelemetryAggregator: useful device-seconds / total device-seconds over
   the merged worker counters, split trainer vs generation side,
   exported as ``areal_fleet_goodput{side=...}`` gauges on the merged
   scrape (and periodically into ``telemetry.jsonl``).

The "compute" state is host wall time: on the trainer a span around the
work, synchronised with the device only while telemetry is on. The
device's own busy share comes from a profiler capture, not from here.

Disabled contract (``goodput.enabled=false``, the default): every worker
gets the shared :data:`NULL_LEDGER` — no clock reads, no counters, no
MFU math — and the aggregator receives no FleetGoodput.

Accounting semantics: a ledger holds ONE current state behind a lock;
``enter``/``state`` transitions partition wall clock exactly (the state
totals always sum to the elapsed wall time). The partition must have a
SINGLE owner: two concurrent enter/restore pairs interleaving restore
stale states and can wedge the partition. Work that overlaps the owner's
partition therefore ACCRUES via ``add(state, secs)`` or
``add_overlap(state, secs)`` instead of transitioning — the generation
server's weight updates (its runner thread owns idle↔compute) and the
rollout worker's concurrent rollout phases both do this. Accrued counters
measure task-seconds, which is also why :class:`FleetGoodput` folds only
the partition-owning device kinds (trainer, generation_server) into
fleet goodput.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

from areal_tpu_torch.base import logging, telemetry

logger = logging.getLogger("system.goodput")

# The canonical state vocabulary. Ledgers accept other names (the export
# key is just an inline Prometheus label), but every built-in worker maps
# onto these four so fleet stitching is uniform across kinds.
GOODPUT_STATES = ("compute", "comm", "data_wait", "idle")

# Which worker kinds own accelerator chips — the only kinds folded into
# fleet goodput (CPU drivers like rollout workers export task-second
# counters that don't partition wall clock; see the module docstring).
TRAINER_SIDE_KINDS = frozenset({"trainer"})
GENERATION_SIDE_KINDS = frozenset({"generation_server"})

# The states that count as "useful" chip time in fleet goodput. comm
# (weight publish/consume) is overhead the async design exists to hide,
# so it is deliberately NOT useful — hiding it is the claim under test.
USEFUL_STATES = frozenset({"compute"})


def _counter_key(state: str) -> str:
    return f"goodput/secs{{state={state}}}"


def _overlap_key(state: str) -> str:
    return f"goodput/overlap_secs{{state={state}}}"


class GoodputLedger:
    """Thread-safe time-in-state accountant for one worker.

    Two modes share one export path:

    - wall-partition (``initial_state`` set, the default): ``enter(s)``
      closes the current state's interval and opens ``s``; the ``state``
      context manager restores the previous state on exit, so nesting
      (a weight publish inside an MFC) attributes correctly. Totals sum
      to wall clock exactly.
    - accrual-only (``initial_state=None``): no current state; callers
      ``add(state, secs)`` measured windows (task-seconds under
      concurrency).

    Exports are DELTAS into monotonic ``goodput/secs{state=...}``
    counters on the telemetry sink, rate-limited to
    ``export_interval_secs`` (transitions in between only accrue
    host-side floats).
    """

    enabled = True

    def __init__(self, sink, clock=time.monotonic,
                 export_interval_secs: float = 1.0,
                 initial_state: Optional[str] = "idle"):
        self._sink = sink
        self._clock = clock
        self._interval = max(float(export_interval_secs), 0.0)
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = {s: 0.0 for s in GOODPUT_STATES}
        self._exported: Dict[str, float] = {}
        # Work overlapping the wall partition (add_overlap) — exported
        # as a SEPARATE goodput/overlap_secs family so the partition
        # states still sum to wall clock.
        self._overlap: Dict[str, float] = {}
        self._overlap_exported: Dict[str, float] = {}
        self._cur = initial_state
        now = clock()
        # The partition's origin: in wall-partition mode the state totals
        # sum to (the last transition's time - t_start).
        self.t_start = now
        self._t_cur = now
        self._t_export = now

    # ---- wall-partition mode ----

    def enter(self, state: str) -> Optional[str]:
        """Switch to ``state``; returns the previous state (what a paired
        restore should re-enter). In accrual-only mode this STARTS the
        partition at ``state`` (no time is attributed retroactively)."""
        with self._lock:
            now = self._clock()
            prev = self._cur
            if prev is not None:
                self._totals[prev] = (
                    self._totals.get(prev, 0.0) + (now - self._t_cur)
                )
            self._cur = state
            self._t_cur = now
            self._maybe_export(now)
        return prev

    @contextmanager
    def state(self, state: str):
        """``with ledger.state("compute"):`` — enter ``state`` for the
        block, restore the previous state after (exception-safe)."""
        prev = self.enter(state)
        try:
            yield
        finally:
            if prev is not None:
                self.enter(prev)

    # ---- accrual-only mode ----

    def add(self, state: str, secs: float) -> None:
        """Accrue a caller-measured window (task-seconds; may overlap
        other windows under concurrency)."""
        if secs <= 0:
            return
        with self._lock:
            self._totals[state] = self._totals.get(state, 0.0) + float(secs)
            self._maybe_export(self._clock())

    def add_overlap(self, state: str, secs: float) -> None:
        """Accrue work that overlaps a wall-partition ledger's own
        timeline (a generation server's weight update racing decodes on
        the same event loop). Exported under the SEPARATE
        ``goodput/overlap_secs{state=...}`` family: folding it into the
        partition counters would make the states sum past wall clock —
        deflating every rate()-derived utilization fraction (and fleet
        goodput, which sums a chip worker's partition states as its
        denominator)."""
        if secs <= 0:
            return
        with self._lock:
            self._overlap[state] = (
                self._overlap.get(state, 0.0) + float(secs)
            )
            self._maybe_export(self._clock())

    # ---- shared ----

    def poll(self) -> None:
        """Fold the in-progress state's elapsed time into its total and
        export if due — serve loops call this so a long idle (or a long
        compute) shows up on the scrape before its closing transition."""
        with self._lock:
            now = self._clock()
            if self._cur is not None:
                self._totals[self._cur] = (
                    self._totals.get(self._cur, 0.0) + (now - self._t_cur)
                )
                self._t_cur = now
            self._maybe_export(now)

    def flush(self) -> None:
        """poll() + unconditional export (shutdown path)."""
        with self._lock:
            now = self._clock()
            if self._cur is not None:
                self._totals[self._cur] = (
                    self._totals.get(self._cur, 0.0) + (now - self._t_cur)
                )
                self._t_cur = now
            self._maybe_export(now, force=True)

    def totals(self) -> Dict[str, float]:
        """Accrued seconds per state (excluding the in-progress interval
        — call :meth:`poll` first for an up-to-the-instant view)."""
        with self._lock:
            return dict(self._totals)

    def _maybe_export(self, now: float, force: bool = False) -> None:
        # Called with self._lock held. The sink's own lock nests inside
        # ours and nothing ever takes them in the other order.
        if not force and now - self._t_export < self._interval:
            return
        self._t_export = now
        for s, v in self._totals.items():
            delta = v - self._exported.get(s, 0.0)
            if delta > 0:
                self._exported[s] = v
                self._sink.inc(_counter_key(s), delta)
        for s, v in self._overlap.items():
            delta = v - self._overlap_exported.get(s, 0.0)
            if delta > 0:
                self._overlap_exported[s] = v
                self._sink.inc(_overlap_key(s), delta)


class _NullLedger:
    """Shared disabled ledger: no clock reads, no counters, no locks."""

    enabled = False

    def enter(self, state: str) -> Optional[str]:
        return None

    @contextmanager
    def state(self, state: str):
        yield

    def add(self, state: str, secs: float) -> None:
        pass

    def add_overlap(self, state: str, secs: float) -> None:
        pass

    def poll(self) -> None:
        pass

    def flush(self) -> None:
        pass

    def totals(self) -> Dict[str, float]:
        return {}


NULL_LEDGER = _NullLedger()


def make_ledger(cfg, sink, clock=time.monotonic,
                initial_state: Optional[str] = "idle"):
    """Ledger for one worker, honoring the disabled contract: a missing/
    disabled :class:`~areal_tpu_torch.api.train_config.GoodputConfig` — or a
    disabled telemetry sink (nowhere to export) — yields the shared null
    ledger, so call sites never branch."""
    if cfg is None or not getattr(cfg, "enabled", False):
        return NULL_LEDGER
    if sink is None or not getattr(sink, "enabled", False):
        return NULL_LEDGER
    return GoodputLedger(
        sink, clock=clock,
        export_interval_secs=getattr(cfg, "export_interval_secs", 1.0),
        initial_state=initial_state,
    )


# --------------------------------------------------------------------------
# live MFU gauges
# --------------------------------------------------------------------------


def resolve_peak_flops(cfg, device_kind: Optional[str] = None
                       ) -> Optional[float]:
    """Per-card peak FLOP/s for live MFU: the config override when set,
    else the card table (``monitor.device_peak_flops`` over the device's
    name, e.g. ``torch.cuda.get_device_name()``), else None — unknown
    kinds degrade to achieved-TFLOP/s-only."""
    from areal_tpu_torch.base import monitor

    override = float(getattr(cfg, "peak_flops_override", 0.0) or 0.0)
    if override > 0:
        return override
    return monitor.device_peak_flops(device_kind)


class MfuEmitter:
    """Publishes one (achieved-TFLOP/s, MFU) gauge pair.

    ``emit(flops_per_sec_per_chip)`` always sets the TFLOP/s gauge; the
    MFU gauge only exists when the peak is known. An unknown peak warns
    ONCE and then stays silent — exporting ``mfu=0.0`` instead would
    look like a real collapse to any rolling-baseline sentinel rule."""

    def __init__(self, sink, peak_flops: Optional[float],
                 tflops_name: str, mfu_name: str, context: str = ""):
        self._sink = sink
        self.peak = float(peak_flops) if peak_flops else None
        self._tflops_name = tflops_name
        self._mfu_name = mfu_name
        self._context = context
        self._warned = False

    def emit(self, flops_per_sec_per_chip: float) -> None:
        f = float(flops_per_sec_per_chip)
        if f <= 0:
            return
        self._sink.set_gauge(self._tflops_name, f / 1e12)
        if self.peak:
            self._sink.set_gauge(self._mfu_name, f / self.peak)
        elif not self._warned:
            self._warned = True
            logger.warning(
                f"{self._context or self._mfu_name}: unknown device peak "
                f"FLOP/s — exporting {self._tflops_name} only (no "
                f"{self._mfu_name} gauge). Set goodput.peak_flops_override "
                f"or extend base/monitor.NVIDIA_PEAK_BF16."
            )


# --------------------------------------------------------------------------
# master-side fleet stitching
# --------------------------------------------------------------------------


class FleetGoodput:
    """Derives fleet goodput from the per-worker ledger counters flowing
    through the TelemetryAggregator.

    ``update(worker, counters)`` parses the cumulative
    ``goodput/secs{state=...}`` totals out of one ingested snapshot and
    recomputes useful chip-seconds / total chip-seconds over the
    chip-bearing workers — overall and split trainer vs generation side
    — into this object's registry (exported by the aggregator's merged
    /metrics as the ``fleet`` pseudo-worker). Returns the fresh gauge
    dict (for the sentinel feed), or None when the snapshot carried no
    ledger counters.

    The fraction is WINDOWED, not since-start: each worker keeps a short
    history of (time, cumulative totals) snapshots and contributes the
    delta over the last ``window_secs`` — a since-start average's
    sensitivity decays with run length, so six hours in, a fleet going
    fully idle would barely move the gauge (and the ``goodput_collapse``
    sentinel rule would never see the excursion it exists to catch). A
    cumulative total going BACKWARD (worker restart reset its counters)
    restarts that worker's baseline, and a worker that stops reporting
    for ``expiry_secs`` is dropped entirely — an evicted/scaled-down
    server's frozen history must not pin either side's fraction (same
    failure mode as the sentinel's ``source_expiry_secs``)."""

    def __init__(self, registry: Optional[Any] = None,
                 window_secs: float = 300.0, expiry_secs: float = 120.0,
                 clock=time.monotonic):
        self.registry = registry or telemetry.TelemetryRegistry()
        self.window_secs = float(window_secs)
        self.expiry_secs = float(expiry_secs)
        self._clock = clock
        self._lock = threading.Lock()
        # worker "kind:index" -> list of (t, {state: cumulative secs}),
        # oldest first; [0] is the window baseline.
        self._hist: Dict[str, list] = {}
        # gauge names currently published into the registry — so a side
        # whose workers all expired is WITHDRAWN from the scrape rather
        # than pinned at its last (now fictional) value.
        self._published: set = set()

    @staticmethod
    def _ledger_totals(counters: Dict[str, float]) -> Dict[str, float]:
        totals: Dict[str, float] = {}
        for key, v in (counters or {}).items():
            base, labels = telemetry._metric_key_labels(key)
            if base != "goodput/secs" or not labels:
                continue
            state = labels.get("state")
            if state and isinstance(v, (int, float)):
                totals[state] = totals.get(state, 0.0) + float(v)
        return totals

    def _window_row(self, worker: str) -> Dict[str, float]:
        """One worker's per-state seconds over the window: latest
        cumulative minus the baseline snapshot (a first/just-reset
        worker contributes its full since-start totals)."""
        hist = self._hist[worker]
        latest = hist[-1][1]
        base = hist[0][1] if len(hist) >= 2 else {}
        return {
            s: max(v - base.get(s, 0.0), 0.0) for s, v in latest.items()
        }

    @staticmethod
    def _fraction(rows) -> Optional[float]:
        total = sum(sum(t.values()) for t in rows)
        if total <= 0:
            return None
        useful = sum(
            v for t in rows for s, v in t.items() if s in USEFUL_STATES
        )
        return useful / total

    def update(self, worker: str,
               counters: Dict[str, float]) -> Optional[Dict[str, float]]:
        totals = self._ledger_totals(counters)
        if not totals:
            return None
        now = self._clock()
        with self._lock:
            hist = self._hist.setdefault(worker, [])
            if hist and any(
                totals.get(s, 0.0) < v - 1e-9
                for s, v in hist[-1][1].items()
            ):
                hist.clear()  # counter reset: the worker restarted
            hist.append((now, totals))
            # Trim so [0] stays the newest sample at/before the window
            # start (the delta baseline); everything older is dead.
            while len(hist) >= 2 and hist[1][0] <= now - self.window_secs:
                hist.pop(0)
            # Expire departed workers (evicted / scaled-down): their
            # frozen totals must not pin the fractions forever.
            for w in [w for w, h in self._hist.items()
                      if now - h[-1][0] > self.expiry_secs]:
                del self._hist[w]
            trainer_rows = [
                self._window_row(w) for w in self._hist
                if w.partition(":")[0] in TRAINER_SIDE_KINDS
            ]
            gen_rows = [
                self._window_row(w) for w in self._hist
                if w.partition(":")[0] in GENERATION_SIDE_KINDS
            ]
        gauges: Dict[str, float] = {}
        fleet = self._fraction(trainer_rows + gen_rows)
        if fleet is not None:
            gauges["fleet/goodput"] = fleet
        t = self._fraction(trainer_rows)
        if t is not None:
            gauges["fleet/goodput{side=trainer}"] = t
        g = self._fraction(gen_rows)
        if g is not None:
            gauges["fleet/goodput{side=generation}"] = g
        gauges["fleet/goodput_workers"] = float(
            len(trainer_rows) + len(gen_rows)
        )
        for k in self._published - set(gauges):
            self.registry.remove_gauge(k)
        self._published = set(gauges)
        for k, v in gauges.items():
            self.registry.set_gauge(k, v)
        # Non-chip kinds (rollout task-seconds) still land in _hist —
        # visible per-worker on the scrape — without skewing either
        # side's fraction.
        return gauges

    def gauges(self) -> Dict[str, float]:
        return dict(self.registry.snapshot(reset=False)["gauges"])
