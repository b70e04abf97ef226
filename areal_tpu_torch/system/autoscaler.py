"""The elastic generation fleet: scale up and down from the manager's
signals, straggler scoring, and the launcher's scale executor.

The port of ``areal_tpu/system/autoscaler.py``, line for line: it needs
nothing of the device. A fast router (the gserver manager: lease routing,
health eviction, cordon) is kept apart from a slow controller (hysteresis
and cooldowns at a seconds cadence) that only changes the fleet's size:

 - :class:`AutoscalerCore` is the decision engine. Fed one
   :class:`FleetSignals` per interval, it votes up or down with hysteresis
   (``up_consecutive`` / ``down_consecutive``), keeps a cooldown per
   direction and the [min, max] bounds, and moves the target one server at
   a time. ``overloaded`` latches while the fleet sits at max under
   sustained pressure: the manager turns it into admission backpressure.
 - :class:`StragglerTracker` keeps per-server decode-latency EWMAs, scored
   against the median of the peers (self excluded). A server persistently
   over ``factor`` x that median is deprioritized in routing, then
   cordoned.
 - :class:`AutoscaleExecutor` is the launcher's actuator. The manager
   publishes a plan (``names.autoscale_plan``: how many dynamic
   single-server workers should run beside the baseline fleet process);
   the executor spawns supervised ``gen_server`` children to meet it, and
   they join through the manager's discovery and weight reconcile. Scale-
   down never goes through the executor: the manager cordons a victim,
   lets it drain and commands its exit over WorkerControl.

One name_resolve key joins the two halves, so ``perf_probe fleet-status``
shows the plan from outside the run. Every piece takes an injected clock.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import time
from typing import Callable, Dict, List, Optional

from areal_tpu_torch.api.train_config import AutoscaleConfig  # noqa: F401 (re-export)
from areal_tpu_torch.base import logging, name_resolve, names, telemetry

logger = logging.getLogger("system.autoscaler")


# --------------------------------------------------------------------------
# decision engine
# --------------------------------------------------------------------------


@dataclasses.dataclass
class FleetSignals:
    """One interval's view of the fleet, as the gserver manager sees it.

    Every field is derivable without extra RPCs: utilization and the
    staleness gate are manager-local quota state, queue depth and the
    TTFC SLO come from the ``/health`` bodies the health loop already
    polls, fanout ack latency from the last weight sync, and stale
    heartbeats from the liveness leases (docs/fault_tolerance.md)."""

    current_size: int  # routable servers
    cordoned: int = 0
    utilization: float = 0.0  # running_rollouts / max_concurrent_rollouts
    queue_depth: float = 0.0  # mean decode queue depth per routable server
    staled: bool = False  # the staleness gate is closed (trainer behind)
    slo_miss_frac: float = 0.0  # fraction of servers over the TTFC SLO
    fanout_ack_secs: float = 0.0  # last weight-fanout ack latency
    stale_heartbeats: int = 0  # servers alive-but-wedged per liveness lease
    # The training-health sentinel published an autoscale-inhibit hint
    # (critical alert live — system/sentinel.py): scale-up is suppressed,
    # since growing the fleet into a diverging run only burns capacity
    # and deepens off-policyness. Scale-down stays allowed.
    inhibited: bool = False


class AutoscalerCore:
    """Hysteresis + cooldown + bounds around a target fleet size.

    ``observe`` is called once per autoscale interval and never sleeps —
    tests drive the whole state machine with an injected clock. Scale-up
    pressure is ANY saturation signal while the staleness gate is open
    (a closed gate means the *trainer* is the bottleneck; more servers
    would only deepen off-policyness). Scale-down needs EVERY idleness
    signal at once. A wedged server (stale heartbeat) does not count as
    capacity — but it is replaced through the manager's plan at constant
    target, never by ratcheting the target itself."""

    def __init__(self, cfg: AutoscaleConfig,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self.target: Optional[int] = None  # set from the first observation
        self.overloaded = False
        self._up_votes = 0
        self._down_votes = 0
        self._last_action: Optional[float] = None

    def _up_reasons(self, s: FleetSignals) -> List[str]:
        c = self.cfg
        if s.staled or s.inhibited:
            return []
        reasons = []
        if s.utilization >= c.up_utilization:
            reasons.append(f"utilization {s.utilization:.2f}")
        if s.queue_depth >= c.queue_high:
            reasons.append(f"queue depth {s.queue_depth:.1f}")
        if c.slo_ttfc_secs > 0 and s.slo_miss_frac >= c.slo_miss_fraction:
            reasons.append(f"SLO miss fraction {s.slo_miss_frac:.2f}")
        if (c.fanout_ack_high_secs > 0
                and s.fanout_ack_secs >= c.fanout_ack_high_secs):
            reasons.append(f"fanout ack {s.fanout_ack_secs:.1f}s")
        # Wedged heartbeats are deliberately NOT up-pressure: spawning
        # more servers never clears a stale lease, so the signal would
        # ratchet the target to max (and latch overload backpressure) on
        # an idle fleet. They subtract from counted capacity instead —
        # the manager's plan replaces the wedged server at constant
        # target (see _autoscale_tick's baseline accounting).
        return reasons

    def _down_ok(self, s: FleetSignals) -> bool:
        c = self.cfg
        if s.utilization > c.down_utilization or s.queue_depth > c.queue_low:
            return False
        if c.slo_ttfc_secs > 0 and s.slo_miss_frac > 0:
            return False
        return True

    def observe(self, s: FleetSignals) -> Optional[Dict]:
        """Record one interval; returns an action record
        ({action, target, reason}) when the target moved, else None."""
        c = self.cfg
        now = self.clock()
        # Wedged servers are not capacity: the effective size drives both
        # the bounds check and the published plan's replacement math.
        effective = max(s.current_size - s.stale_heartbeats, 0)
        if self.target is None:
            self.target = min(max(effective, c.min_servers), c.max_servers)
        up = self._up_reasons(s)
        down = self._down_ok(s)
        self.overloaded = bool(up) and self.target >= c.max_servers
        if up:
            self._up_votes += 1
            self._down_votes = 0
        elif down:
            self._down_votes += 1
            self._up_votes = 0
        else:
            self._up_votes = 0
            self._down_votes = 0
        if (
            up
            and self._up_votes >= c.up_consecutive
            and self.target < c.max_servers
            and self._cooled(now, c.scale_up_cooldown_secs)
        ):
            self.target += 1
            self._last_action = now
            self._up_votes = 0
            return {"action": "up", "target": self.target,
                    "reason": "; ".join(up)}
        if (
            down
            and self._down_votes >= c.down_consecutive
            and self.target > c.min_servers
            and self._cooled(now, c.scale_down_cooldown_secs)
        ):
            self.target -= 1
            self._last_action = now
            self._down_votes = 0
            return {"action": "down", "target": self.target,
                    "reason": "fleet idle"}
        return None

    def _cooled(self, now: float, cooldown: float) -> bool:
        return self._last_action is None or now - self._last_action >= cooldown


# --------------------------------------------------------------------------
# straggler scoring
# --------------------------------------------------------------------------


class _StragglerState:
    __slots__ = ("ewma", "n", "slow_sweeps")

    def __init__(self):
        self.ewma: Optional[float] = None
        self.n = 0
        self.slow_sweeps = 0


class StragglerTracker:
    """Per-server decode-latency EWMAs + peer-relative slowness streaks.

    ``observe(url, secs)`` folds one /health-reported decode-latency
    sample into the url's EWMA; ``sweep(urls)`` scores every url against
    the median of its PEERS (self excluded — a single straggler must not
    drag the baseline toward itself) and returns
    ``{url: "ok" | "slow" | "cordon"}``. "slow" after
    ``slow_sweeps`` consecutive over-factor sweeps (deprioritize in
    routing), "cordon" after ``cordon_sweeps``. Samples below
    ``floor_secs`` are jitter at timescales routing cannot exploit."""

    def __init__(self, factor: float = 3.0, min_probes: int = 5,
                 slow_sweeps: int = 2, cordon_sweeps: int = 6,
                 floor_secs: float = 0.002, alpha: float = 0.3):
        self.factor = factor
        self.min_probes = min_probes
        self.slow_sweeps = slow_sweeps
        self.cordon_sweeps = cordon_sweeps
        self.floor_secs = floor_secs
        self.alpha = alpha
        self._state: Dict[str, _StragglerState] = {}

    def observe(self, url: str, secs: float) -> None:
        st = self._state.setdefault(url, _StragglerState())
        st.n += 1
        st.ewma = (
            secs if st.ewma is None
            else (1 - self.alpha) * st.ewma + self.alpha * secs
        )

    def forget(self, url: str) -> None:
        self._state.pop(url, None)

    def ewma(self, url: str) -> Optional[float]:
        st = self._state.get(url)
        return st.ewma if st is not None else None

    def sweep(self, urls: List[str]) -> Dict[str, str]:
        out: Dict[str, str] = {}
        mature = {
            u: self._state[u] for u in urls
            if u in self._state and self._state[u].n >= self.min_probes
            and self._state[u].ewma is not None
        }
        for url in urls:
            st = mature.get(url)
            if st is None:
                out[url] = "ok"
                continue
            peers = [s.ewma for u, s in mature.items() if u != url]
            if not peers:
                out[url] = "ok"  # no peer baseline: cannot judge
                continue
            med = statistics.median(peers)
            slow = (
                st.ewma >= self.floor_secs
                and st.ewma >= self.factor * max(med, self.floor_secs / 10)
            )
            st.slow_sweeps = st.slow_sweeps + 1 if slow else 0
            if st.slow_sweeps >= self.cordon_sweeps:
                out[url] = "cordon"
            elif st.slow_sweeps >= self.slow_sweeps:
                out[url] = "slow"
            else:
                out[url] = "ok"
        return out


# --------------------------------------------------------------------------
# plan wire (manager -> launcher executor, via name_resolve)
# --------------------------------------------------------------------------


def publish_plan(experiment: str, trial: str, plan: Dict) -> None:
    try:
        name_resolve.add(
            names.autoscale_plan(experiment, trial),
            json.dumps(plan), replace=True, delete_on_exit=False,
        )
    except Exception as e:  # noqa: BLE001 — retried next interval
        logger.warning(f"autoscale plan publish failed: {e}")


def read_plan(experiment: str, trial: str) -> Optional[Dict]:
    try:
        return json.loads(name_resolve.get(
            names.autoscale_plan(experiment, trial)
        ))
    except Exception:  # noqa: BLE001 — no plan yet / torn write
        return None


def read_inhibit(experiment: str, trial: str,
                 wall: Callable[[], float] = time.time) -> Optional[Dict]:
    """The sentinel's autoscale-inhibit hint ({until, rule, ts}), or None
    when absent/expired. Consumed by the manager's scaling loop each
    interval; expiry means a stale hint from a resolved incident can
    never pin the fleet forever."""
    try:
        d = json.loads(name_resolve.get(
            names.autoscale_inhibit(experiment, trial)
        ))
    except Exception:  # noqa: BLE001 — no hint published
        return None
    try:
        return d if wall() < float(d.get("until", 0.0)) else None
    except (TypeError, ValueError):
        return None


# --------------------------------------------------------------------------
# launcher-side executor
# --------------------------------------------------------------------------


class AutoscaleExecutor:
    """Reconcile the supervisor's dynamic gen-server children against the
    manager's published plan.

    Called from the launcher's monitor loop (~1 Hz) next to
    ``supervisor.check()``. It only ever spawns — scale-down is the
    manager's cordon → drain → WorkerControl-exit sequence, which the
    supervisor observes as an expected clean exit (``required=False``).
    A crash-looped dynamic server the supervisor permanently removed
    (``WorkerSpec.expendable``) simply drops the live count, so the next
    step spawns a *fresh* spec within the plan's bounds. One spawn per
    step with a cooldown keeps a hard-failing spec from machine-gunning
    processes faster than the circuit breaker can count them."""

    def __init__(self, experiment: str, trial: str, supervisor,
                 spawn_fn: Callable[[str], None], kind: str = "gen_server",
                 spawn_cooldown_secs: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self.experiment = experiment
        self.trial = trial
        self.supervisor = supervisor
        self.spawn_fn = spawn_fn
        self.kind = kind
        self.spawn_cooldown_secs = spawn_cooldown_secs
        self.clock = clock
        self.spawned: List[str] = []
        self._seq = 0
        self._last_spawn: Optional[float] = None

    def step(self) -> Optional[str]:
        """One reconcile pass; returns the spawned server_id, if any."""
        if getattr(self.supervisor, "_draining", False):
            return None
        plan = read_plan(self.experiment, self.trial)
        if not plan:
            return None
        want = int(plan.get("dynamic", 0))
        have = self.supervisor.alive_count(self.kind)
        if have >= want:
            return None
        now = self.clock()
        if (self._last_spawn is not None
                and now - self._last_spawn < self.spawn_cooldown_secs):
            return None
        self._seq += 1
        server_id = f"dyn{self._seq}"
        self.spawn_fn(server_id)
        self._last_spawn = now
        self.spawned.append(server_id)
        telemetry.inc("autoscale/spawns")
        logger.info(
            f"autoscale: spawned dynamic generation server {server_id} "
            f"({have + 1}/{want} dynamic, plan target {plan.get('target')})"
        )
        return server_id
