"""Training-health sentinel: streaming anomaly detection, declarative
alerting, and automatic evidence capture.

The port's copy of ``areal_tpu/system/sentinel.py``: the rule grammar and
parser, the rule packs (:data:`DEFAULT_RULES`, :data:`COMPILE_RULES`, and
:data:`DURABILITY_RULES`, armed only with the durable sample spool) and
the engine. It is hosted inside the
master's :class:`~areal_tpu_torch.base.telemetry.TelemetryAggregator` (the
one process that sees every worker's snapshots) and evaluates a
declarative rule set over two streams:

 - the merged fleet telemetry flowing into ``telemetry.jsonl`` (gauges and
   counters of every worker kind), and
 - the per-step RL training-dynamics series the trainer exports as
   ``train/*`` gauges (approx-KL, token entropy, clip fraction,
   importance-weight tail, grad norm, reward mean, staleness lag; see
   ``system/trainer_worker._export_train_stats``).

Rule grammar: each rule is a dict with an ``id``, a ``metric`` from
:data:`METRIC_CATALOG`, a predicate ``kind``

 - ``threshold``  latest aggregated value ``op`` ``value``
 - ``rate``       per-second rate of change over ``window`` ``op`` ``value``
                  (counters differentiate naturally)
 - ``baseline``   |latest − rolling median(window)| exceeds ``value`` ×
                  max(1.4826·MAD, 5% of |median|) — self-calibrating
                  robust deviation for series with no sane absolute
                  threshold (median/MAD so a live anomaly cannot poison
                  its own baseline and self-clear)
 - ``absence``    no new value for the metric within ``for`` seconds
                  (dead producer / wedged pipeline detection)

plus a ``for`` duration the predicate must hold before the alert fires, a
``severity`` (``info|warn|critical``), and a per-rule ``cooldown``
bounding re-fires. Firing alerts are appended to ``alerts.jsonl``,
exported as ``areal_alerts_total{rule,severity}`` and
``areal_alert_active{rule}`` on the merged Prometheus endpoint, and
trigger evidence capture while the anomaly is still live:

 - a fan-out flight-recorder dump (``names.flight_dump_trigger``; every
   worker's ring lands in the bundle within one telemetry flush),
 - optionally an on-demand ``torch.profiler`` capture on the trainer,
 - a pinned sample of recent stitched trace ids,
 - the triggering metric's recent window,

bundled into a per-alert ``evidence/<rule>-<ts>/`` directory. Critical
alerts also publish an autoscale-inhibit hint
(``names.autoscale_inhibit``, which the manager's autoscale loop reads:
no scale-up while it is live), and rules with ``action: pause`` may (with
``allow_pause``) command a master pause at the next step boundary through
the WorkerControl panel.

Disabled contract: the sentinel creates no threads, sockets, or files of
its own — it is driven entirely by the aggregator's ingest loop — and
with ``sentinel.enabled=false`` nothing here is constructed at all.
"""

from __future__ import annotations

import collections
import dataclasses
import difflib
import json
import math
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from areal_tpu_torch.base import logging, name_resolve, names, telemetry

logger = logging.getLogger("system.sentinel")

RULE_KINDS = ("threshold", "rate", "baseline", "absence")
SEVERITIES = ("info", "warn", "critical")
OPS = {
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
}
AGGS = ("max", "min", "mean", "sum")
ACTIONS = ("evidence", "pause")

# Metric names a rule may reference — the union of every gauge/counter
# series the workers export (base names; inline ``{label=...}`` suffixes
# are stripped at feed time, so one rule watches a family across all its
# label values and workers). validate_config rejects rules referencing
# names outside this catalog at parse time, while the operator is still
# at the command line (docs/observability.md carries the same table).
METRIC_CATALOG = frozenset({
    # trainer training-dynamics series (trainer_worker._export_train_stats
    # republishes every train_step stat as train/<name>{mfc=...})
    "train/actor_loss", "train/critic_loss", "train/importance_weight",
    "train/clip_ratio", "train/dual_clip_ratio", "train/value_clip_ratio",
    "train/mean_kl", "train/approx_kl", "train/entropy",
    "train/behav_imp_tail", "train/kl_coef", "train/grad_norm", "train/lr",
    "train/n_action_tokens", "train/n_ppo_steps", "train/task_reward",
    "train/reward_std", "train/adv_scale", "train/staleness_lag",
    "train/value_mean", "train/value_var", "train/update_applied",
    "train/loss_weight", "train/total_tokens",
    # train engine counters/gauges (backend/torch_train.py)
    "train/tokens", "train/optimizer_steps", "train/pack_fill",
    # parallelism engagement (parallel/pipeline.py gates, exported per
    # batch by backend/torch_train.py): 0/1 gauges for whether the pipeline
    # schedule and ring attention actually engaged, plus the per-reason
    # GSPMD-fallback counter.
    "train/pp_engaged", "train/ring_engaged", "parallel/pp_fallback",
    "train/moe_ep_engaged",
    # MoE routing health (backend/torch_train.py publishes per train step):
    # fraction of routed assignments dropped at the capacity boundary, the
    # per-expert load share histogram, and its max/mean ratio (1 = balanced,
    # num_experts = full collapse onto one expert).
    "train/moe_dropped_frac", "train/moe_expert_load_dist",
    "train/moe_expert_load_ratio",
    # goodput ledger + live MFU (system/goodput.py): per-worker
    # time-in-state counters, the trainer's achieved-FLOP/s gauges, the
    # generation servers' analytic decode/prefill FLOP/s, and the
    # aggregator-derived fleet goodput (fed as source "fleet:0").
    "goodput/secs", "train/achieved_tflops", "train/mfu",
    "genserver/decode_tflops", "genserver/decode_mfu",
    "genserver/prefill_tflops", "fleet/goodput", "fleet/goodput_workers",
    # trainer worker
    "trainer/store_size", "trainer/pull_queue_depth",
    "trainer/weight_publish_secs", "trainer/weight_publishes",
    # master (fed directly from the step loop — no flush latency)
    "master/step_secs", "master/step",
    # rollout workers
    "rollout/inflight", "rollout/done", "rollout/failovers",
    "rollout/alloc_denied", "rollout/backpressure_throttled",
    "rollout/trajectories_pushed", "rollout/staleness_current",
    # generation fleet + manager
    "gsmgr/healthy_servers", "gsmgr/known_servers", "gsmgr/lease_depth",
    "gsmgr/running_rollouts", "gsmgr/accepted_rollouts", "gsmgr/evictions",
    "gsmgr/health_probe_failures", "gsmgr/fanout_failures",
    "gsmgr/weight_version", "genserver/weight_version",
    "genserver/generated_tokens", "genserver/decode_chunks",
    "genserver/inflight_requests", "genserver/weight_update_failures",
    # autoscaler wedge/cordon counters (the sentinel consumes these; on
    # critical alerts it publishes the inhibit hint back — see
    # system/autoscaler.read_inhibit)
    "autoscale/cordoned_servers", "autoscale/current_size",
    "autoscale/target_size", "autoscale/overloaded", "autoscale/cordons",
    "autoscale/straggler_cordons", "autoscale/straggler_deprioritized",
    "autoscale/backpressure_denials", "autoscale/inhibited",
    # supervision + reward fleet + telemetry health
    "supervisor/restarts", "supervisor/deaths", "supervisor/draining",
    "reward/requests", "reward/timeouts", "reward/errors",
    "telemetry/spans_dropped",
    # durable sample spool (system/sample_spool.py): per-rollout-worker
    # depth/bytes/age gauges + delivery counters, the trainer's
    # dedup/stale-drop counters, and the stream/buffer degradation
    # counters the at-least-once path leans on.
    "spool/depth", "spool/bytes", "spool/oldest_unacked_age_secs",
    "spool/appended", "spool/acked", "spool/resent", "spool/replayed",
    "spool/backpressure_waits", "spool/replay_stale_dropped",
    "spool/duplicate_dropped", "buffer/duplicate_dropped",
    "stream/push_blocked",
    # compile & HBM observatory (base/compile_watch.py,
    # system/memwatch.py; docs/observability.md §Compile & memory):
    # per-fn compile events/seconds/shape counts, the process-wide
    # in-flight gauge the compile-aware absence rules read, persistent
    # cache hit/miss counters, and per-device HBM gauges plus the
    # aggregator-derived utilization series.
    "compile/events", "compile/secs", "compile/storm_events",
    "compile/cache_hits", "compile/cache_misses", "compile/inflight",
    "compile/distinct_shapes",
    "hbm/bytes_in_use", "hbm/peak_bytes", "hbm/limit_bytes",
    "hbm/watermark_bytes", "hbm/utilization",
    "hbm/memory_stats_unavailable",
})

_DUR_RE = re.compile(r"^\s*([0-9]*\.?[0-9]+)\s*(ms|s|m|h)?\s*$")
_DUR_UNITS = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0, None: 1.0}


def parse_duration(v) -> float:
    """``30``, ``"30"``, ``"30s"``, ``"5m"``, ``"1.5h"`` → seconds."""
    if isinstance(v, (int, float)):
        return float(v)
    m = _DUR_RE.match(str(v))
    if not m:
        raise ValueError(f"cannot parse duration {v!r} "
                         f"(use seconds, or '30s'/'5m'/'1h')")
    return float(m.group(1)) * _DUR_UNITS[m.group(2)]


class SentinelConfigError(ValueError):
    """Raised at parse time for an invalid rule pack; api.cli_args wraps
    it into its ConfigError so a bad pack fails at the command line."""


@dataclasses.dataclass
class Rule:
    """One parsed, validated sentinel rule."""

    id: str
    metric: str
    kind: str = "threshold"
    op: str = "gt"
    value: float = 0.0  # threshold / rate-per-sec / baseline sigmas
    for_secs: float = 10.0
    cooldown_secs: float = 300.0
    severity: str = "warn"
    window_secs: float = 120.0  # rate + baseline lookback
    agg: str = "max"  # across workers/labels reporting the metric
    action: str = "evidence"  # "pause" additionally pauses the master
    description: str = ""
    # Absence-rule suppressor: while this metric family has a recent
    # nonzero reading (or the matching names.compile_inflight flag is
    # fresh), the absence predicate reports healthy instead of counting
    # toward 'for'. The compile-aware liveness story: trainer_stalled
    # sets it to compile/inflight so a long first-use build doesn't need
    # a blanket grace.
    unless_metric: Optional[str] = None


# The default rule pack — the divergence signatures that actually kill RL
# runs (AReaL's decoupled-PPO staleness control; long-horizon runs where
# silent divergence wastes days of compute) plus fleet-wedge detection.
# Thresholds are deliberately conservative: a healthy run fires nothing.
# docs/operations.md maps each id to its first diagnostic step.
DEFAULT_RULES: Tuple[Dict[str, Any], ...] = (
    {"id": "kl_blowup", "metric": "train/approx_kl", "kind": "threshold",
     "op": "gt", "value": 1.0, "for": 10, "cooldown": 300,
     "severity": "critical",
     "description": "policy ran away from the behavior policy "
                    "(approx-KL > 1 nat sustained)"},
    {"id": "ref_kl_runaway", "metric": "train/mean_kl", "kind": "threshold",
     "op": "gt", "value": 10.0, "for": 30, "cooldown": 600,
     "severity": "warn",
     "description": "behavior policy far from the reference policy"},
    {"id": "entropy_collapse", "metric": "train/entropy",
     "kind": "threshold", "op": "lt", "value": 0.05, "for": 30,
     "cooldown": 600, "severity": "critical",
     "description": "token entropy near zero: the policy went "
                    "deterministic and exploration is dead"},
    {"id": "clip_saturation", "metric": "train/clip_ratio",
     "kind": "threshold", "op": "gt", "value": 0.5, "for": 30,
     "cooldown": 600, "severity": "warn",
     "description": "most action tokens are clipping: updates are "
                    "dominated by the trust region"},
    {"id": "imp_weight_tail", "metric": "train/behav_imp_tail",
     "kind": "threshold", "op": "gt", "value": 0.2, "for": 30,
     "cooldown": 600, "severity": "warn",
     "description": "importance-weight cap is dropping a heavy token "
                    "tail: off-policyness beyond what the loss corrects"},
    {"id": "grad_norm_spike", "metric": "train/grad_norm",
     "kind": "baseline", "value": 8.0, "for": 5, "window": 600,
     "cooldown": 300, "severity": "warn",
     "description": "grad norm jumped far off its rolling baseline"},
    {"id": "reward_drift", "metric": "train/task_reward",
     "kind": "baseline", "value": 8.0, "for": 30, "window": 1200,
     "cooldown": 900, "severity": "warn",
     "description": "task reward moved far off its rolling baseline "
                    "(reward hacking or a broken grader)"},
    {"id": "staleness_runaway", "metric": "train/staleness_lag",
     "kind": "threshold", "op": "gt", "value": 16.0, "for": 60,
     "cooldown": 600, "severity": "warn",
     "description": "trained samples lag many weight versions behind: "
                    "the staleness gate is not holding"},
    # Short grace + compile-aware suppression: the rule is suppressed only
    # while compile/inflight (or a worker's names.compile_inflight flag)
    # says a compile — in the port, the kernel build — is in progress, so
    # a cold start stays quiet and a wedged trainer alerts in minutes.
    {"id": "trainer_stalled", "metric": "train/optimizer_steps",
     "kind": "absence", "for": 300, "cooldown": 1800,
     "severity": "critical", "unless": "compile/inflight",
     "description": "no optimizer step in 5 minutes and no compile in "
                    "flight: the training pipeline is wedged"},
    {"id": "fleet_down", "metric": "gsmgr/healthy_servers",
     "kind": "threshold", "op": "lt", "value": 1.0, "for": 60,
     "cooldown": 300, "severity": "critical",
     "description": "no routable generation server"},
    {"id": "step_time_regression", "metric": "master/step_secs",
     "kind": "baseline", "value": 10.0, "for": 30, "window": 1800,
     "cooldown": 900, "severity": "warn",
     "description": "step wall time far off its rolling baseline "
                    "(throughput regression)"},
    # Only has data on MoE runs: dense models never export the series,
    # so the rule stays silent (baseline rules need samples to fire).
    {"id": "expert_collapse", "metric": "train/moe_expert_load_ratio",
     "kind": "baseline", "value": 8.0, "for": 30, "window": 1200,
     "cooldown": 900, "severity": "warn",
     "description": "expert load max/mean ratio jumped far off its "
                    "rolling baseline: routing is collapsing onto a few "
                    "experts — check train/moe_expert_load_dist and the "
                    "load-balance loss coefficient"},
    # Needs goodput.enabled (the fleet/goodput series only exists when
    # the ledger runs); with goodput off the rule simply never has data,
    # like every rule on a disabled subsystem's metrics.
    {"id": "goodput_collapse", "metric": "fleet/goodput",
     "kind": "baseline", "value": 8.0, "for": 60, "window": 1200,
     "cooldown": 900, "severity": "warn", "agg": "mean",
     "description": "fleet goodput (useful chip-seconds / total) fell "
                    "far off its rolling baseline: chips went idle — "
                    "check the per-state split (perf_probe goodput) for "
                    "which side starved"},
)


# Armed only when durability.enabled (rules_from_config): an absence
# rule fires even for a never-seen metric, so shipping this in the
# always-on pack would false-fire on every non-durable run.
DURABILITY_RULES: Tuple[Dict[str, Any], ...] = (
    {"id": "sample_loss", "metric": "spool/acked", "kind": "absence",
     "for": 1800, "cooldown": 1800, "severity": "critical",
     "description": "no spool ack in 30 minutes: trajectories are being "
                    "generated but never settle at the trainer — the "
                    "at-least-once loop is broken somewhere between push, "
                    "train, and ack (perf_probe spool-status; "
                    "docs/operations.md §Did we lose samples?)"},
)


# Armed only when compile_watch.enabled (rules_from_config): the series
# these watch exist only with the observatory on, and compile_stall is a
# threshold on a gauge a disabled fleet never exports. Thresholds follow
# the default-pack philosophy — a healthy warmup fires nothing.
COMPILE_RULES: Tuple[Dict[str, Any], ...] = (
    # ~2 storms/100s sustained: one stray shape after warmup is a blip
    # (logged + counted, no alert); a steady drip means something feeds
    # the jit unbucketed shapes every step (docs/operations.md §my step
    # got slow).
    {"id": "recompile_storm", "metric": "compile/storm_events",
     "kind": "rate", "op": "gt", "value": 0.02, "for": 10, "window": 120,
     "cooldown": 600, "severity": "warn",
     "description": "recompiles of previously-stable jit functions keep "
                    "arriving after warmup: shape churn is defeating the "
                    "bucketing (perf_probe compile-status names the fn "
                    "and offending shape)"},
    {"id": "hbm_pressure", "metric": "hbm/utilization",
     "kind": "threshold", "op": "gt", "value": 0.92, "for": 60,
     "cooldown": 600, "severity": "warn", "agg": "max",
     "description": "a device sits above 92% HBM for a minute: the next "
                    "weight publish or shape spike OOMs — check "
                    "hbm/watermark_bytes for which allocator owns the "
                    "peak (docs/weight_sync.md §HBM headroom)"},
    # 20 min inside ONE compile: even pathological warmup compiles
    # finish in minutes — a compile/inflight gauge stuck >= 1 this long
    # means the compile itself hung (or the end-hook never ran).
    {"id": "compile_stall", "metric": "compile/inflight",
     "kind": "threshold", "op": "ge", "value": 1.0, "for": 1200,
     "cooldown": 1800, "severity": "critical",
     "description": "a jit compile has been in flight for 20+ minutes: "
                    "the run is wedged inside XLA, not between steps"},
)


def _dur_field(raw: Dict[str, Any], rule_id: str, *keys,
               default: Optional[float] = None) -> Optional[float]:
    for k in keys:
        if k in raw:
            try:
                return parse_duration(raw[k])
            except ValueError as e:
                raise SentinelConfigError(
                    f"rule {rule_id!r}: bad {keys[0]!r} duration: {e}"
                ) from None
    return default


def parse_rule(raw: Dict[str, Any],
               catalog: Optional[frozenset] = None) -> Rule:
    if not isinstance(raw, dict):
        raise SentinelConfigError(
            f"each sentinel rule must be a mapping, got {type(raw).__name__}"
        )
    rid = str(raw.get("id") or "").strip()
    if not rid:
        raise SentinelConfigError(
            f"sentinel rule without an 'id': {raw!r}"
        )
    metric = str(raw.get("metric") or "").strip()
    catalog = catalog if catalog is not None else METRIC_CATALOG
    if metric not in catalog:
        close = difflib.get_close_matches(metric, sorted(catalog), n=3)
        hint = f" (did you mean: {', '.join(close)}?)" if close else ""
        raise SentinelConfigError(
            f"rule {rid!r}: unknown metric {metric!r}{hint}; the sentinel "
            f"only evaluates names in system/sentinel.METRIC_CATALOG "
            f"(docs/observability.md)"
        )
    kind = str(raw.get("kind", "threshold"))
    if kind not in RULE_KINDS:
        raise SentinelConfigError(
            f"rule {rid!r}: unknown kind {kind!r} "
            f"(valid: {', '.join(RULE_KINDS)})"
        )
    severity = str(raw.get("severity", "warn"))
    if severity not in SEVERITIES:
        raise SentinelConfigError(
            f"rule {rid!r}: unknown severity {severity!r} "
            f"(valid: {', '.join(SEVERITIES)})"
        )
    op = str(raw.get("op", "gt"))
    if op not in OPS:
        raise SentinelConfigError(
            f"rule {rid!r}: unknown op {op!r} (valid: {', '.join(OPS)})"
        )
    agg = str(raw.get("agg", "max"))
    if agg not in AGGS:
        raise SentinelConfigError(
            f"rule {rid!r}: unknown agg {agg!r} (valid: {', '.join(AGGS)})"
        )
    action = str(raw.get("action", "evidence"))
    if action not in ACTIONS:
        raise SentinelConfigError(
            f"rule {rid!r}: unknown action {action!r} "
            f"(valid: {', '.join(ACTIONS)})"
        )
    for_secs = _dur_field(raw, rid, "for", "for_secs", default=10.0)
    cooldown = _dur_field(raw, rid, "cooldown", "cooldown_secs",
                          default=300.0)
    window = _dur_field(raw, rid, "window", "window_secs", default=120.0)
    if for_secs is None or for_secs <= 0:
        raise SentinelConfigError(
            f"rule {rid!r}: 'for' must be a positive duration "
            f"(got {for_secs})"
        )
    if cooldown is None or cooldown <= 0:
        raise SentinelConfigError(
            f"rule {rid!r}: 'cooldown' must be a positive duration "
            f"(got {cooldown})"
        )
    if window is None or window <= 0:
        raise SentinelConfigError(
            f"rule {rid!r}: 'window' must be a positive duration "
            f"(got {window})"
        )
    try:
        value = float(raw.get("value", 0.0))
    except (TypeError, ValueError):
        raise SentinelConfigError(
            f"rule {rid!r}: 'value' must be a number, "
            f"got {raw.get('value')!r}"
        ) from None
    if kind == "baseline" and value <= 0:
        raise SentinelConfigError(
            f"rule {rid!r}: baseline rules need value > 0 "
            f"(the deviation multiplier)"
        )
    unless = raw.get("unless")
    if unless is not None:
        unless = str(unless).strip()
        if kind != "absence":
            raise SentinelConfigError(
                f"rule {rid!r}: 'unless' only applies to absence rules "
                f"(it suppresses the missing-progress predicate while "
                f"the named metric is live)"
            )
        if unless not in catalog:
            close = difflib.get_close_matches(unless, sorted(catalog), n=3)
            hint = f" (did you mean: {', '.join(close)}?)" if close else ""
            raise SentinelConfigError(
                f"rule {rid!r}: unknown 'unless' metric {unless!r}{hint}"
            )
    return Rule(
        id=rid, metric=metric, kind=kind, op=op, value=value,
        for_secs=for_secs, cooldown_secs=cooldown, severity=severity,
        window_secs=window, agg=agg, action=action,
        description=str(raw.get("description", "")),
        unless_metric=unless,
    )


def parse_rules(raw_rules: Sequence[Dict[str, Any]],
                catalog: Optional[frozenset] = None) -> List[Rule]:
    rules = [parse_rule(r, catalog=catalog) for r in raw_rules]
    seen: Dict[str, int] = {}
    for r in rules:
        seen[r.id] = seen.get(r.id, 0) + 1
    dups = sorted(k for k, n in seen.items() if n > 1)
    if dups:
        raise SentinelConfigError(
            f"duplicate sentinel rule id(s): {', '.join(dups)} — every "
            f"rule needs a unique id (alert records, silences, and the "
            f"areal_alerts_total label key on it)"
        )
    return rules


def rules_from_config(cfg, durability_enabled: bool = False,
                      compile_watch_enabled: bool = False) -> List[Rule]:
    """``SentinelConfig`` → parsed rule list: the default pack (unless
    ``default_rules=false``), the durability pack when the durable
    sample spool is armed, the compile/HBM pack when the compile
    observatory is armed, plus the operator's ``rules`` entries. This
    is the function ``validate_config`` front-runs at parse time."""
    raw: List[Dict[str, Any]] = []
    if getattr(cfg, "default_rules", True):
        raw.extend(dict(r) for r in DEFAULT_RULES)
        if durability_enabled:
            raw.extend(dict(r) for r in DURABILITY_RULES)
        if compile_watch_enabled:
            raw.extend(dict(r) for r in COMPILE_RULES)
    raw.extend(getattr(cfg, "rules", []) or [])
    return parse_rules(raw)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


class _Series:
    """Per-source ``(value, t)`` readings (source = ``worker|metric-key``)
    + when any source last reported a NEW value. Rings of the aggregated
    value live per RULE (two rules may aggregate the same metric
    differently).

    ``last_seen`` refreshes only when a value CHANGES (or a source first
    appears): workers flush their full cumulative registry every
    interval, so mere sample arrival proves the worker process is alive,
    not that the activity the metric counts is still happening — an
    absence rule on ``train/optimizer_steps`` must catch a trainer that
    is wedged-but-flushing, not just a dead one. (Absence rules are
    therefore meant for counters/activity series, not for gauges that
    legitimately sit constant.)"""

    __slots__ = ("latest", "last_seen")

    def __init__(self):
        self.latest: Dict[str, Tuple[float, float]] = {}  # src -> (v, t)
        self.last_seen: Optional[float] = None


class _RuleState:
    __slots__ = ("rule", "state", "pending_since", "last_fired",
                 "fire_count", "ring", "last_value")

    def __init__(self, rule: Rule, eval_interval_secs: float = 1.0):
        self.rule = rule
        self.state = "ok"  # ok | pending | firing
        self.pending_since: Optional[float] = None
        self.last_fired: Optional[float] = None
        self.fire_count = 0
        # (monotonic t, aggregated value) appended once per eval tick —
        # sized so the rule's OWN window fits (a fixed length would
        # silently truncate long baseline windows), bounded for memory.
        points = int(rule.window_secs / max(eval_interval_secs, 1e-3)) + 8
        self.ring: "collections.deque[Tuple[float, float]]" = (
            collections.deque(maxlen=max(64, min(points, 7200)))
        )
        self.last_value: Optional[float] = None


def _agg(values: Sequence[float], how: str) -> float:
    if how == "max":
        return max(values)
    if how == "min":
        return min(values)
    if how == "sum":
        return sum(values)
    return sum(values) / len(values)


class Sentinel:
    """The rule-driven health engine. Thread-safe; creates no threads of
    its own — ``feed()`` is called by the aggregator's ingest path (and
    directly by the master's step loop), ``tick()`` by the aggregator's
    poll loop. Every clock/side-effect is injectable for fake-clock
    tests; the defaults wire the real fleet hooks:

    - ``flight_fn(dir)``   → :func:`telemetry.request_flight_dump`
    - ``profile_fn(dir,s)``→ :func:`telemetry.request_profiler_capture`
    - ``inhibit_fn(rec)``  → write ``names.autoscale_inhibit``
    - ``pause_fn()``       → WorkerControlPanel.pause("master") in a
      one-shot thread (spawned only at that moment)
    """

    def __init__(self, cfg, experiment: str, trial: str, *,
                 rules: Optional[List[Rule]] = None,
                 registry: Optional["telemetry.TelemetryRegistry"] = None,
                 stitcher=None,
                 alerts_path: Optional[str] = None,
                 evidence_dir: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time,
                 flight_fn: Optional[Callable[[str], Any]] = None,
                 profile_fn: Optional[Callable[[str, float], Any]] = None,
                 inhibit_fn: Optional[Callable[[Dict], Any]] = None,
                 pause_fn: Optional[Callable[[], Any]] = None):
        self.cfg = cfg
        self.experiment = experiment
        self.trial = trial
        self.registry = registry or telemetry.TelemetryRegistry()
        self.stitcher = stitcher
        self.clock = clock
        self.wall = wall
        self.alerts_path = alerts_path or getattr(cfg, "alerts_path", None)
        self.evidence_dir = (evidence_dir
                             or getattr(cfg, "evidence_dir", None))
        self._flight_fn = flight_fn or self._default_flight
        self._profile_fn = profile_fn or self._default_profile
        self._inhibit_fn = inhibit_fn or self._default_inhibit
        self._pause_fn = pause_fn or self._default_pause
        self._lock = threading.Lock()
        self._emit_lock = threading.Lock()
        self._series: Dict[str, _Series] = {}
        # rule id -> cached silence expiry (wall clock): lets the eval
        # loop suppress a silenced alert without per-tick name-resolve
        # reads; refreshed by _silenced() at real fire attempts.
        self._silence_until: Dict[str, float] = {}
        interval = getattr(cfg, "eval_interval_secs", 1.0)
        self._states = [
            _RuleState(r, eval_interval_secs=interval)
            for r in (rules if rules is not None else rules_from_config(cfg))
        ]
        self._alerts_file = None
        self._last_eval: Optional[float] = None
        self._bundles = 0
        self._t_start = clock()
        self.registry.set_gauge("sentinel/rules", float(len(self._states)))

    # ---- ingest ----

    def feed(self, worker: str, gauges: Optional[Dict[str, float]] = None,
             counters: Optional[Dict[str, float]] = None,
             now: Optional[float] = None) -> None:
        """Record one worker's latest gauge/counter values. Inline label
        suffixes (``train/grad_norm{mfc=actor_train}``) are folded into
        the base metric's source set, so one rule watches the whole
        family across workers AND label values."""
        now = self.clock() if now is None else now
        with self._lock:
            for src in (gauges, counters):
                for key, v in (src or {}).items():
                    if not isinstance(v, (int, float)) \
                            or not math.isfinite(v):
                        continue
                    base, _labels = telemetry._metric_key_labels(key)
                    s = self._series.get(base)
                    if s is None:
                        s = self._series[base] = _Series()
                    sk = f"{worker}|{key}"
                    prev = s.latest.get(sk)
                    s.latest[sk] = (float(v), now)
                    if prev is None or prev[0] != float(v):
                        s.last_seen = now  # NEW value, not mere arrival

    # ---- evaluation ----

    def tick(self, now: Optional[float] = None) -> None:
        """Evaluate every rule (rate-limited to ``eval_interval_secs``).
        Called from the aggregator's poll loop; safe from any thread."""
        now = self.clock() if now is None else now
        interval = getattr(self.cfg, "eval_interval_secs", 1.0)
        fired: List[Tuple[_RuleState, Dict]] = []
        resolved: List[Tuple[_RuleState, Dict]] = []
        wall_now = self.wall()
        with self._lock:
            if self._last_eval is not None \
                    and now - self._last_eval < interval:
                return
            self._last_eval = now
            # Expire sources that stopped reporting (scaled-down /
            # evicted workers): a departed worker's last gauge must not
            # pin a max/sum aggregate — and a false alert — forever.
            expiry = getattr(self.cfg, "source_expiry_secs", 120.0)
            for s in self._series.values():
                stale = [k for k, (_, t) in s.latest.items()
                         if now - t > expiry]
                for k in stale:
                    del s.latest[k]
            for st in self._states:
                self._eval_rule(st, now, wall_now, fired, resolved)
        # Side effects (file appends, evidence, inhibit, pause) run
        # OUTSIDE the lock: none of them may stall feed().
        for st, rec in resolved:
            self._emit(rec)
        for st, rec in fired:
            self._on_fire(st, rec)

    def _eval_rule(self, st: _RuleState, now: float, wall_now: float,
                   fired: List, resolved: List) -> None:
        r = st.rule
        s = self._series.get(r.metric)
        cur: Optional[float] = None
        if s is not None and s.latest:
            cur = _agg([v for v, _ in s.latest.values()], r.agg)
            st.ring.append((now, cur))
            st.last_value = cur
        active = self._predicate(st, s, cur, now)
        if active and st.state == "ok":
            st.state = "pending"
            st.pending_since = now
        elif not active:
            if st.state == "firing":
                since = (st.pending_since
                         if st.pending_since is not None else now)
                resolved.append((st, {
                    "event": "resolved", "rule": r.id,
                    "severity": r.severity, "metric": r.metric,
                    "value": cur, "ts": round(self.wall(), 3),
                    "active_secs": round(now - since, 3),
                }))
                self.registry.set_gauge(
                    f"alert_active{{rule={r.id}}}", 0.0)
            st.state = "ok"
            st.pending_since = None
            return
        # Absence rules carry their own duration in the predicate (the
        # silence IS the `for:` window) — they fire the tick they trip.
        since = st.pending_since if st.pending_since is not None else now
        held = now - since >= r.for_secs or r.kind == "absence"
        if st.state == "pending" and held:
            if st.last_fired is not None \
                    and now - st.last_fired < r.cooldown_secs:
                return  # cooling down: stay pending
            if self._silence_until.get(r.id, 0.0) > wall_now:
                # Cached operator silence: stay pending with zero I/O —
                # an active alert under a long silence must not hit
                # name-resolve (or bump counters) every tick.
                return
            # The fresh silence lookup (name-resolve I/O) happens in
            # _on_fire, OUTSIDE the engine lock — a slow NFS mount must
            # never stall feed() from the ingest path. A silenced fire
            # is rolled back to pending there and its expiry cached.
            st.state = "firing"
            st.last_fired = now
            st.fire_count += 1
            fired.append((st, {
                "event": "firing", "rule": r.id, "severity": r.severity,
                "kind": r.kind, "metric": r.metric, "value": cur,
                "threshold": r.value, "for_secs": r.for_secs,
                "ts": round(self.wall(), 3),
                "description": r.description,
            }))

    def _predicate(self, st: _RuleState, s: Optional[_Series],
                   cur: Optional[float], now: float) -> bool:
        r = st.rule
        if r.kind == "absence":
            if r.unless_metric is not None:
                # Compile-aware suppression: a live nonzero reading on
                # the unless-metric family (any worker, any label) means
                # the absence is EXPLAINED — the worker is inside a jit
                # compile, not wedged. Source expiry already dropped
                # stale readings, so a SIGKILLed worker's last gauge
                # stops suppressing within source_expiry_secs.
                u = self._series.get(r.unless_metric)
                if u is not None and any(
                    v > 0 for v, _ in u.latest.values()
                ):
                    return False
            # Grace from sentinel start: a metric never seen only counts
            # as absent once the run is older than the rule's window.
            last = s.last_seen if (s and s.last_seen is not None) \
                else self._t_start
            return now - last > r.for_secs
        if cur is None:
            return False
        if r.kind == "threshold":
            return OPS[r.op](cur, r.value)
        pts = [(t, v) for t, v in st.ring if t >= now - r.window_secs]
        if r.kind == "rate":
            if len(pts) < 2:
                return False
            t0, v0 = pts[0]
            t1, v1 = pts[-1]
            if t1 - t0 <= 0:
                return False
            return OPS[r.op]((v1 - v0) / (t1 - t0), r.value)
        # baseline: robust z-score of the latest point against the
        # window — median/MAD, not mean/std, so an anomaly that persists
        # for a few ticks cannot poison its own baseline and self-clear
        # (the classic self-referential threshold bug). The relative
        # floor (5% of |median|) keeps a near-constant series from
        # firing on jitter.
        base = sorted(v for _, v in pts[:-1])
        if len(base) < 8:
            return False
        med = base[len(base) // 2]
        mad = sorted(abs(v - med) for v in base)[len(base) // 2]
        scale = max(1.4826 * mad, 0.05 * abs(med), 1e-12)
        return abs(cur - med) > r.value * scale

    # ---- silences (names.sentinel_silence: {until, rule}) ----

    def _silenced(self, rule: Rule) -> bool:
        """Fresh name-resolve read of the rule's silence (called only at
        an actual fire attempt, never under the engine lock); a live
        silence is cached so subsequent ticks suppress in memory."""
        try:
            raw = name_resolve.get(names.sentinel_silence(
                self.experiment, self.trial, rule.id))
        except Exception:  # noqa: BLE001 — no silence registered
            return False
        try:
            until = float(json.loads(raw).get("until", 0.0))
        except Exception:  # noqa: BLE001 — torn write
            return False
        if self.wall() < until:
            with self._lock:
                self._silence_until[rule.id] = until
            return True
        return False

    # ---- compile-aware suppression (base/compile_watch.py) ----

    def _compile_inflight_fresh(self, max_age_secs: float = 60.0) -> bool:
        """Fresh name-resolve read of every worker's
        ``names.compile_inflight`` flag (called only at an actual fire
        attempt of an unless-guarded absence rule, never under the
        engine lock — same discipline as :meth:`_silenced`). The metric
        path above already suppresses in-memory; this catches the gap
        where a worker is wedged INSIDE a compile and its telemetry
        flush (but not its heartbeat thread) stopped. Flags are
        rewritten every heartbeat, so anything older than
        ``max_age_secs`` is a dead worker's ghost and does not
        suppress."""
        try:
            vals = name_resolve.get_subtree(
                names.compile_inflight_root(self.experiment, self.trial))
        except Exception:  # noqa: BLE001 — no flags registered
            return False
        now = self.wall()
        for raw in vals:
            try:
                ts = float(json.loads(raw).get("ts", 0.0))
            except Exception:  # noqa: BLE001 — torn write
                continue
            if now - ts < max_age_secs:
                return True
        return False

    # ---- firing side effects ----

    def _on_fire(self, st: _RuleState, rec: Dict) -> None:
        r = st.rule
        if r.kind == "absence" and r.unless_metric is not None \
                and self._compile_inflight_fresh():
            # Roll back to pending exactly like a silence: the compile
            # drains, the flag disappears, and the next tick re-attempts
            # with the `for:` hold still satisfied.
            with self._lock:
                if st.state == "firing":
                    st.state = "pending"
                st.last_fired = None
                st.fire_count -= 1
            self.registry.inc(
                f"sentinel/compile_suppressed{{rule={r.id}}}")
            return
        if self._silenced(r):
            # Operator silence: roll the transition back to pending (the
            # `for:` hold stays satisfied; the next tick re-attempts) and
            # burn neither the cooldown nor an evidence bundle.
            with self._lock:
                if st.state == "firing":
                    st.state = "pending"
                st.last_fired = None
                st.fire_count -= 1
            self.registry.inc(f"sentinel/silenced{{rule={r.id}}}")
            return
        self.registry.inc(f"alerts{{rule={r.id},severity={r.severity}}}")
        self.registry.set_gauge(f"alert_active{{rule={r.id}}}", 1.0)
        logger.warning(
            f"ALERT {r.severity} {r.id}: {r.metric}={rec.get('value')} "
            f"({r.description or r.kind})"
        )
        evidence = None
        if r.severity in ("warn", "critical"):
            evidence = self._capture_evidence(st, rec)
            if evidence:
                rec["evidence_dir"] = evidence
        if r.severity == "critical" \
                and getattr(self.cfg, "autoscale_inhibit", True):
            try:
                self._inhibit_fn(rec)
                rec["autoscale_inhibited"] = True
            except Exception as e:  # noqa: BLE001 — hint is best-effort
                logger.warning(f"autoscale inhibit publish failed: {e}")
        if r.action == "pause":
            if getattr(self.cfg, "allow_pause", False):
                rec["pause_requested"] = True
                try:
                    self._pause_fn()
                except Exception as e:  # noqa: BLE001
                    logger.warning(f"sentinel pause request failed: {e}")
            else:
                rec["pause_requested"] = False
        self._emit(rec)

    def _capture_evidence(self, st: _RuleState,
                          rec: Dict) -> Optional[str]:
        """Bundle the anomaly's context while it is still live:
        ``evidence/<rule>-<ts>/`` with the alert + triggering metric
        window, a fleet-wide flight-dump trigger, pinned recent stitched
        trace ids, and (optionally, critical only) a trainer profiler
        capture. Never raises — evidence is best-effort."""
        if not self.evidence_dir:
            return None
        cap = getattr(self.cfg, "max_evidence_bundles", 8)
        if self._bundles >= cap:
            self.registry.inc("sentinel/evidence_skipped")
            return None
        try:
            d = os.path.join(
                self.evidence_dir,
                f"{st.rule.id}-{int(self.wall() * 1000)}",
            )
            os.makedirs(d, exist_ok=True)
            with self._lock:
                window = [
                    {"t": round(t, 3), "value": v} for t, v in st.ring
                ]
                series = self._series.get(st.rule.metric)
                sources = (
                    {k: v for k, (v, _) in series.latest.items()}
                    if series else {}
                )
            with open(os.path.join(d, "alert.json"), "w") as f:
                json.dump({
                    **rec,
                    "metric_window": window[-240:],
                    "sources": sources,
                }, f, indent=1, sort_keys=True)
            self._flight_fn(d)
            pinned = []
            if self.stitcher is not None:
                try:
                    pinned = self.stitcher.recent_trace_ids(
                        getattr(self.cfg, "pinned_traces", 8))
                except Exception:  # noqa: BLE001
                    pinned = []
            with open(os.path.join(d, "traces.json"), "w") as f:
                json.dump({"pinned_trace_ids": pinned}, f)
            if st.rule.severity == "critical" \
                    and getattr(self.cfg, "profile_on_critical", False):
                self._profile_fn(
                    os.path.join(d, "profile"),
                    getattr(self.cfg, "profile_secs", 5.0),
                )
            self._bundles += 1
            self.registry.inc("sentinel/evidence_bundles")
            return d
        except Exception as e:  # noqa: BLE001 — never kill the aggregator
            logger.warning(f"evidence capture for {st.rule.id} failed: {e}")
            return None

    # ---- default fleet hooks ----

    def _default_flight(self, out_dir: str) -> None:
        telemetry.request_flight_dump(self.experiment, self.trial, out_dir)

    def _default_profile(self, out_dir: str, secs: float) -> None:
        telemetry.request_profiler_capture(
            self.experiment, self.trial, out_dir, secs)

    def _default_inhibit(self, rec: Dict) -> None:
        """Publish the autoscale-inhibit hint: while it is live the
        manager's scaling loop suppresses scale-up (growing the fleet
        into a diverging run only burns capacity and deepens
        off-policyness) — system/autoscaler.read_inhibit."""
        name_resolve.add(
            names.autoscale_inhibit(self.experiment, self.trial),
            json.dumps({
                "until": self.wall() + getattr(
                    self.cfg, "inhibit_secs", 300.0),
                "rule": rec.get("rule"), "ts": rec.get("ts"),
            }),
            replace=True, delete_on_exit=False,
        )

    def _default_pause(self) -> None:
        """Command a master pause at the next step boundary (the
        WorkerControl panel) from a one-shot thread — the panel's calls
        block and must never hold up the aggregator's ingest loop."""
        exp, trial = self.experiment, self.trial

        def run():
            from areal_tpu_torch.system.worker_base import WorkerControlPanel

            panel = WorkerControlPanel(exp, trial, timeout=30.0)
            try:
                st = panel.pause("master")
                logger.warning(f"sentinel paused the master: {st}")
            except Exception as e:  # noqa: BLE001 — master busy/gone
                logger.warning(f"sentinel master pause failed: {e}")
            finally:
                panel.close()

        threading.Thread(target=run, daemon=True,
                         name="sentinel-pause").start()

    # ---- output ----

    def _emit(self, rec: Dict) -> None:
        # Both the master's step loop and the aggregator's ingest loop
        # may tick concurrently; one lock keeps alert lines whole.
        if not self.alerts_path:
            return
        try:
            with self._emit_lock:
                if self._alerts_file is None:
                    os.makedirs(os.path.dirname(self.alerts_path) or ".",
                                exist_ok=True)
                    self._alerts_file = open(self.alerts_path, "a",
                                             buffering=1)
                self._alerts_file.write(json.dumps(rec) + "\n")
        except Exception as e:  # noqa: BLE001 — alerting must not kill
            logger.warning(f"alert append failed: {e}")

    # ---- views ----

    def states(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {
                st.rule.id: {
                    "state": st.state, "severity": st.rule.severity,
                    "metric": st.rule.metric, "value": st.last_value,
                    "fires": st.fire_count,
                }
                for st in self._states
            }

    def close(self) -> None:
        with self._emit_lock:
            if self._alerts_file is not None:
                self._alerts_file.close()
                self._alerts_file = None
