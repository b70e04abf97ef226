"""Optimizer, weight-sync, observability and save/eval configuration.

The port's own copies of ``OptimizerConfig``, ``WeightSyncConfig``,
``TelemetryConfig``, ``GoodputConfig``, ``CompileWatchConfig``,
``SentinelConfig``, ``ServingConfig``, ``RewardServiceConfig``,
``AutoscaleConfig``, ``FaultToleranceConfig``, ``DurabilityConfig`` and
``ExperimentSaveEvalControl`` from ``areal_tpu/api/train_config.py``, with
the same fields and defaults. Every observability block, the serving
engine, the reward-service fleet, the autoscaler and the durable spool are
off by default; supervision is on.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class OptimizerConfig:
    """Reference cli_args.py:173 (OptimizerConfig)."""

    type: str = "adamw"  # adamw | sgd
    lr: float = 1e-5
    weight_decay: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-5
    min_lr_ratio: float = 0.0
    warmup_steps_proportion: float = 0.02
    lr_scheduler_type: str = "constant"  # constant | cosine | linear
    gradient_clipping: float = 1.0
    # Adam moment storage dtypes (master params are always f32; the moment
    # math runs in f32 whatever the storage). Both default to exact f32:
    # bf16 halves the optimizer's memory at the cost of rounding the
    # carried state.
    mu_dtype: Optional[str] = "float32"
    nu_dtype: Optional[str] = "float32"


@dataclasses.dataclass
class WeightSyncConfig:
    """Trainer → generation-server weight transport.

    ``stream`` serves per-tensor chunks from the trainer's host cache over
    TCP (``system/weight_stream.py``); ``disk`` writes a native checkpoint
    under the trainer's ``realloc_dir``; ``device`` keeps the weights on the
    GPUs: the trainer packs its compute-dtype weights into device buffers
    in the generation fleet's layout (one per ``tp`` rank of a server) and
    hands the servers their CUDA IPC handles, and each server rank copies
    its buffer into its own weights device to device
    (``parallel/reshard.py``; the trainer's GPU must be visible to the
    servers, as the launcher arranges)."""

    transport: str = "stream"  # stream | disk | device
    # Wire chunk size (MB) of the streamed transport.
    chunk_mb: int = 32
    # The servers' window of in-flight chunk requests (the experiments
    # thread it into GenerationServerConfig.weight_stream_pipeline_depth).
    pipeline_depth: int = 4
    # Device transport: the transfer-group byte budget (MB) of a publish —
    # its extra device memory is the packed buffers plus about one group
    # of whole compute-dtype tensors (gathered from a mesh).
    transfer_group_mb: int = 64
    # Device transport: the generation fleet's ParallelSpec (e.g. "d2t2").
    # None publishes whole tensors, the layout un-meshed servers hold;
    # decoupled experiments thread AllocationMode.gen_spec through here.
    gen_parallel_spec: Optional[str] = None

    def __post_init__(self):
        if self.transport not in ("stream", "disk", "device"):
            raise ValueError(
                f"unknown weight_sync.transport {self.transport!r}")


@dataclasses.dataclass
class TelemetryConfig:
    """Unified telemetry layer (``base/telemetry.py``).

    Off by default: with ``enabled=False`` every instrumented call site
    routes to a shared no-op sink — no sockets, no HTTP servers, no span
    allocation — so the hot paths carry no passive overhead."""

    enabled: bool = False
    # Worker→aggregator snapshot push cadence.
    flush_interval_secs: float = 2.0
    # Aggregated per-snapshot stream; defaults under the experiment log
    # dir (<log>/telemetry.jsonl) when the experiment tree wires it.
    jsonl_path: Optional[str] = None
    # >0: the master's aggregator serves the merged fleet state as
    # Prometheus text on this plain-HTTP port (GET /metrics).
    http_port: int = 0
    # Span buffer bound per process between flushes (oldest drop first).
    max_buffered_spans: int = 4096
    # Stitched end-to-end traces (one JSON line per trained sample);
    # defaults next to telemetry.jsonl when unset.
    traces_path: Optional[str] = None
    # How long a terminal span waits for sibling workers' slower span
    # flushes before the trace is stitched. Should exceed
    # flush_interval_secs; lower it together with the flush interval.
    stitch_grace_secs: float = 5.0
    # Per-worker crash-evidence ring of recent span/event records
    # (0 disables the ring entirely).
    flight_recorder_len: int = 512
    # Where flight_<worker>.jsonl dumps land on crash/SIGTERM/eviction.
    # None: no crash hooks are installed (on-demand dumps still work —
    # the trigger request carries its own directory).
    flight_dir: Optional[str] = None


@dataclasses.dataclass
class GoodputConfig:
    """Goodput ledger (``system/goodput.py``).

    Off by default: every worker gets the shared null ledger. Enabled
    (requires ``telemetry.enabled``), each worker classifies its wall
    clock into ``compute / comm / data_wait / idle`` counters, the
    trainer and the generation servers export live achieved-TFLOP/s and
    MFU gauges against the card's peak (``base/monitor.py``), and the
    master's aggregator stitches fleet goodput onto the merged scrape."""

    enabled: bool = False
    # Minimum interval between counter exports from a ledger into its
    # telemetry registry.
    export_interval_secs: float = 1.0
    # Override the per-card peak FLOP/s of the MFU gauges; 0 = from the
    # card's name (monitor.device_peak_flops). On an unknown device the
    # MFU gauges degrade to achieved-TFLOP/s-only with a one-time warning.
    peak_flops_override: float = 0.0


@dataclasses.dataclass
class CompileWatchConfig:
    """Compile & device-memory observatory (``base/compile_watch.py``,
    ``system/memwatch.py``).

    Off by default. Enabled (requires ``telemetry.enabled``), the kernel
    build at first use is recorded (``compile/events{fn=}``,
    ``compile/secs{fn=}``, ``compile/inflight``), every device-bearing
    worker samples its allocator's gauges with high-water marks around
    the big allocators, and the sentinel arms its compile/memory rules.
    The reference's ``storm_warmup_calls`` is left out: the port compiles
    no jitted function, so there is no recompile storm to detect."""

    enabled: bool = False
    # Min interval between device memory polls (samples piggyback on
    # worker cadences, so this bounds poll cost, not wakeups).
    mem_sample_interval_secs: float = 10.0


@dataclasses.dataclass
class SentinelConfig:
    """Training-health sentinel (``system/sentinel.py``).

    Off by default: nothing is constructed. Enabled (requires
    ``telemetry.enabled``), the master's aggregator hosts a rule engine
    over the merged fleet telemetry and the trainer's training-dynamics
    series; firing alerts land in ``alerts.jsonl``, export as
    ``areal_alerts_total{rule,severity}`` / ``areal_alert_active`` on the
    merged scrape, and capture evidence into ``evidence/<rule>-<ts>/``."""

    enabled: bool = False
    # Rule evaluation cadence inside the aggregator's ingest loop.
    eval_interval_secs: float = 1.0
    # Include the built-in rule pack (system/sentinel.DEFAULT_RULES).
    default_rules: bool = True
    # Extra rules (dicts in the rule grammar; validated at parse time).
    rules: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    # A source that has not reported within this window is dropped from
    # rule aggregation.
    source_expiry_secs: float = 120.0
    # Alert stream; defaults next to telemetry.jsonl.
    alerts_path: Optional[str] = None
    # Per-alert evidence bundles; defaults to <log>/evidence.
    evidence_dir: Optional[str] = None
    # Hard cap on bundles per run.
    max_evidence_bundles: int = 8
    # Critical alerts also request a trainer profiler capture into the
    # bundle (off by default: it costs trainer time).
    profile_on_critical: bool = False
    profile_secs: float = 5.0
    # How many recent stitched trace ids to pin into each bundle.
    pinned_traces: int = 8
    # Rules with action=pause may command a master pause.
    allow_pause: bool = False
    # Critical alerts publish an autoscale-inhibit hint.
    autoscale_inhibit: bool = True
    inhibit_secs: float = 300.0


@dataclasses.dataclass
class ServingConfig:
    """The generation fleet's serving engine (system/serving.py; reference
    train_config.py:227). Off by default: the server is then the
    rollout-only decode loop — one FIFO without admission limits, no
    cross-request KV reuse, capacities in unbounded ``kv_bucket``
    multiples. The distinct-shapes gauge is kept either way."""

    enabled: bool = False
    # Admission, per request class (0 = unbounded): a full class queue
    # answers 429 with a Retry-After hint.
    queue_limit_rollout: int = 512
    queue_limit_interactive: int = 64
    queue_limit_eval: int = 128
    retry_after_secs: float = 0.5
    # Share of each drained batch kept for waiting rollouts, in [0, 1]
    # (strict priority alone can starve them); 0 is strict priority.
    min_rollout_share: float = 0.25
    # Seed a request's decode state from another's retained KV where
    # their token prefixes agree, and prefill only the suffix.
    prefix_reuse: bool = True
    # Shorter shared prefixes prefill plainly.
    min_prefix_tokens: int = 4
    # Decode chunk buckets (empty: a factor-4 ladder down from
    # chunk_tokens) and batch-row buckets (empty: powers of two up to
    # max_batch_size).
    chunk_buckets: List[int] = dataclasses.field(default_factory=list)
    row_buckets: List[int] = dataclasses.field(default_factory=list)
    # KV capacities are kv_bucket * 2^k up to this ceiling; a prompt that
    # cannot fit answers 413.
    max_kv_capacity: int = 16384
    # The policy refuses bucket lists whose worst-case shape count (decode
    # + prefill + suffix extend) exceeds this.
    max_compiled_shapes: int = 512


@dataclasses.dataclass
class RewardServiceConfig:
    """The sandboxed reward service, the sixth worker kind
    (``system/reward_worker.py`` + ``rewards/service.py``; reference
    train_config.py:283).

    Off by default: grading then runs the local path in the calling
    process, bit for bit as without the service. Enabled, the launcher
    spawns ``n_workers`` CPU-only reward workers, each an HTTP fleet member
    grading math and code tasks, and the rollout and trainer reward paths
    fan out to them (``rewards/client.py``) with bounded concurrency, retry
    on a surviving replica and per-task degradation to local grading."""

    enabled: bool = False
    # One reward-worker process each; CPU-only.
    n_workers: int = 1
    # Fixed port of worker 0 (worker i binds port+i); 0 = free ports,
    # discovered through name_resolve either way.
    port: int = 0
    # ---- worker-side grading ----
    # Concurrent grades per worker, clamped to pool_size (an admitted task
    # starts grading at once, so its wall budget never times queue wait).
    max_inflight: int = 16
    # Grader threads per worker; a code grade runs its own rlimit-guarded
    # subprocess underneath.
    pool_size: int = 8
    # Server-side wall budget per task: an overrun answers score 0.0 with
    # verdict "timeout". Code tasks floor at their legal worst case.
    grade_timeout_secs: float = 30.0
    # Languages this fleet grades; others answer "unsupported_language".
    languages: List[str] = dataclasses.field(
        default_factory=lambda: ["python"])
    # ---- client-side fanout (rewards/client.py) ----
    # In-flight requests across one batch.
    max_concurrency: int = 64
    # Per-task HTTP timeout (queue wait + grading on the worker).
    request_timeout_secs: float = 120.0
    # Retries per task across surviving replicas before degrading.
    max_retries: int = 2
    retry_base_delay_secs: float = 0.2
    retry_max_delay_secs: float = 2.0
    # Degrade to local grading when a task's retries run out; False scores
    # it 0.0 instead of running untrusted code in the calling process.
    local_fallback: bool = True


@dataclasses.dataclass
class AutoscaleConfig:
    """The elastic generation fleet (``system/autoscaler.py``; reference
    train_config.py:341).

    Off by default. Enabled, the gserver manager runs a slow control loop
    that sets a target fleet size from its own signals (rollout capacity
    utilization, per-server queue depth, the staleness gate, time-to-first-
    chunk SLO misses, weight-fanout ack latency, heartbeat ages) with
    hysteresis and cooldowns, publishes the plan through name_resolve, and
    the launcher's executor spawns supervised single-server workers to meet
    it. Scale-down and straggler defense go through the manager's cordon:
    the server stops receiving leases, its rollouts drain (or fail over),
    then a commanded exit reaps a dynamic server."""

    enabled: bool = False
    # Bounds on the routable server count.
    min_servers: int = 1
    max_servers: int = 4
    # Cadence of the manager's control loop.
    interval_secs: float = 5.0
    # Rollout capacity utilization (running / max_concurrent_rollouts).
    up_utilization: float = 0.85
    down_utilization: float = 0.25
    # Mean per-server decode queue depth (from /health).
    queue_high: float = 8.0
    queue_low: float = 1.0
    # Time-to-first-chunk SLO (0 disables): scale up when at least
    # slo_miss_fraction of the servers miss it.
    slo_ttfc_secs: float = 0.0
    slo_miss_fraction: float = 0.5
    # Weight-fanout ack latency high-water (0 disables).
    fanout_ack_high_secs: float = 0.0
    # Hysteresis and cooldowns (both directions move one server a step).
    up_consecutive: int = 2
    down_consecutive: int = 5
    scale_up_cooldown_secs: float = 30.0
    scale_down_cooldown_secs: float = 120.0
    # How long a cordoned server may drain before its exit goes ahead
    # anyway (clients fail over by chunk replay).
    drain_timeout_secs: float = 120.0
    # Straggler defense on per-server decode-latency EWMAs: "slow" past
    # factor x the peers' median for straggler_slow_sweeps sweeps
    # (deprioritized), cordoned after straggler_cordon_sweeps; samples
    # below floor_secs are noise.
    straggler_defense: bool = True
    straggler_factor: float = 3.0
    straggler_min_probes: int = 5
    straggler_slow_sweeps: int = 2
    straggler_cordon_sweeps: int = 6
    straggler_floor_secs: float = 0.002
    # Pinned at max_servers and still saturated: capacity denials of
    # /allocate_rollout carry this Retry-After hint.
    backpressure_retry_secs: float = 2.0


@dataclasses.dataclass
class FaultToleranceConfig:
    """Launcher-level supervision and liveness (``system/supervisor.py``;
    reference train_config.py:407).

    Stateless workers (rollout workers, the generation-fleet process, the
    reward workers) are respawned in place with exponential backoff behind
    a crash-loop circuit breaker; a stateful worker's death (the trainer)
    escalates to ``run_experiment``'s ``recover_mode=auto`` relaunch.
    Supervised workers lease their name-resolve advertisements for
    ``keepalive_ttl_secs`` and heartbeat them from a thread of their own."""

    # False: any child death fails the run (the relaunch loop still applies).
    supervise: bool = True
    # More than this many restarts of one worker inside the rolling window
    # opens the circuit breaker and escalates.
    max_restarts: int = 3
    restart_window_secs: float = 300.0
    # Respawn backoff (per worker; restarts outside the window are pruned).
    backoff_base_secs: float = 0.5
    backoff_max_secs: float = 30.0
    backoff_multiplier: float = 2.0
    # Liveness lease on worker advertisements (0 disables leases; the
    # heartbeat defaults to ttl/3).
    keepalive_ttl_secs: float = 15.0
    heartbeat_interval_secs: float = 0.0
    # Graceful drain (SIGTERM): budget for pause -> out-of-band recover
    # checkpoint -> orderly exits before the fallback teardown.
    drain_timeout_secs: float = 60.0
    # Backoff between whole-experiment relaunches (recover_mode=auto|fault).
    relaunch_backoff_secs: float = 5.0
    relaunch_backoff_max_secs: float = 60.0


@dataclasses.dataclass
class DurabilityConfig:
    """Durable rollout -> trainer delivery (``system/sample_spool.py``;
    reference train_config.py:446).

    Enabled, every accepted trajectory is fsynced to a per-rollout-worker
    append-only spool before its prompt is marked consumed, pushes carry
    ``(worker_index, seqno)``, and the trainer acks a seqno only once the
    sample is trained (the master's "clear" after the step's recover
    checkpoint) or durably dropped (a too-stale replay). A trainer death
    costs replay, not samples.

    Off by default: no spool, no ``_spool`` key, and the push wire bytes
    are exactly those of the non-durable stream."""

    enabled: bool = False
    # Segment roll size; acked prefixes are deleted a whole segment at once.
    spool_segment_bytes: int = 8 * 1024 * 1024
    # Cap on disk (and on the in-memory mirror) per worker; appends past it
    # block the submitting rollout (backpressure, not loss).
    spool_max_bytes: int = 256 * 1024 * 1024
    # A record unacked this long after its last send is re-sent, flagged
    # as a replay.
    resend_timeout_secs: float = 30.0
    # A replay whose version lags the trained version by more than this is
    # durably dropped (and acked); negative disables the gate.
    replay_staleness_limit: int = 8
    # On a clean worker exit, wait this long for in-flight acks.
    drain_timeout_secs: float = 5.0
    # The budget of one blocked push (streams.TrajectoryPusher); with
    # durability on only the sender thread pushes.
    push_block_secs: float = 120.0


@dataclasses.dataclass
class ExperimentSaveEvalControl:
    """Reference cli_args.py:702."""

    total_train_epochs: int = 1
    benchmark_steps: Optional[int] = None  # stop after N train steps
    save_freq_steps: Optional[int] = None
    ckpt_freq_steps: Optional[int] = None
    ckpt_freq_secs: Optional[int] = None
    eval_freq_steps: Optional[int] = None
