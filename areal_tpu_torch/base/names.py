"""Name-resolve key schema for distributed discovery.

The port's copy of ``areal_tpu/base/names.py``, key for key: the same
``ROOT``, so both packages find each other's entries in one store. All
coordination state lives under ``{root}/{experiment}/{trial}/...`` keys in a
name-resolve store.
"""

from __future__ import annotations

ROOT = "areal_tpu"


def _base(experiment: str, trial: str) -> str:
    return f"{ROOT}/{experiment}/{trial}"


def trial_root(experiment: str, trial: str) -> str:
    return _base(experiment, trial)


def worker_status(experiment: str, trial: str, worker: str) -> str:
    return f"{_base(experiment, trial)}/status/{worker}"


def worker_root(experiment: str, trial: str) -> str:
    return f"{_base(experiment, trial)}/status/"


def request_reply_stream(experiment: str, trial: str, stream: str) -> str:
    return f"{_base(experiment, trial)}/stream/{stream}"


def push_pull_stream(experiment: str, trial: str, stream: str) -> str:
    return f"{_base(experiment, trial)}/push_pull/{stream}"


def push_pull_stream_root(experiment: str, trial: str) -> str:
    return f"{_base(experiment, trial)}/push_pull/"


def gen_servers(experiment: str, trial: str, server_id: str) -> str:
    return f"{_base(experiment, trial)}/gen_servers/{server_id}"


def gen_server_root(experiment: str, trial: str) -> str:
    return f"{_base(experiment, trial)}/gen_servers/"


def gen_server_manager(experiment: str, trial: str) -> str:
    return f"{_base(experiment, trial)}/gserver_manager"


def reward_worker(experiment: str, trial: str, worker_id: str) -> str:
    """HTTP endpoint of one sandbox reward worker (the sixth worker
    kind, system/reward_worker.py): reward clients discover the fleet
    under the root below and fan grading requests across it
    (rewards/client.py, docs/rewards.md)."""
    return f"{_base(experiment, trial)}/reward_workers/{worker_id}"


def reward_worker_root(experiment: str, trial: str) -> str:
    return f"{_base(experiment, trial)}/reward_workers/"


def model_version(experiment: str, trial: str, role: str) -> str:
    return f"{_base(experiment, trial)}/model_version/{role}"


def model_version_time(experiment: str, trial: str, role: str) -> str:
    """Wall-clock publish time of the version above — the start point of
    the trainer→rollout weight-sync latency metric (BASELINE.json)."""
    return f"{_base(experiment, trial)}/model_version_time/{role}"


def weight_stream(experiment: str, trial: str, role: str) -> str:
    """``tcp://host:port`` of the trainer's WeightStreamPublisher for ``role`` —
    present iff the trainer publishes weights over the streamed transport
    (system/weight_stream.py); its absence means consumers fall back to
    the disk realloc path."""
    return f"{_base(experiment, trial)}/weight_stream/{role}"


def weight_device(experiment: str, trial: str, role: str) -> str:
    """On-device publication descriptor for ``role`` — present iff the
    trainer publishes over the ``device`` transport (parallel/reshard.py
    registry). Value: JSON {pid, version, digest}; the digest is the
    out-of-band integrity gate the generation server verifies before the
    swap. Absence → stream/disk auto-detection as before."""
    return f"{_base(experiment, trial)}/weight_device/{role}"


def experiment_status(experiment: str, trial: str) -> str:
    return f"{_base(experiment, trial)}/exp_status"


def distributed_peer(experiment: str, trial: str, peer: str) -> str:
    return f"{_base(experiment, trial)}/peers/{peer}"


def distributed_root(experiment: str, trial: str) -> str:
    return f"{_base(experiment, trial)}/peers/"


def used_data_ids(experiment: str, trial: str) -> str:
    return f"{_base(experiment, trial)}/used_data"


def telemetry_aggregator(experiment: str, trial: str) -> str:
    """ZMQ PULL endpoint of the master's TelemetryAggregator — workers'
    TelemetryPushers discover it here (base/telemetry.py)."""
    return f"{_base(experiment, trial)}/telemetry_aggregator"


def profiler_trigger(experiment: str, trial: str) -> str:
    """On-demand profiler request flag: a JSON {dir, secs} written by an
    operator (tools/perf_probe.py) and consumed by the trainer's
    ProfilerTriggerWatcher (base/telemetry.py)."""
    return f"{_base(experiment, trial)}/profiler_trigger"


def profiler_status(experiment: str, trial: str) -> str:
    """Last profiler-capture outcome published by the trainer."""
    return f"{_base(experiment, trial)}/profiler_status"


def telemetry_http(experiment: str, trial: str) -> str:
    """HTTP URL of the aggregator's merged-fleet Prometheus endpoint
    (present iff telemetry.http_port > 0) — lets accelerator-free tools reach the
    merged scrape without knowing the port (tools/perf_probe.py)."""
    return f"{_base(experiment, trial)}/telemetry_http"


def flight_dump_trigger(experiment: str, trial: str) -> str:
    """On-demand flight-recorder dump request: a JSON {dir, nonce} an
    operator writes (tools/perf_probe.py flight-dump); every worker's
    TelemetryPusher acts on it once per nonce (base/telemetry.py)."""
    return f"{_base(experiment, trial)}/flight_dump_trigger"


def worker_heartbeat(experiment: str, trial: str, worker: str) -> str:
    """Liveness heartbeat of one worker: JSON {ts, incarnation, pid},
    rewritten every heartbeat interval by the worker's HeartbeatThread
    (system/worker_base.py). Observers derive heartbeat AGE from ``ts``;
    the incarnation id distinguishes a respawned worker from its dead
    predecessor's ghost."""
    return f"{_base(experiment, trial)}/heartbeat/{worker}"


def worker_heartbeat_root(experiment: str, trial: str) -> str:
    return f"{_base(experiment, trial)}/heartbeat/"


def compile_inflight(experiment: str, trial: str, worker: str) -> str:
    """Compile-in-flight flag of one worker: JSON {ts}, rewritten every
    heartbeat interval by the worker's HeartbeatThread while its
    CompileWatch reports a jit compile in progress, deleted when the
    compile drains (system/worker_base.py, base/compile_watch.py). The
    sentinel's absence rules read this to tell "wedged" apart from
    "legitimately compiling" instead of hiding behind a blanket grace
    (system/sentinel.py trainer_stalled)."""
    return f"{_base(experiment, trial)}/compile_inflight/{worker}"


def compile_inflight_root(experiment: str, trial: str) -> str:
    return f"{_base(experiment, trial)}/compile_inflight/"


def autoscale_plan(experiment: str, trial: str) -> str:
    """Fleet-size directive published by the gserver manager's autoscale
    loop (JSON {target, dynamic, ts, reason}): ``dynamic`` is how many
    supervisor-spawned single-server workers the launcher-side
    AutoscaleExecutor should keep alive on top of the baseline gen-fleet
    process (system/autoscaler.py)."""
    return f"{_base(experiment, trial)}/autoscale_plan"


def autoscale_inhibit(experiment: str, trial: str) -> str:
    """Autoscale-inhibit hint published by the training-health sentinel
    on critical alerts (JSON {until, rule, ts}): while live, the gserver
    manager's scaling loop suppresses scale-up — growing the fleet into
    a diverging run only burns capacity (system/sentinel.py,
    system/autoscaler.read_inhibit)."""
    return f"{_base(experiment, trial)}/autoscale_inhibit"


def sentinel_silence(experiment: str, trial: str, rule: str) -> str:
    """Operator silence for one sentinel rule (JSON {until, rule}):
    written by ``tools/perf_probe.py silence <rule> <duration>``; the
    sentinel suppresses the rule's fires until it expires."""
    return f"{_base(experiment, trial)}/sentinel_silence/{rule}"


def sentinel_silence_root(experiment: str, trial: str) -> str:
    return f"{_base(experiment, trial)}/sentinel_silence/"


def drain_status(experiment: str, trial: str) -> str:
    """Graceful-drain phase marker written by supervisor.drain_experiment
    (JSON {phase, ts}): pausing -> checkpoint -> exiting -> done. Read by
    tools/perf_probe.py fleet-status."""
    return f"{_base(experiment, trial)}/drain_status"


def metric_server(experiment: str, trial: str, group: str, index: str) -> str:
    return f"{_base(experiment, trial)}/metrics/{group}/{index}"


def metric_server_root(experiment: str, trial: str) -> str:
    return f"{_base(experiment, trial)}/metrics/"
