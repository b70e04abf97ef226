"""The async-PPO loop with telemetry, goodput and the sentinel on, in both
packages, on the loop-parity configuration of ``test_torch_async_ppo.py``
(one rollout in flight, greedy, ``max_head_offpolicyness=0``, disk weight
sync, 3 steps on the CPU):

 - the merged scrapes carry the same metric families, less an explicit
   list of the pieces the port does not have yet (and the few it adds);
 - every stitched trace joins the same span names in both packages;
 - the deterministic counters are equal when step 3's batch is in (the
   gate holds the rollouts there: 12 trajectories pushed, 2 steps trained):
   ``rollout/trajectories_pushed``, ``genserver/generated_tokens``,
   ``train/tokens`` and ``train/optimizer_steps``.

The port's launcher supervises its children: they heartbeat under a
keepalive lease and the supervisor exports their heartbeat ages
(``supervisor/heartbeat_age_secs``). The reference's loop is wired by hand,
so the test gives it the same: its children get the lease through the
environment, and a reference ``Supervisor`` with no children of its own
exports their heartbeat ages from the master's process.

And the disabled contract: with every switch off, the port's workers start
no telemetry thread, socket or HTTP server and advertise nothing.

Every wait is bounded; live children are terminated in ``finally``.
"""

import json
import multiprocessing as mp
import os
import threading
import time

import pytest

from areal_tpu_torch.base.testing import make_math_jsonl
from test_torch_async_ppo import (
    TRIAL,
    WAIT_SECS,
    _config,
    _overrides,
    _ref_fleet_main,
    _ref_trainer_main,
    _run_bounded,
    _seeded_hf_dir,
    _stop,
)

pytestmark = pytest.mark.telemetry

OBSERVE = ("telemetry.enabled=true", "telemetry.flush_interval_secs=0.5",
           "telemetry.stitch_grace_secs=1", "goodput.enabled=true",
           "sentinel.enabled=true")

# Families only the reference's scrape has, by the piece they wait for
# (none since the ring and the pipeline publish their gauges).
NOT_PORTED: set = set()
# Families only the port's scrape has: the server's per-leg upload time of
# a stream update (absent here: disk sync), nothing else.
PORT_ONLY = {"areal_genserver_upload_secs"}
COUNTERS = {"rollout:0": "rollout/trajectories_pushed",
            "generation_server:0": "genserver/generated_tokens",
            "trainer:0": ("train/tokens", "train/optimizer_steps")}


def _families(text):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE")}


def _hooks(pkg, box):
    """Capture the merged scrape as the master closes its aggregator, and
    the deterministic counters once step 3's batch is in: the master's
    event loop waits (bounded) there for every worker's next snapshot, so
    no weight version moves while they are read."""
    if pkg == "port":
        from areal_tpu_torch.base import telemetry as T
        from areal_tpu_torch.system.master_worker import MasterWorker
    else:
        from areal_tpu.base import telemetry as T
        from areal_tpu.system.master_worker import MasterWorker
    close, count = T.TelemetryAggregator.close, MasterWorker._count_mfc_flops

    def capturing_close(agg):
        box[pkg + "_scrape"] = agg.render_prometheus()
        close(agg)

    def counting(master, node, metas):
        if master.step == 2 and node.name == "ref_inf":
            t0 = time.time()
            deadline = time.monotonic() + 30
            agg = master._aggregator
            while time.monotonic() < deadline and not all(
                    agg.merged().get(w, {}).get("time", 0) > t0 + 0.1
                    for w in COUNTERS):
                time.sleep(0.05)
            merged = agg.merged()
            box[pkg + "_counters"] = {
                w: {k: merged.get(w, {}).get("counters", {}).get(k)
                    for k in ((ks,) if isinstance(ks, str) else ks)}
                for w, ks in COUNTERS.items()}
        return count(master, node, metas)

    T.TelemetryAggregator.close = capturing_close
    MasterWorker._count_mfc_flops = counting

    def restore():
        T.TelemetryAggregator.close = close
        MasterWorker._count_mfc_flops = count
    return restore


def _traces(tmp, pkg):
    path = os.path.join(tmp, pkg, f"obsloop_{pkg}", TRIAL, "logs",
                        "traces.jsonl")
    out = {}
    with open(path) as f:
        for line in f:
            d = json.loads(line)
            out[d["sample_id"]] = sorted({s["name"] for s in d["spans"]})
    return out


def test_observed_loop_matches_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the spawned children's

    from areal_tpu.base import name_resolve as jnr
    from areal_tpu.experiments import common as JC
    from areal_tpu.system import supervisor as jsup
    from areal_tpu.system import worker_base as jwb
    from areal_tpu.system.master_worker import MasterWorker
    from areal_tpu_torch.apps.launcher import run_experiment
    from areal_tpu_torch.base import name_resolve as tnr

    tmp = str(tmp_path)
    data_path = str(tmp_path / "math.jsonl")
    make_math_jsonl(data_path, n=12, seed=3)
    hf_dir = _seeded_hf_dir(str(tmp_path / "hf"))
    cfgs = {pkg: _config(pkg, [*_overrides(tmp, pkg, data_path, hf_dir),
                               *OBSERVE], f"obsloop_{pkg}")
            for pkg in ("ref", "port")}
    records = {pkg: str(tmp_path / f"record_{pkg}.json")
               for pkg in ("ref", "port")}
    ref = cfgs["ref"]
    ref.resolve_trial_name()
    old = (tnr.DEFAULT_REPO, jnr.DEFAULT_REPO)
    JC.setup_name_resolve(ref)
    setup = ref.initial_setup()
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=_ref_trainer_main, daemon=True,
                    args=(ref, setup["trainer"], records["ref"])),
        ctx.Process(target=_ref_fleet_main, daemon=True,
                    args=(ref, setup["gen_servers"], setup["gserver_manager"],
                          setup["rollout_workers"][0])),
    ]
    box = {}
    restores = [_hooks("ref", box), _hooks("port", box)]
    # the reference's children heartbeat under the launcher's default lease
    monkeypatch.setenv(jwb.ENV_KEEPALIVE_TTL, "15")
    watch = jsup.Supervisor(ref.experiment_name, ref.trial_name,
                            keepalive_ttl=15.0)
    stop_watch = threading.Event()

    def export_heartbeats():
        while not stop_watch.wait(0.5):
            watch.check()

    threading.Thread(target=export_heartbeats, daemon=True).start()
    try:
        for p in procs:
            p.start()
        threads = [
            _run_bounded(lambda: MasterWorker(setup["master"],
                                              setup["dfg"]).run(),
                         box, "ref"),
            _run_bounded(lambda: run_experiment(cfgs["port"]), box, "port"),
        ]
        deadline = time.monotonic() + WAIT_SECS
        for t in threads:
            t.join(max(deadline - time.monotonic(), 1))
        assert not any(t.is_alive() for t in threads), "a loop hung"
        for pkg in ("ref", "port"):
            if pkg + "_error" in box:
                raise box[pkg + "_error"]
        procs[0].join(60)
    finally:
        stop_watch.set()
        for restore in restores:
            restore()
        _stop(procs)
        tnr.DEFAULT_REPO, jnr.DEFAULT_REPO = old

    assert box["port"]["steps"] == box["ref"]["steps"] == 3
    # the same families, less what each package lacks
    fams = {pkg: _families(box[pkg + "_scrape"]) for pkg in ("ref", "port")}
    assert fams["ref"] - fams["port"] <= NOT_PORTED, \
        sorted(fams["ref"] - fams["port"] - NOT_PORTED)
    assert fams["port"] - fams["ref"] <= PORT_ONLY, \
        sorted(fams["port"] - fams["ref"] - PORT_ONLY)
    assert len(fams["port"]) >= 90
    # the same span names in every stitched trace
    traces = {pkg: _traces(tmp, pkg) for pkg in ("ref", "port")}
    common = set(traces["ref"]) & set(traces["port"])
    assert len(common) >= 8  # the first two steps' samples at least
    for sid in sorted(common):
        assert traces["port"][sid] == traces["ref"][sid], sid
    assert "trainer/train_sample" in traces["port"][sorted(common)[0]]
    # equal deterministic counters where the gate holds the loop
    assert box["port_counters"] == box["ref_counters"]
    assert box["port_counters"]["rollout:0"][
        "rollout/trajectories_pushed"] == 12
    assert box["port_counters"]["trainer:0"]["train/optimizer_steps"] > 0


def test_disabled_workers_start_nothing(tmp_path):
    """Every observability switch at its default (off): building and
    running the port's server, manager and trainer starts no telemetry
    thread, pusher, aggregator or HTTP endpoint and advertises nothing."""
    from areal_tpu_torch.base import name_resolve as tnr
    from areal_tpu_torch.base import names
    from areal_tpu_torch.base import telemetry as T
    from areal_tpu_torch.models.config import tiny_config
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system import goodput, memwatch
    from areal_tpu_torch.system.generation_server import (
        GenerationServer,
        GenerationServerConfig,
    )
    from areal_tpu_torch.system.gserver_manager import (
        GserverManager,
        GserverManagerConfig,
    )
    from areal_tpu_torch.system.trainer_worker import (
        ModelRoleConfig,
        TrainerWorker,
        TrainerWorkerConfig,
    )

    old = tnr.DEFAULT_REPO
    tnr.DEFAULT_REPO = tnr.MemoryNameRecordRepo()
    cfg = tiny_config(vocab_size=64)
    srv = GenerationServer(GenerationServerConfig(experiment="off",
                                                  trial="t", kv_bucket=16),
                           cfg, init_params(cfg, 0, "cpu"), device="cpu")
    mgr = GserverManager(GserverManagerConfig(experiment="off", trial="t"))
    tr = TrainerWorker(TrainerWorkerConfig(
        experiment="off", trial="t", models={"actor": ModelRoleConfig(
            init={"tiny": {"vocab_size": 64}}, train=False)},
        device="cpu"))
    try:
        srv.start()
        mgr.start()
        tr.setup()
        srv.handle_generate({"prompt_ids": [1, 2, 3], "max_tokens": 2,
                             "gconfig": {"greedy": True}})
        threads = [t.name for t in threading.enumerate()]
        assert not [n for n in threads if n.startswith("telemetry")], threads
        assert srv.telemetry is T.NULL and mgr.telemetry is T.NULL
        assert srv.ledger is goodput.NULL_LEDGER
        assert tr._ledger is goodput.NULL_LEDGER and tr._profiler is None
        assert srv.memwatch is memwatch.NULL and T.get() is T.NULL
        for key in (names.telemetry_aggregator("off", "t"),
                    names.telemetry_http("off", "t")):
            with pytest.raises(tnr.NameEntryNotFoundError):
                tnr.get(key)
        # /metrics is the live state alone: no registry behind it
        assert "_total" not in srv.metrics_text()
    finally:
        tr.close()
        mgr.stop()
        srv.stop()
        tnr.DEFAULT_REPO = old
