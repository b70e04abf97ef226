"""The port's async-PPO loop under its supervisor, with the reward fleet.

Twins of ``tests/test_fault_tolerance.py:1335``
(``test_chaos_e2e_sigkill_rollout_and_fleet_no_relaunch``) and ``:1435``
(``test_drain_e2e_sigterm_then_resume``), and the reward-fleet case of
``tests/test_system_async_ppo.py`` (code grades in a separate reward-worker
process, never in the rollout process). The reference's whole-loop runs
are slow-marked and spawn JAX processes; these run the port alone, at
``tiny_config`` size on the CPU through ``LocalLauncher`` /
``run_experiment``, with a seeded mixed math and code dataset:

 - the fleet case: 3 steps with ``reward_service.enabled`` and two reward
   workers; every grade of the rollout process went to the fleet (its
   local grades are none, its client's remote grades cover its pushed
   trajectories);
 - the chaos run: SIGKILL a reward worker, the rollout worker and the
   generation-fleet process mid-run; each respawns in place (its
   incarnation 2), the run completes with no escalation, and the restart
   counters reach the merged Prometheus scrape;
 - the drain run: ``request_drain()`` (the SIGTERM handler's body) ends
   the run early and cleanly with a complete recover checkpoint; a
   ``recover_mode=resume`` launch continues from that step to the end
   without re-consuming a prompt;
 - the twin of ``tests/test_recover.py:138`` (a sync loop stopped and
   resumed, its restore republishing the actor), and ``perf_probe``'s
   ``fleet-status``, ``drain`` and ``flight-dump`` against a live
   in-process run (their command line in a subprocess). They sit here,
   with the other tests that spawn the package, apart from the light
   state-machine twins of tests/test_torch_supervisor.py.

Every wait is bounded; every child is joined or terminated.
"""

import functools
import glob
import json
import os
import signal
import sys
import threading
import time
import urllib.request

import pytest

from areal_tpu_torch.base import name_resolve as tnr

pytestmark = pytest.mark.chaos

TRIAL = "t0"
WAIT_SECS = 300


def _config(tmp_path, exp, steps, extra=()):
    from areal_tpu_torch.api import cli_args as CA
    from areal_tpu_torch.base.testing import make_mixed_jsonl
    from areal_tpu_torch.experiments.async_ppo_math_exp import (
        AsyncPPOMATHConfig,
    )

    data_path = str(tmp_path / "mixed.jsonl")
    if not os.path.exists(data_path):
        make_mixed_jsonl(data_path, n_math=12, n_code=4)
    cfg = AsyncPPOMATHConfig(experiment_name=exp, trial_name=TRIAL,
                             backend="cpu")
    CA.apply_overrides(cfg, [
        f"cluster.fileroot={tmp_path}/exps", f"dataset.path={data_path}",
        "mock_tokenizer=true", "actor.tiny.vocab_size=258",
        "actor.tiny.seed=0", "ref.tiny.vocab_size=258", "ref.tiny.seed=0",
        "dataset.train_bs_n_seqs=4", "group_size=2",
        "max_head_offpolicyness=4", "ppo.use_decoupled_loss=true",
        "ppo.disable_value=true", "ppo.gen.max_new_tokens=8",
        "new_tokens_per_chunk=4", "ppo.ppo_n_minibatches=2",
        "max_concurrent_rollouts=4", "gen_prompt_bucket=16",
        "gen_batch_window_ms=2", "weight_sync.transport=disk",
        f"exp_ctrl.benchmark_steps={steps}",
        "exp_ctrl.total_train_epochs=1000000",
        "fault_tolerance.backoff_base_secs=0.2",
        "fault_tolerance.backoff_max_secs=1.0",
        "fault_tolerance.keepalive_ttl_secs=10", *extra])
    return cfg


def _rollout_probe(out_dir, worker):
    """After the worker's run: its local grades (none may be code: the
    fleet grades), its fleet client's counts and its pushes, in a file per
    process (a killed incarnation writes nothing)."""
    def done():
        from areal_tpu_torch.rewards import client as rc

        svc = rc.service_client()
        with open(os.path.join(out_dir, f"rollout_{os.getpid()}.json"),
                  "w") as f:
            json.dump({"local": dict(rc.verdict_counts),
                       "client": dict(svc.counts) if svc else None,
                       "pushed": worker._pushed}, f)
    return done


def _reward_probe(out_dir, worker):
    """After the worker's run: what it graded, and the card it was shown."""
    def done():
        with open(os.path.join(out_dir, f"reward_{os.getpid()}.json"),
                  "w") as f:
            json.dump({"graded": worker.service._graded,
                       "cuda_visible": os.environ.get(
                           "CUDA_VISIBLE_DEVICES")}, f)
    return done


def _probes(out_dir):
    return {"rollout": functools.partial(_rollout_probe, out_dir),
            "reward": functools.partial(_reward_probe, out_dir)}


def _records(out_dir, kind):
    out = []
    for path in sorted(glob.glob(os.path.join(out_dir, f"{kind}_*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


class Run:
    """A launch on a thread of its own; ``join`` re-raises its error."""

    def __init__(self, fn):
        self.box = {}

        def target():
            try:
                self.box["out"] = fn()
            except BaseException as e:  # noqa: BLE001 — re-raised in join
                self.box["error"] = e

        self.thread = threading.Thread(target=target, daemon=True)
        self.thread.start()

    def join(self, secs=WAIT_SECS):
        self.thread.join(secs)
        assert not self.thread.is_alive(), "the loop hung"
        if "error" in self.box:
            raise self.box["error"]
        return self.box["out"]


def _wait_step(exp, min_step, secs=WAIT_SECS):
    from areal_tpu_torch.system.worker_base import WorkerControlPanel

    panel = WorkerControlPanel(exp, TRIAL, timeout=3.0)
    try:
        deadline = time.monotonic() + secs
        while time.monotonic() < deadline:
            try:
                st = panel.status("master")
                if st.get("step", 0) >= min_step:
                    return st["step"]
            except TimeoutError:
                pass
            time.sleep(0.2)
    finally:
        panel.close()
    raise AssertionError(f"the master never reached step {min_step}")


@pytest.fixture()
def nr_restore():
    old = tnr.DEFAULT_REPO
    yield
    tnr.DEFAULT_REPO = old


@pytest.fixture()
def nfs_repo(tmp_path, nr_restore):
    tnr.DEFAULT_REPO = tnr.NfsNameRecordRepo(str(tmp_path / "tnr"))
    return tnr.DEFAULT_REPO


def test_async_loop_grades_on_the_reward_fleet(tmp_path, monkeypatch,
                                                nr_restore):
    """reward_service.enabled: the rollout process grades nothing itself;
    the fleet grades every trajectory it pushed; the reward workers were
    shown no card."""
    from areal_tpu_torch.apps.launcher import run_experiment

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    out_dir = str(tmp_path / "probe")
    os.makedirs(out_dir)
    cfg = _config(tmp_path, "rwfleet", 3, [
        "reward_service.enabled=true", "reward_service.n_workers=2"])
    result = Run(lambda: run_experiment(cfg, probes=_probes(out_dir))).join()
    assert result["steps"] == 3
    (roll,) = _records(out_dir, "rollout")
    rewards = _records(out_dir, "reward")
    assert len(rewards) == 2
    assert roll["local"] == {}  # no grade ran in the rollout process
    assert roll["client"].get("local_fallback", 0) == 0
    assert roll["client"]["remote"] >= roll["pushed"] >= 3 * 4 * 2
    assert sum(r["graded"] for r in rewards) == roll["client"]["remote"]
    assert all(r["cuda_visible"] == "" for r in rewards)


def test_chaos_e2e_sigkill_rollout_fleet_and_reward_no_relaunch(
        tmp_path, monkeypatch, nr_restore):
    """SIGKILL a reward worker, the rollout worker and the generation-fleet
    process during a supervised run: each respawns in place, the run
    completes with no escalation, and the restart counters reach the
    merged Prometheus scrape."""
    from areal_tpu_torch.apps.launcher import LocalLauncher
    from areal_tpu_torch.base.network import find_free_port

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    out_dir = str(tmp_path / "probe")
    os.makedirs(out_dir)
    port = find_free_port()
    steps = 12
    cfg = _config(tmp_path, "supchaos", steps, [
        "reward_service.enabled=true", "reward_service.n_workers=2",
        "telemetry.enabled=true", "telemetry.flush_interval_secs=0.3",
        f"telemetry.http_port={port}"])
    launcher = LocalLauncher(cfg, probes=_probes(out_dir))
    run = Run(launcher.run)
    try:
        _wait_step("supchaos", 1)
        sup = launcher.supervisor
        for name in ("reward0", "rollout0", "gen_fleet"):
            e = sup.entry(name)
            pid = e.proc.pid
            os.kill(pid, signal.SIGKILL)
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                if e.proc.pid != pid and e.proc.is_alive():
                    break
                time.sleep(0.1)
            assert e.proc.pid != pid and e.incarnation == 2, name
        scrape = None
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and run.thread.is_alive():
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
                    body = r.read().decode()
                if ("areal_supervisor_restarts_total{" in body
                        and all(f'worker_kind="{k}"' in body for k in (
                            "rollout", "gen_fleet", "reward"))):
                    scrape = body
                    break
            except OSError:
                pass
            time.sleep(0.3)
        assert scrape is not None, "the supervisor's counters never scraped"
        result = run.join()
    finally:
        if run.thread.is_alive():
            launcher.request_drain()
            run.thread.join(60)
        if launcher.supervisor is not None:
            launcher.supervisor.shutdown(timeout=10.0, orderly=False)
    assert result["steps"] == steps
    assert launcher.supervisor.restart_counts == {
        "reward": 1, "rollout": 1, "gen_fleet": 1}
    assert not any(p.is_alive() for p in launcher.procs)
    rolls = _records(out_dir, "rollout")
    assert len(rolls) == 1  # the killed incarnation never finished
    assert rolls[0]["local"] == {}


def test_drain_e2e_sigterm_then_resume(tmp_path, monkeypatch, nr_restore):
    """A graceful drain mid-run (request_drain is the SIGTERM handler's
    body) writes a complete recover checkpoint and exits every worker
    cleanly; a resume launch continues from the drained step to the end
    without re-consuming a prompt."""
    from areal_tpu_torch.apps.launcher import LocalLauncher, run_experiment
    from areal_tpu_torch.base import recover
    from areal_tpu_torch.experiments import common as C

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    steps = 12
    cfg = _config(tmp_path, "supdrain", steps)
    paths = C.experiment_paths(cfg)
    launcher = LocalLauncher(cfg)
    run = Run(launcher.run)
    try:
        _wait_step("supdrain", 1)
        launcher.request_drain()
        result = run.join()
    finally:
        if launcher.supervisor is not None:
            launcher.supervisor.shutdown(timeout=10.0, orderly=False)
    drained = result["steps"]
    assert 1 <= drained < steps
    assert not any(p.is_alive() for p in launcher.procs)
    assert all(p.exitcode == 0 for p in launcher.procs
               if p.name in ("trainer", "rollout0"))
    info = recover.load(paths["recover"])
    assert info is not None and info.last_step_info.global_step == drained
    ckpt = recover.discover_ckpt(paths["recover"])
    assert ckpt is not None and recover.ckpt_is_complete(ckpt)
    with open(os.path.join(paths["recover"],
                           "rollout_consumed_0.log")) as f:
        consumed_before = {ln.strip() for ln in f if ln.strip()}
    assert consumed_before
    cfg.recover_mode = "resume"
    result2 = Run(lambda: run_experiment(cfg)).join()
    assert result2["steps"] == steps
    assert len(result2["stats"]) == steps - drained
    with open(os.path.join(paths["recover"],
                           "rollout_consumed_0.log")) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    assert consumed_before <= set(lines) and len(lines) == len(set(lines))


# ---------------- twin of tests/test_recover.py:138 ----------------


def _recover_trainer_main(nr_root, data_path, realloc_dir):
    """The reference test's trainer on the port: a tiny actor (f32, lr
    1e-3), the rule-based reward, generate -> reward -> train, on the
    CPU."""
    from areal_tpu_torch.algorithms.ppo import PPOHyperparameters
    from areal_tpu_torch.api.model import (
        FinetuneSpec,
        GenerationHyperparameters,
    )
    from areal_tpu_torch.api.train_config import OptimizerConfig
    from areal_tpu_torch.base.testing import MockTokenizer
    from areal_tpu_torch.system import trainer_worker as tw

    tnr.DEFAULT_REPO = tnr.NfsNameRecordRepo(nr_root)
    hp = PPOHyperparameters(gen=GenerationHyperparameters(max_new_tokens=8),
                            ppo_n_minibatches=2, group_size=1, kl_ctl=0.0,
                            disable_value=True, adv_norm=True)
    backend_args = {
        "compute_dtype": "float32", "length_bucket": 16, "rows_bucket": 2,
        "seqs_bucket": 4,
        "optimizer": OptimizerConfig(lr=1e-3, lr_scheduler_type="constant",
                                     warmup_steps_proportion=0.0)}
    ppo = {"interface": "ppo_actor", "interface_args": {"hp": hp},
           "model_name": "actor"}
    tw.TrainerWorker(tw.TrainerWorkerConfig(
        experiment="recovertest", trial="t0", handler="trainer",
        models={"actor": tw.ModelRoleConfig(
                    init={"tiny": {"vocab_size": 258, "seed": 0}},
                    backend_args=backend_args),
                "rw": tw.ModelRoleConfig(init={"null": True},
                                         backend="null")},
        mfcs={"actor_gen": tw.MFCRuntimeConfig(**ppo),
              "rew_inf": tw.MFCRuntimeConfig(
                  interface="rw_math_code", model_name="rw",
                  interface_args={"dataset_path": data_path,
                                  "group_size": 1}),
              "actor_train": tw.MFCRuntimeConfig(**ppo)},
        dataset="math_code_prompt", dataset_args={"dataset_path": data_path},
        batch_size=4, ft_spec=FinetuneSpec(1, 16, 4),
        tokenizer=MockTokenizer(), realloc_dir=realloc_dir,
        weight_sync=tw.WeightSyncConfig(transport="disk"),
        device="cpu")).run()


def _recover_dfg():
    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.api.dfg import (
        MFCDef,
        MFCInterfaceType,
        ModelInterfaceAbstraction,
        WeightUpdateHook,
        build_graph,
    )

    traj = ("packed_input_ids", "prompt_mask", "packed_logprobs",
            "seq_no_eos_mask", "task_ids", "version_start", "version_end")
    spec = MicroBatchSpec(max_tokens_per_mb=512)

    def node(name, model, kind, impl, inputs, outputs=(), **kw):
        return MFCDef(name=name, model_name=model, interface_type=kind,
                      interface_impl=ModelInterfaceAbstraction(impl),
                      input_keys=inputs, output_keys=outputs, n_seqs=4,
                      mb_spec=spec, **kw)

    return build_graph([
        node("actor_gen", "actor", MFCInterfaceType.GENERATE, "ppo_actor",
             ("packed_prompts", "task_ids"), traj),
        node("rew_inf", "rw", MFCInterfaceType.INFERENCE, "rw_math_code",
             ("packed_input_ids", "prompt_mask"), ("rewards",)),
        node("actor_train", "actor", MFCInterfaceType.TRAIN_STEP,
             "ppo_actor", ("packed_input_ids", "prompt_mask",
                           "packed_logprobs", "rewards", "seq_no_eos_mask"),
             post_hooks=[WeightUpdateHook(role="actor")]),
    ])


def _recover_master(recover_dir, benchmark_steps, do_recover):
    from areal_tpu_torch.api.train_config import ExperimentSaveEvalControl
    from areal_tpu_torch.system.master_worker import (
        MasterWorker,
        MasterWorkerConfig,
    )

    return MasterWorker(MasterWorkerConfig(
        experiment="recovertest", trial="t0", train_batch_size=4,
        exp_ctrl=ExperimentSaveEvalControl(
            total_train_epochs=10**6, benchmark_steps=benchmark_steps,
            ckpt_freq_steps=1),
        recover_dir=recover_dir, recover=do_recover), _recover_dfg()).run()


def test_kill_and_resume_continues_run(tmp_path, nr_restore):
    """Run 1 stops after 2 steps; run 2, fresh processes with recover on,
    resumes at step 2 and trains 2 more: the versions continue (2 -> 4),
    the dataset cursor moves past run 1's samples (8 -> 16), and the
    restore republishes the actor at v2 from the checkpoint, byte for byte
    what run 1 published as v2."""
    import multiprocessing as mp
    import shutil

    import numpy as np

    from areal_tpu_torch.base import recover
    from areal_tpu_torch.base.testing import make_math_jsonl

    nr_root = str(tmp_path / "nr")
    data_path = str(tmp_path / "math.jsonl")
    realloc_dir = str(tmp_path / "realloc")
    recover_dir = str(tmp_path / "recover")
    make_math_jsonl(data_path, n=16)
    tnr.DEFAULT_REPO = tnr.NfsNameRecordRepo(nr_root)
    ctx = mp.get_context("spawn")

    def run(steps, do_recover):
        proc = ctx.Process(target=_recover_trainer_main, daemon=True,
                           args=(nr_root, data_path, realloc_dir))
        proc.start()
        try:
            return _recover_master(recover_dir, steps, do_recover)
        finally:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.terminate()
                proc.join(10)

    def published(v):
        d = os.path.join(realloc_dir, "actor", str(v))
        return {f: open(os.path.join(d, f), "rb").read()
                for f in sorted(os.listdir(d))}

    r1 = run(2, False)
    assert r1["steps"] == 2
    info = recover.load(recover_dir)
    assert info is not None and info.last_step_info.global_step == 2
    ckpt = recover.discover_ckpt(recover_dir)
    with open(os.path.join(ckpt, "trainer_state.json")) as f:
        st1 = json.load(f)
    assert st1["meta"]["versions"]["actor"] == 2
    assert st1["meta"]["epoch_pos"] == 8
    v2_run1 = published(2)
    shutil.rmtree(realloc_dir)

    r2 = run(4, True)
    assert r2["steps"] == 4 and len(r2["stats"]) == 2
    for st in r2["stats"]:
        assert np.isfinite(st["actor_train/actor_loss"])
    assert published(2) == v2_run1  # republished from the checkpoint
    with open(os.path.join(recover.discover_ckpt(recover_dir),
                           "trainer_state.json")) as f:
        st2 = json.load(f)
    assert st2["meta"]["versions"]["actor"] == 4
    assert st2["meta"]["epoch_pos"] == 16 and st2["meta"]["epoch"] == 0


# ---------------- perf_probe fleet-status, drain, flight-dump ----------------


def test_perf_probe_fleet_status_drain_and_flight_dump(tmp_path, capsys,
                                                     nfs_repo):
    """The operator commands against a live in-process run (a master and a
    rollout worker serving WorkerControl, a reward worker heartbeating
    under a lease): ``fleet-status`` lists heartbeats, endpoints and the
    drain phase with the reference's lines; ``drain`` pauses, checkpoints
    and exits them in order; ``flight-dump`` sets the trigger every
    worker's pusher reads; the command line dispatches the same."""
    import subprocess

    from areal_tpu_torch.api.train_config import RewardServiceConfig
    from areal_tpu_torch.system.reward_worker import (
        RewardWorker,
        RewardWorkerConfig,
    )
    from areal_tpu_torch.base import names as tnames
    from areal_tpu_torch.system import worker_base as twb
    from areal_tpu_torch.tools import perf_probe
    from test_torch_supervisor import _fake_ctrl_worker

    exp, trial = "probefleet", "t0"
    events, stop = [], threading.Event()
    ck = {"saved": True, "dir": "/ck", "step": 5}
    threads = [threading.Thread(
        target=_fake_ctrl_worker, daemon=True,
        args=(twb, exp, trial, w, events, stop),
        kwargs={"commands": {"checkpoint": ck} if w == "master" else None})
        for w in ("master", "rollout0")]
    rw = RewardWorker(RewardWorkerConfig(
        experiment=exp, trial=trial, reward=RewardServiceConfig(enabled=True),
        keepalive_ttl_secs=30.0))
    rw.start()
    for t in threads:
        t.start()
    try:
        panel = twb.WorkerControlPanel(exp, trial, timeout=2.0)
        deadline = time.monotonic() + 10
        while set(panel.list_workers()) != {"master", "rollout0"}:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        panel.close()
        perf_probe.fleet_status(exp, trial)
        out = capsys.readouterr().out
        assert "heartbeats (liveness leases):" in out
        assert "reward0" in out and "incarnation=0" in out
        assert "control endpoints: master, rollout0" in out
        assert "drain phase: none" in out
        assert "fleet map: manager unreachable" in out
        assert "merged scrape unavailable" in out
        env = {**os.environ, "AREAL_NAME_RESOLVE_ROOT": str(tmp_path / "tnr")}
        cli = subprocess.run(
            [sys.executable, "-m", "areal_tpu_torch.tools.perf_probe",
             "fleet-status", exp, trial], capture_output=True, text=True,
            env=env, timeout=120)
        assert cli.returncode == 0, cli.stderr
        assert "control endpoints: master, rollout0" in cli.stdout
        report = perf_probe.drain(exp, trial)
        out = capsys.readouterr().out
        assert report["checkpoint"]["result"] == ck
        assert sorted(report["exited"]) == ["master", "rollout0"]
        assert "recover checkpoint: /ck (step 5)" in out
        for t in threads:
            t.join(10)
            assert not t.is_alive()
        perf_probe.fleet_status(exp, trial)
        assert "drain phase: done" in capsys.readouterr().out
        nonce = perf_probe.flight_dump(exp, trial, str(tmp_path / "flight"))
        trig = json.loads(tnr.get(tnames.flight_dump_trigger(exp, trial)))
        assert trig["nonce"] == nonce
        assert trig["dir"] == str(tmp_path / "flight")
        assert f"flight-dump trigger {nonce}" in capsys.readouterr().out
        assert perf_probe.main(["flight-dump", exp, trial, "/x"]) == 0
        assert perf_probe.main(["fleet-status", exp]) == 2  # an operand short
        assert perf_probe.main([]) == 2
    finally:
        stop.set()
        rw.stop()


def _exit_while_building_probe(out_dir, exp, trial, srv):
    """Called once the model is built, before the server starts: commands
    the server's own exit through its control endpoint, as a scale-down or
    the launcher's shutdown does while a dynamic server builds. The
    command waits there (the entry serves it only after this returns), so
    the reply times out."""
    from areal_tpu_torch.system.worker_base import WorkerControlPanel

    panel = WorkerControlPanel(exp, trial, timeout=1.0)
    try:
        reply = panel.try_command(f"genserver_{srv.cfg.server_id}", "exit")
    except Exception as e:  # noqa: BLE001 — no endpoint: written below
        reply = {"ok": False, "error": repr(e)}
    finally:
        panel.close()

    def done():
        with open(os.path.join(out_dir, "dyn.json"), "w") as f:
            json.dump({"reply": reply,
                       "generated_tokens": srv.stats()["generated_tokens"]},
                      f)
    return done


def test_dynamic_server_exits_in_order_when_told_while_it_builds(
        tmp_path, monkeypatch, nr_restore):
    """A dynamic generation server (``gen_server_entry``) whose exit is
    commanded while its model builds exits 0, without serving, and sends
    its record: its control endpoint is open from the start and the
    command waits there. Were the endpoint opened only after the build,
    the command would find none, the server would serve on, and the
    launcher's shutdown would terminate it without a record."""
    import copy
    import multiprocessing

    from areal_tpu_torch.apps.launcher import gen_server_entry
    from areal_tpu_torch.base import names as tnames
    from areal_tpu_torch.experiments import common as C
    from areal_tpu_torch.system.worker_base import worker_control_key

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    exp = "dynbuild"
    cfg = _config(tmp_path, exp, steps=1)
    sc = copy.deepcopy(cfg.initial_setup()["gen_servers"][0])
    sc.server_id, sc.port = "dyn1", None
    C.setup_name_resolve(cfg)
    out = tmp_path / "out"
    out.mkdir()
    probe = functools.partial(_exit_while_building_probe, str(out), exp,
                              TRIAL)
    proc = multiprocessing.get_context("spawn").Process(
        target=gen_server_entry, args=(cfg, sc, probe), daemon=True)
    proc.start()
    try:
        proc.join(WAIT_SECS)
        assert not proc.is_alive(), "the commanded exit was not served"
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join(10)
    assert proc.exitcode == 0
    with open(out / "dyn.json") as f:
        rec = json.load(f)
    # no answer while the build held the command; nothing served
    assert not rec["reply"]["ok"] and rec["generated_tokens"] == 0
    # it never registered for routing, and its endpoint is withdrawn
    for key in (tnames.gen_servers(exp, TRIAL, "dyn1"),
                worker_control_key(exp, TRIAL, "genserver_dyn1")):
        with pytest.raises(tnr.NameEntryNotFoundError):
            tnr.get(key)
