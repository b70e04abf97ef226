"""The port's async-PPO loop on the CPU at ``tiny_config`` size:

 - loop parity: both packages run the async experiment
   (experiments/async_ppo_math_exp.py) from one HF checkpoint of
   numpy-seeded weights, f32 on the CPU, one rollout worker with one prompt
   in flight, greedy chunked generation, ``max_head_offpolicyness=0`` and
   the disk weight sync, so the gate admits exactly one batch per version.
   The port runs through its ``run_experiment``, the reference's pieces are
   wired by hand as its launcher wires them (its launcher has no seam to
   record the trainer's batches). No critic: the reference's critic from a
   checkpoint has an LM head (ROADMAP.md Queue 3 item 3). Tolerances, as
   tests/test_torch_sync_ppo.py's: tokens, rewards and versions equal;
   actor_train stats rtol 1e-4 / atol 1e-5; the last published actor
   within 1e-5;
 - the twin of tests/test_system_async_ppo.py:302 test_async_ppo_full_loop
   (without its telemetry, sentinel, goodput, compile-watch, serving and
   reward-fleet checks), through ``run_experiment`` with a critic; the
   loop with the serving engine on and its interactive probe is
   tests/test_torch_serving.py's, the loop grading on the reward fleet
   (and under the supervisor's respawns, drain and resume)
   tests/test_torch_supervised_loop.py's;
 - the command line of both packages.

Every spawned process is joined with a bound and terminated.
"""

import functools
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from areal_tpu_torch.base.testing import make_math_jsonl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRIAL = "t0"
WAIT_SECS = 300  # bound on every loop


def _overrides(tmp, pkg, data_path, hf_dir):
    return [
        f"cluster.fileroot={tmp}/{pkg}",
        f"cluster.name_resolve.nfs_record_root={tmp}/{pkg}/nr",
        f"dataset.path={data_path}", f"actor.path={hf_dir}",
        f"ref.path={hf_dir}", "n_gpus_per_node=1", "mock_tokenizer=true",
        "actor.bf16=false", "ref.bf16=false",
        "actor.gradient_checkpointing=false",
        "actor.optimizer.lr=1e-3", "actor.optimizer.warmup_steps_proportion=0",
        "dataset.train_bs_n_seqs=2", "group_size=2",
        "max_head_offpolicyness=0", "max_concurrent_rollouts=1",
        "new_tokens_per_chunk=4", "ppo.gen.max_new_tokens=8",
        "ppo.gen.greedy=true", "ppo.disable_value=true", "ppo.kl_ctl=0.05",
        "ppo.use_decoupled_loss=true", "ppo.adv_norm=false",
        "ppo.group_adv_norm=false", "ppo.reward_output_bias=0.5",
        "ppo.ppo_n_minibatches=2", "weight_sync.transport=disk",
        "exp_ctrl.benchmark_steps=3", "gen_prompt_bucket=16",
        "gen_batch_window_ms=2",
    ]


def _config(pkg, overrides, exp):
    if pkg == "port":
        from areal_tpu_torch.api import cli_args as CA
        from areal_tpu_torch.experiments.async_ppo_math_exp import (
            AsyncPPOMATHConfig,
        )
    else:
        from areal_tpu.api import cli_args as CA
        from areal_tpu.experiments.async_ppo_math_exp import AsyncPPOMATHConfig
    cfg = AsyncPPOMATHConfig(experiment_name=exp, trial_name=TRIAL)
    CA.apply_overrides(cfg, list(overrides))
    if pkg == "port":
        cfg.backend = "cpu"
    return cfg


def _record_batches(record, worker):
    """Wrap the trainer's ``_handle_mfc``: each actor_train's samples
    (tokens, rewards, versions) and the actor's version go to ``record``."""
    handle = worker._handle_mfc

    def recording(p):
        if p.data.get("mfc") == "actor_train":
            record.append({
                "version": worker.models["actor"].version.global_step,
                "samples": {str(i): {k: np.asarray(
                    worker.store[i].data[k]).tolist() for k in (
                    "packed_input_ids", "rewards", "version_start",
                    "version_end")} for i in p.data["ids"]}})
        return handle(p)

    worker._handle_mfc = recording


def _port_trainer_probe(record_path, worker):
    """The port's trainer probe (``run_experiment(probes=...)``)."""
    record = []
    _record_batches(record, worker)

    def done():
        with open(record_path, "w") as f:
            json.dump(record, f)
    return done


def _ref_trainer_main(exp, tcfg, record_path):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import areal_tpu.algorithms.ppo  # noqa: F401 — the registries
    import areal_tpu.backend.jax_train  # noqa: F401
    from areal_tpu.base.testing import MockTokenizer
    from areal_tpu.experiments import common as C
    from areal_tpu.system.trainer_worker import TrainerWorker

    C.setup_name_resolve(exp)
    tcfg.tokenizer = MockTokenizer()
    worker = TrainerWorker(tcfg)
    record = []
    _record_batches(record, worker)
    worker.run()
    with open(record_path, "w") as f:
        json.dump(record, f)


def _ref_fleet_main(exp, server_cfgs, mgr_cfg, rollout_cfg):
    """The reference's generation fleet and rollout worker, wired as its
    launcher's gen_fleet_entry and rollout_entry wire them."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import asyncio

    from areal_tpu.apps.launcher import _build_gen_model
    from areal_tpu.base.testing import MockTokenizer
    from areal_tpu.experiments import common as C
    from areal_tpu.system.generation_server import GenerationServer
    from areal_tpu.system.gserver_manager import GserverManager
    from areal_tpu.system.rollout_worker import RolloutWorker

    C.setup_name_resolve(exp)

    async def main():
        cfg, params = _build_gen_model(C.model_init_dict(exp.actor))
        for sc in server_cfgs:
            await GenerationServer(sc, cfg, params).start()
        await GserverManager(mgr_cfg).start()
        rollout_cfg.tokenizer = MockTokenizer()
        await RolloutWorker(rollout_cfg).run_async()

    asyncio.run(main())


def _seeded_hf_dir(path):
    """An HF checkpoint of numpy-seeded tiny weights (every bias and norm
    scale filled), the one both packages load."""
    from areal_tpu_torch.models import hf as thf
    from areal_tpu_torch.models.convert import params_from_jax
    from test_torch_trainer import weights

    _, tcfg, flat = weights(seed=0, vocab_size=258)
    thf.save_hf_checkpoint(params_from_jax(flat, tcfg, device="cpu"), tcfg,
                           path)
    return path


def _run_bounded(fn, box, key):
    def target():
        try:
            box[key] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised by the test
            box[key + "_error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    return t


def _stop(procs):
    for p in procs:
        p.join(timeout=5)
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)


def test_async_loop_matches_reference(tmp_path, monkeypatch):
    import multiprocessing as mp

    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the spawned children's

    from areal_tpu.base import name_resolve as jnr
    from areal_tpu.system.master_worker import MasterWorker
    from areal_tpu_torch.apps.launcher import run_experiment
    from areal_tpu_torch.base import name_resolve as tnr
    from areal_tpu_torch.models import hf as thf

    tmp = str(tmp_path)
    data_path = str(tmp_path / "math.jsonl")
    make_math_jsonl(data_path, n=12, seed=3)
    hf_dir = _seeded_hf_dir(str(tmp_path / "hf"))
    cfgs = {pkg: _config(pkg, _overrides(tmp, pkg, data_path, hf_dir),
                         f"asyncpar_{pkg}") for pkg in ("ref", "port")}
    records = {pkg: str(tmp_path / f"record_{pkg}.json")
               for pkg in ("ref", "port")}

    # The reference: its experiment's pieces, by hand.
    ref = cfgs["ref"]
    ref.resolve_trial_name()
    old = (tnr.DEFAULT_REPO, jnr.DEFAULT_REPO)
    from areal_tpu.experiments import common as JC

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
    try:
        for p in procs:
            p.start()
        threads = [
            _run_bounded(lambda: MasterWorker(setup["master"],
                                              setup["dfg"]).run(),
                         box, "ref"),
            _run_bounded(lambda: run_experiment(cfgs["port"], probes={
                "trainer": functools.partial(_port_trainer_probe,
                                             records["port"])}),
                         box, "port"),
        ]
        deadline = time.monotonic() + WAIT_SECS
        for t in threads:
            t.join(max(deadline - time.monotonic(), 1))
        assert not any(t.is_alive() for t in threads), "a loop hung"
        for pkg in ("ref", "port"):
            if pkg + "_error" in box:
                raise box[pkg + "_error"]
        procs[0].join(60)  # the reference's trainer exits on the master
        assert procs[0].exitcode == 0
    finally:
        _stop(procs)
        tnr.DEFAULT_REPO, jnr.DEFAULT_REPO = old

    rec = {pkg: json.load(open(records[pkg])) for pkg in records}
    assert [r["version"] for r in rec["port"]] == [0, 1, 2]
    assert rec["port"] == rec["ref"]  # tokens, rewards, versions: equal
    for r in rec["port"]:
        for s in r["samples"].values():  # one batch per version
            assert s["version_start"] == s["version_end"] == [r["version"]]
    assert box["port"]["steps"] == box["ref"]["steps"] == 3
    for st_t, st_j in zip(box["port"]["stats"], box["ref"]["stats"]):
        assert st_t["actor_train/grad_norm"] > 0
        common = sorted(k for k in set(st_t) & set(st_j)
                        if k.startswith("actor_train/"))
        assert len(common) >= 15
        for k in common:
            np.testing.assert_allclose(st_t[k], st_j[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    published = []
    for pkg in ("ref", "port"):
        root = os.path.join(tmp, pkg, f"asyncpar_{pkg}", TRIAL, "realloc",
                            "actor")
        v = max(int(d) for d in os.listdir(root))
        assert v == 3
        published.append(thf.load_native_checkpoint(
            os.path.join(root, str(v)), device="cpu")[1])
    assert set(published[0]) == set(published[1])
    for k in published[0]:
        torch.testing.assert_close(published[1][k], published[0][k],
                                   rtol=0, atol=1e-5, msg=k)


# ------------------------------------------------------- the full loop


def _fleet_probe(path, servers, mgr):
    """Write the fleet's versions and quota to ``path`` every 50 ms (the
    launcher terminates this process)."""
    def loop():
        while True:
            snap = {"manager": mgr.version, "server": servers[0].version,
                    "running": mgr.running_rollouts,
                    "accepted": mgr.accepted_rollouts}
            with open(path + ".tmp", "w") as f:
                json.dump(snap, f)
            os.replace(path + ".tmp", path)
            time.sleep(0.05)

    threading.Thread(target=loop, daemon=True).start()


def test_async_ppo_full_loop(tmp_path, monkeypatch):
    """The twin of test_system_async_ppo.py:302 on the port: the README's
    async recipe at tiny size with a critic, through ``run_experiment``:
    3 steps, finite losses, the fleet at version >= 2, the quota returned.
    (The reference's runs at offpolicyness 4 and reaches version 2 by its
    steps' pace; at 0 the gate makes it so.)"""
    from areal_tpu_torch.api import cli_args as CA
    from areal_tpu_torch.apps.launcher import run_experiment
    from areal_tpu_torch.base import name_resolve as tnr
    from areal_tpu_torch.base.testing import make_mixed_jsonl
    from areal_tpu_torch.experiments.async_ppo_math_exp import (
        AsyncPPOMATHConfig,
    )

    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the spawned children's
    data_path = str(tmp_path / "mixed.jsonl")
    make_mixed_jsonl(data_path, n_math=6, n_code=2)
    cfg = AsyncPPOMATHConfig(experiment_name="asyncfull", trial_name=TRIAL,
                             backend="cpu")
    CA.apply_overrides(cfg, [
        f"cluster.fileroot={tmp_path}", f"dataset.path={data_path}",
        "mock_tokenizer=true", "actor.tiny.vocab_size=258",
        "actor.tiny.seed=0", "ref.tiny.vocab_size=258", "ref.tiny.seed=0",
        # offpolicyness 0: the third batch waits for version 2 at the
        # manager, so the fleet ends at >= 2 however fast the steps run
        "dataset.train_bs_n_seqs=4", "group_size=2",
        "max_head_offpolicyness=0", "ppo.use_decoupled_loss=true",
        "ppo.gen.max_new_tokens=8", "new_tokens_per_chunk=4",
        "ppo.ppo_n_minibatches=2", "max_concurrent_rollouts=8",
        "gen_prompt_bucket=16", "exp_ctrl.benchmark_steps=3"])
    snap_path = str(tmp_path / "fleet.json")
    old = tnr.DEFAULT_REPO
    box = {}
    try:
        t = _run_bounded(lambda: run_experiment(cfg, probes={
            "gen_fleet": functools.partial(_fleet_probe, snap_path)}),
            box, "out")
        t.join(WAIT_SECS)
        assert not t.is_alive(), "the loop hung"
    finally:
        tnr.DEFAULT_REPO = old
    if "out_error" in box:
        raise box["out_error"]
    result = box["out"]
    assert result["steps"] == 3
    for st in result["stats"]:
        for k in ("actor_train/actor_loss", "critic_train/critic_loss"):
            assert np.isfinite(st[k]), k
        assert st["actor_train/n_action_tokens"] > 0
    snap = json.load(open(snap_path))
    assert snap["manager"] >= 2 and snap["server"] >= 2
    assert snap["running"] == 0  # every allocation came back


# --------------------------------------------------------- the command line


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_cli_help_lists_the_async_keys(pkg):
    cmd = ([sys.executable, "-m", "areal_tpu_torch.training.main_async_ppo"]
           if pkg == "port" else
           [sys.executable, "training/main_async_ppo.py"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(cmd + ["--help"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for key in ("max_head_offpolicyness", "allocation_mode",
                "new_tokens_per_chunk", "train_bs_n_seqs"):
        assert key in res.stdout, key


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_unknown_key_names_the_closest(pkg):
    if pkg == "port":
        from areal_tpu_torch.api.cli_args import ConfigError
    else:
        from areal_tpu.api.cli_args import ConfigError
    cfg = _config(pkg, [], "cli")
    with pytest.raises(ConfigError,
                       match="did you mean: max_head_offpolicyness"):
        _config(pkg, ["max_head_offpolicynes=4"], "cli")
    with pytest.raises(ConfigError, match="did you mean: max_new_tokens"):
        _config(pkg, ["ppo.gen.max_new_token=4"], "cli")
    assert cfg.max_head_offpolicyness == 0


README_ASYNC = [
    "actor.path=/ckpts/Qwen2.5-0.5B", "dataset.path=/data/math.jsonl",
    "dataset.train_bs_n_seqs=32", "group_size=16",
    "max_head_offpolicyness=4", "ppo.use_decoupled_loss=true",
    "ppo.gen.max_new_tokens=512", "ppo.gen.temperature=0.7",
    "ppo.behav_imp_weight_cap=5", "actor.optimizer.lr=2e-6",
    "actor_train.mb_spec.max_tokens_per_mb=8192", "new_tokens_per_chunk=128",
    "actor.tiny.vocab_size=300", "ref_ema_eta=null", "seed=7",
    "exp_ctrl.benchmark_steps=4", "weight_sync.transport=disk",
]


def test_override_coercion_matches_reference():
    """The same overrides give the same values in both packages' trees."""
    import dataclasses

    cfgs = [_config(pkg, README_ASYNC, "cli") for pkg in ("port", "ref")]
    for ov in README_ASYNC:
        path = ov.partition("=")[0].split(".")
        vals = []
        for cfg in cfgs:
            v = cfg
            for part in path:
                v = v[part] if isinstance(v, dict) else getattr(v, part)
            vals.append(v)
        assert vals[0] == vals[1] and type(vals[0]) is type(vals[1]), ov
    for group in ("ppo", "dataset", "exp_ctrl"):
        port, ref = (dataclasses.asdict(getattr(c, group)) for c in cfgs)
        assert {k: port[k] for k in ref if k in port} == {
            k: ref[k] for k in ref if k in port}, group
    assert set(dataclasses.asdict(cfgs[1].ppo)) == set(
        dataclasses.asdict(cfgs[0].ppo))
    # the experiment registry names the same class in both packages
    from areal_tpu.experiments import make_experiment_cls as jmake
    from areal_tpu_torch.experiments import make_experiment_cls as tmake

    for name in ("async-ppo-math", "ppo-math"):
        assert tmake(name).__name__ == jmake(name).__name__
    assert isinstance(cfgs[0], tmake("async-ppo-math"))

