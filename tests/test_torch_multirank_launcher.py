"""The launcher with several trainer ranks, on the CPU over gloo — the
twin of the reference launcher's ``trainer_dist_procs`` path
(``areal_tpu/apps/launcher.py:436-474``; the port derives the ranks from
the allocation's trainer spec):

 - one sync-PPO step through ``run_experiment`` with ``backend=cpu`` and
   ``allocation_mode=f2``: two ranks on one ``f2`` mesh take the step
   together;
 - a rank that dies is one trainer death: the supervisor escalates on it
   and the teardown ends the other rank within its bounds.

Every wait is bounded (the launcher's own shutdown terminates what is
left).
"""

import os
import time

import pytest


def _ranks_probe(out_dir, worker):
    """Each trainer rank's rank, world, mesh degree and steps."""
    def done():
        eng = worker.models["actor"].module
        with open(os.path.join(out_dir, f"rank{worker.cfg.dist_rank}"),
                  "w") as f:
            f.write(f"{worker.cfg.dist_rank} {worker.cfg.dist_world} "
                    f"{eng.mesh.size()} {eng.opt_step_count}")
    return done


def test_launcher_runs_a_sync_step_on_two_ranks(tmp_path, monkeypatch):
    """``run_experiment`` with ``allocation_mode=f2``: two trainer ranks on
    one ``f2`` mesh take one sync-PPO step (generation, rewards, reference,
    train) together."""
    import functools

    from areal_tpu_torch.api import cli_args as TCA
    from areal_tpu_torch.apps.launcher import run_experiment
    from areal_tpu_torch.base import name_resolve as tnr
    from areal_tpu_torch.base.testing import make_math_jsonl
    from areal_tpu_torch.experiments.ppo_math_exp import PPOMATHConfig

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    data_path = str(tmp_path / "math.jsonl")
    make_math_jsonl(data_path, n=8)
    cfg = PPOMATHConfig(backend="cpu")
    TCA.apply_overrides(cfg, [
        f"cluster.fileroot={tmp_path}", "experiment_name=mhrun",
        "trial_name=t0", "mock_tokenizer=true", "actor.tiny.vocab_size=258",
        "ref.tiny.vocab_size=258", f"dataset.path={data_path}",
        "dataset.train_bs_n_seqs=2", "group_size=2",
        "ppo.gen.max_new_tokens=8", "ppo.kl_ctl=0.05",
        "ppo.disable_value=true", "exp_ctrl.benchmark_steps=1",
        "allocation_mode=f2", "n_gpus_per_node=2"])
    old = tnr.DEFAULT_REPO
    t0 = time.monotonic()
    try:
        result = run_experiment(cfg, probes={"trainer": functools.partial(
            _ranks_probe, str(tmp_path))})
    finally:
        tnr.DEFAULT_REPO = old
    assert time.monotonic() - t0 < 240
    assert result["steps"] == 1
    seen = []
    for r in (0, 1):
        with open(tmp_path / f"rank{r}") as f:
            seen.append(f.read().split())
    assert [s[:3] for s in seen] == [["0", "2", "2"], ["1", "2", "2"]]
    # both ranks took the step's optimizer updates (one per PPO minibatch)
    assert seen[0][3] == seen[1][3] and int(seen[0][3]) >= 1


def _rank1_dies(worker):
    """Rank 1 exits (code 3) as soon as its worker is built."""
    if worker.cfg.dist_rank == 1:
        os._exit(3)


def test_a_dead_rank_brings_the_trainer_group_down(tmp_path, monkeypatch):
    """One rank's death is one trainer death: the supervisor escalates on
    it (the run raises, naming the rank), and the launcher's teardown ends
    rank 0, which waits for its group, within its bounded shutdown."""
    from areal_tpu_torch.api import cli_args as TCA
    from areal_tpu_torch.apps.launcher import run_experiment
    from areal_tpu_torch.base import name_resolve as tnr
    from areal_tpu_torch.base.testing import make_math_jsonl
    from areal_tpu_torch.experiments.ppo_math_exp import PPOMATHConfig
    from areal_tpu_torch.system.supervisor import SupervisorEscalation

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    data_path = str(tmp_path / "math.jsonl")
    make_math_jsonl(data_path, n=8)
    cfg = PPOMATHConfig(backend="cpu")
    TCA.apply_overrides(cfg, [
        f"cluster.fileroot={tmp_path}", "experiment_name=mhdead",
        "trial_name=t0", "mock_tokenizer=true", "actor.tiny.vocab_size=258",
        "ref.tiny.vocab_size=258", f"dataset.path={data_path}",
        "dataset.train_bs_n_seqs=2", "group_size=2",
        "ppo.gen.max_new_tokens=8", "ppo.disable_value=true",
        "exp_ctrl.benchmark_steps=1", "allocation_mode=f2",
        "n_gpus_per_node=2"])
    old = tnr.DEFAULT_REPO
    t0 = time.monotonic()
    try:
        with pytest.raises(SupervisorEscalation, match="trainer1 died: "
                           "exit code 3"):
            run_experiment(cfg, probes={"trainer": _rank1_dies})
    finally:
        tnr.DEFAULT_REPO = old
    assert time.monotonic() - t0 < 180


def _masters_probe(out_dir, worker):
    """Each trainer rank's local master shards, its stage's or whole."""
    def done():
        import numpy as np

        eng = worker.models["actor"].module
        local = {n: (p._local_tensor if eng.mesh is not None else p)
                 .detach().numpy() for n, p in eng.params.items()}
        np.savez(os.path.join(out_dir, f"masters{worker.cfg.dist_rank}.npz"),
                 **local)
    return done


def _sync_step(tmp_path, name: str, alloc: str):
    """One sync-PPO step through ``run_experiment`` on ``alloc``: the
    master's step stats and the actor's masters after it (the ranks'
    shards merged: under s2 and p2 no master is split within a tensor)."""
    import functools

    import numpy as np

    from areal_tpu_torch.api import cli_args as TCA
    from areal_tpu_torch.apps.launcher import run_experiment
    from areal_tpu_torch.base import name_resolve as tnr
    from areal_tpu_torch.base.testing import make_math_jsonl
    from areal_tpu_torch.experiments.ppo_math_exp import PPOMATHConfig
    from areal_tpu_torch.parallel.mesh import ParallelSpec

    out = tmp_path / name
    out.mkdir()
    data_path = str(out / "math.jsonl")
    make_math_jsonl(data_path, n=8)
    cfg = PPOMATHConfig(backend="cpu")
    world = ParallelSpec.parse(alloc).world_size
    TCA.apply_overrides(cfg, [
        f"cluster.fileroot={out}", f"experiment_name=mh{name}",
        "trial_name=t0", "mock_tokenizer=true", "actor.tiny.vocab_size=258",
        "actor.tiny.n_layers=2", "ref.tiny.vocab_size=258",
        "ref.tiny.n_layers=2", "ref.tiny.seed=1", f"dataset.path={data_path}",
        "dataset.train_bs_n_seqs=4", "group_size=2",
        "ppo.gen.max_new_tokens=8", "ppo.kl_ctl=0.05",
        "ppo.disable_value=true", "exp_ctrl.benchmark_steps=1",
        f"allocation_mode={alloc}", f"n_gpus_per_node={world}"])
    old = tnr.DEFAULT_REPO
    t0 = time.monotonic()
    try:
        result = run_experiment(cfg, probes={"trainer": functools.partial(
            _masters_probe, str(out))})
    finally:
        tnr.DEFAULT_REPO = old
    assert time.monotonic() - t0 < 240
    assert result["steps"] == 1
    masters = {}
    for r in range(world):
        with np.load(out / f"masters{r}.npz") as z:
            masters.update({k: z[k] for k in z.files})
    return result["stats"][0], masters


@pytest.fixture(scope="module")
def one_rank_step(tmp_path_factory):
    return _sync_step(tmp_path_factory.mktemp("d1"), "d1", "d1")


@pytest.mark.parametrize("alloc", ["s2", "p2"])
def test_sp_and_pp_allocations_take_the_one_rank_step(tmp_path, monkeypatch,
                                                      one_rank_step, alloc):
    """``run_experiment`` with ``allocation_mode=s2`` (the ring over two
    ranks) or ``p2`` (two pipeline stages): the sync-PPO step's loss and
    grad norm equal one rank's within 1e-5 (the loss, a sum of advantages
    that nearly cancel, absolutely) and the actor's masters within 1e-6.
    The reference model has its own seed, so the KL reward gives every
    token an advantage well above rounding."""
    import numpy as np

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    want, want_masters = one_rank_step
    got, masters = _sync_step(tmp_path, alloc, alloc)
    keys = [k for k in want if k.startswith("actor_train/")
            and ("loss" in k or "grad_norm" in k)]
    assert any("loss" in k for k in keys) and any("grad_norm" in k
                                                  for k in keys)
    for k in keys:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-5), k
    assert set(masters) == set(want_masters)
    for n, m in want_masters.items():
        np.testing.assert_allclose(masters[n], m, atol=1e-6, err_msg=n)
