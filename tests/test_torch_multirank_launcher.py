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
