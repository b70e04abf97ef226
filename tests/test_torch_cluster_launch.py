"""Cluster launch in the port: the Slurm client and launcher
(``areal_tpu_torch/apps/slurm.py``), the remote entry point
(``apps/remote.py``) and the config dump and load (``api/cli_args.py``).

Twin of ``tests/test_slurm_remote.py``: no Slurm binary exists here, so the
command runner is a fake that the tests script and assert against. The
port asks for GPUs (``--gres=gpu:N``) and runs one trainer task per GPU.
Also: the config round trip through ``config.yaml`` with ``yaml`` present
and blocked (then the file is JSON), and one dispatch of every role."""

import json
import os
import subprocess
import sys

import pytest

from areal_tpu_torch.apps.slurm import (
    SlurmClient,
    SlurmJobSpec,
    SlurmLauncher,
    build_job_specs,
    render_sbatch_script,
)
from areal_tpu_torch.experiments.async_ppo_math_exp import AsyncPPOMATHConfig
from areal_tpu_torch.experiments.ppo_math_exp import PPOMATHConfig


class FakeSlurm:
    """Scripted sbatch / squeue / sacct / scancel."""

    def __init__(self):
        self.submitted = []
        self.cancelled = []
        self.next_id = 100
        self.states = {}  # job id -> state
        self.squeue_calls = 0
        self.sacct_states = {}  # job id -> terminal state of a purged job

    def __call__(self, cmd, capture_output=True, text=True, timeout=None):
        prog = cmd[0]
        if prog == "sbatch":
            jid = str(self.next_id)
            self.next_id += 1
            self.submitted.append(cmd[-1])
            self.states[jid] = "RUNNING"
            return subprocess.CompletedProcess(cmd, 0, stdout=jid + "\n",
                                               stderr="")
        if prog == "squeue":
            self.squeue_calls += 1
            # every job has left the queue by the second poll
            lines = ([] if self.squeue_calls >= 2 else
                     [f"{j} {s}" for j, s in self.states.items()])
            return subprocess.CompletedProcess(
                cmd, 0, stdout="\n".join(lines) + "\n", stderr="")
        if prog == "sacct":
            lines = [f"{j}|{s}" for j, s in self.sacct_states.items()]
            return subprocess.CompletedProcess(
                cmd, 0, stdout="\n".join(lines) + "\n", stderr="")
        if prog == "scancel":
            self.cancelled.append(cmd[1])
            return subprocess.CompletedProcess(cmd, 0, stdout="", stderr="")
        raise AssertionError(f"unexpected command {cmd}")


def test_render_sbatch_script_structure(tmp_path):
    spec = SlurmJobSpec(
        name="exp-trainer", cmd="python -m areal_tpu_torch.apps.remote "
        "--role trainer", ntasks=32, nodes=4, ntasks_per_node=8,
        gpus_per_node=8, cpus_per_task=8, mem_per_task_mb=65536,
        env={"AREAL_CACHE_ROOT": "/data"}, exclusive=True)
    s = render_sbatch_script(spec, str(tmp_path))
    assert "#SBATCH --ntasks=32" in s
    assert "#SBATCH --nodes=4" in s
    assert "#SBATCH --ntasks-per-node=8" in s
    assert "#SBATCH --gres=gpu:8" in s and "gres=tpu" not in s
    assert "#SBATCH --exclusive" in s
    assert "export AREAL_CACHE_ROOT='/data'" in s
    assert s.rstrip().endswith(
        "srun python -m areal_tpu_torch.apps.remote --role trainer")


def test_build_job_specs_decoupled():
    cfg = AsyncPPOMATHConfig(experiment_name="e2e",
                             allocation_mode="gen.d4+d2f2t2",
                             n_gpus_per_node=8, n_rollout_workers=3)
    specs = {s.name: s for s in build_job_specs(cfg, "/run/config.yaml")}
    assert set(specs) == {"e2e-master", "e2e-trainer", "e2e-gen",
                          "e2e-rollout"}
    t = specs["e2e-trainer"]
    # one task per GPU: eight ranks on one node of eight GPUs
    assert t.ntasks == 8 and t.nodes == 1 and t.gpus_per_node == 8
    assert specs["e2e-gen"].gpus_per_node == 4
    assert specs["e2e-rollout"].ntasks == 3
    assert "--experiment-cls async-ppo-math" in specs["e2e-master"].cmd
    assert "--config /run/config.yaml" in specs["e2e-master"].cmd
    assert specs["e2e-master"].cmd.startswith(
        "python -m areal_tpu_torch.apps.remote ")


def test_build_job_specs_multihost_trainer():
    cfg = PPOMATHConfig(experiment_name="big", allocation_mode="d16f2t4",
                        n_gpus_per_node=8)  # 128 GPUs
    specs = {s.name: s for s in build_job_specs(cfg, "/c.yaml")}
    t = specs["big-trainer"]
    assert t.ntasks == 128 and t.nodes == 16  # ceil(128 / 8) nodes
    assert t.ntasks_per_node == 8 and t.gpus_per_node == 8
    assert t.exclusive
    assert "big-gen" not in specs  # colocated sync mode


def test_slurm_client_submit_wait_cancel(tmp_path):
    fake = FakeSlurm()
    client = SlurmClient(str(tmp_path), runner=fake)
    assert client.submit(SlurmJobSpec(name="j1", cmd="echo hi")) == "100"
    assert os.path.exists(tmp_path / "j1.sbatch")
    st = client.wait(poll_secs=0.01, until_done="j1", timeout=5)
    assert st["j1"] == "COMPLETED"
    client.cancel_all()
    assert fake.cancelled == ["100"]


def test_slurm_client_failure_raises(tmp_path):
    fake = FakeSlurm()

    def runner(cmd, **kw):
        r = fake(cmd, **kw)
        if cmd[0] == "squeue":
            jid = list(fake.states)[0]
            r = subprocess.CompletedProcess(cmd, 0, stdout=f"{jid} FAILED\n",
                                            stderr="")
        return r

    client = SlurmClient(str(tmp_path), runner=runner)
    client.submit(SlurmJobSpec(name="bad", cmd="false"))
    with pytest.raises(RuntimeError, match="failed"):
        client.wait(poll_secs=0.01, timeout=5)


def test_states_uses_sacct_for_purged_jobs(tmp_path):
    """A job that crashed and aged out of squeue must not read as
    COMPLETED: sacct has its terminal state."""
    fake = FakeSlurm()
    client = SlurmClient(str(tmp_path), runner=fake)
    client.submit(SlurmJobSpec(name="dead", cmd="false"))
    fake.squeue_calls = 1  # the next poll returns nothing
    fake.sacct_states[client.jobs["dead"]] = "OUT_OF_MEMORY"
    assert client.states()["dead"] == "OUT_OF_MEMORY"
    with pytest.raises(RuntimeError, match="failed"):
        client.wait(poll_secs=0.01, timeout=5)


def test_states_tolerates_squeue_invalid_job_id(tmp_path):
    """squeue exits nonzero when every listed id was purged: a normal end,
    not an error."""
    fake = FakeSlurm()

    def runner(cmd, **kw):
        if cmd[0] == "squeue":
            return subprocess.CompletedProcess(
                cmd, 1, stdout="",
                stderr="slurm_load_jobs error: Invalid job id specified\n")
        return fake(cmd, **kw)

    client = SlurmClient(str(tmp_path), runner=runner)
    client.submit(SlurmJobSpec(name="ok", cmd="true"))
    assert client.states()["ok"] == "COMPLETED"


def test_states_per_id_retry_when_batched_squeue_rejected(tmp_path):
    """One purged id makes ``squeue -j a,b`` exit nonzero saying nothing
    of the others: a job still RUNNING must not read as COMPLETED."""
    fake = FakeSlurm()

    def runner(cmd, **kw):
        if cmd[0] == "squeue":
            jid = cmd[2]
            if "," in jid:
                return subprocess.CompletedProcess(
                    cmd, 1, stdout="",
                    stderr="slurm_load_jobs error: Invalid job id specified\n")
            if jid == live_id:
                return subprocess.CompletedProcess(
                    cmd, 0, stdout=f"{jid} RUNNING\n", stderr="")
            return subprocess.CompletedProcess(
                cmd, 1, stdout="", stderr="Invalid job id specified\n")
        return fake(cmd, **kw)

    client = SlurmClient(str(tmp_path), runner=runner)
    client.submit(SlurmJobSpec(name="gone", cmd="true"))
    client.submit(SlurmJobSpec(name="live", cmd="sleep 100"))
    live_id = client.jobs["live"]
    fake.sacct_states[client.jobs["gone"]] = "COMPLETED"
    st = client.states()
    assert st["live"] == "RUNNING" and st["gone"] == "COMPLETED"


def test_rollout_cmd_has_no_index_flag():
    """``--index $SLURM_PROCID`` would be expanded once by the batch shell
    (to 0) before srun starts the tasks: remote.py reads it in each
    task."""
    cfg = AsyncPPOMATHConfig(experiment_name="e2e",
                             allocation_mode="gen.d4+d2f2t2",
                             n_rollout_workers=3, n_gpus_per_node=8)
    specs = {s.name: s for s in build_job_specs(cfg, "/c.yaml")}
    for s in specs.values():
        assert "--index" not in s.cmd and "SLURM_PROCID" not in s.cmd
        assert "--rank" not in s.cmd and "--world" not in s.cmd


def test_slurm_launcher_end_to_end(tmp_path):
    fake = FakeSlurm()
    cfg = AsyncPPOMATHConfig(experiment_name="slurmexp", trial_name="t0",
                             allocation_mode="gen.d1+d1", mode="slurm",
                             n_gpus_per_node=2)
    cfg.cluster.fileroot = str(tmp_path)
    result = SlurmLauncher(cfg, runner=fake).run()
    assert len(fake.submitted) == 4
    assert sorted(fake.cancelled) == sorted(result["slurm_jobs"].values())
    dumped = list(tmp_path.rglob("config.yaml"))
    assert dumped, "config.yaml must be dumped beside the run"
    assert all(os.path.dirname(p) == os.path.dirname(str(dumped[0]))
               for p in fake.submitted)


def test_run_experiment_takes_the_slurm_branch(tmp_path, monkeypatch):
    from areal_tpu_torch.apps import launcher, slurm

    calls = []
    monkeypatch.setattr(slurm.SlurmLauncher, "run",
                        lambda self: calls.append(self.exp_cfg) or {"x": 1})
    cfg = PPOMATHConfig(experiment_name="m", trial_name="t", mode="slurm")
    cfg.cluster.fileroot = str(tmp_path)
    assert launcher.run_experiment(cfg) == {"x": 1} and calls == [cfg]


def test_remote_entry_role_dispatch(tmp_path):
    """remote.py rebuilds the config from the dump and refuses an unknown
    role or rollout index."""
    from areal_tpu_torch.api import cli_args as CA
    from areal_tpu_torch.apps import remote

    cfg = AsyncPPOMATHConfig(experiment_name="remexp", trial_name="t1",
                             n_rollout_workers=2, allocation_mode="gen.d1+d1",
                             n_gpus_per_node=2)
    cfg.cluster.fileroot = str(tmp_path)
    path = str(tmp_path / "config.yaml")
    CA.save_yaml(cfg, path)
    built = remote.build_config("async-ppo-math", path, backend="cpu")
    assert built.experiment_name == "remexp"
    assert built.n_rollout_workers == 2 and built.backend == "cpu"
    with pytest.raises(SystemExit):
        remote.run_role(built, "rollout", index=7)
    with pytest.raises(SystemExit):
        remote.run_role(built, "nonsense")


@pytest.mark.parametrize("yaml_present", [True, False])
def test_config_dump_round_trip(tmp_path, monkeypatch, yaml_present):
    """``save_yaml`` then ``load_yaml`` gives the config back, with ``yaml``
    and without it (then the file is JSON, which ``yaml.safe_load`` also
    reads); sentinel rule packs travel the same way; a file that reads
    neither way raises."""
    from areal_tpu_torch.api import cli_args as CA

    rule = {"id": "op_step_secs", "metric": "master/step_secs",
            "kind": "threshold", "op": ">", "value": 600.0}
    cfg = AsyncPPOMATHConfig(experiment_name="yexp", trial_name="t",
                             allocation_mode="gen.d1+d2", n_gpus_per_node=4)
    cfg.sentinel.rules = [rule]
    cfg.actor.tiny = {"moe": {"num_experts": 4, "top_k": 2}}
    path = str(tmp_path / "run" / "config.yaml")
    if not yaml_present:
        monkeypatch.setitem(sys.modules, "yaml", None)
    CA.save_yaml(cfg, path)
    text = open(path).read()
    if not yaml_present:
        assert json.loads(text)["experiment_name"] == "yexp"
    back = CA.load_yaml(AsyncPPOMATHConfig(), path)
    assert CA.to_yaml_dict(back) == CA.to_yaml_dict(cfg)
    if not yaml_present:  # the JSON file also loads where yaml is present
        monkeypatch.delitem(sys.modules, "yaml")
        again = CA.load_yaml(AsyncPPOMATHConfig(), path)
        assert CA.to_yaml_dict(again) == CA.to_yaml_dict(cfg)
        monkeypatch.setitem(sys.modules, "yaml", None)
    assert back.sentinel.rules == [rule] and back.n_gpus_per_node == 4
    bad = tmp_path / "bad.yaml"
    bad.write_text("experiment_name: [unclosed\n")
    with pytest.raises(CA.ConfigError):
        CA.load_yaml(AsyncPPOMATHConfig(), str(bad))
    unknown = tmp_path / "unknown.json"
    unknown.write_text(json.dumps({"no_such_key": 1}))
    with pytest.raises(CA.ConfigError, match="no_such_key"):
        CA.load_yaml(AsyncPPOMATHConfig(), str(unknown))


def test_launcher_dumps_config_yaml_in_the_log_dir(tmp_path):
    """The local launcher writes the merged config where the remote workers
    read it (``get_log_path``), before it spawns a worker."""
    from areal_tpu_torch.api import cli_args as CA

    cfg = PPOMATHConfig(experiment_name="dump", trial_name="t")
    cfg.cluster.fileroot = str(tmp_path)
    log = CA.get_log_path(cfg)
    assert log.startswith(str(tmp_path)) and log.endswith("logs")


def test_run_role_dispatches_every_role(tmp_path, monkeypatch):
    """Each role reaches its entry: the master runs its worker, a trainer
    rank gets its rank and world and the ``SLURM_LOCALID``-th GPU, the
    fleet its servers and manager, a rollout worker its index's config."""
    from areal_tpu_torch.apps import launcher as L
    from areal_tpu_torch.apps import remote
    from areal_tpu_torch.system import master_worker

    seen = {}
    monkeypatch.setattr(L, "trainer_entry",
                        lambda exp, tc: seen.setdefault("trainer", tc))
    monkeypatch.setattr(L, "gen_fleet_entry", lambda exp, servers, mgr:
                        seen.setdefault("gen_fleet", (servers, mgr)))
    monkeypatch.setattr(L, "rollout_entry",
                        lambda exp, rc: seen.setdefault("rollout", rc))

    class Master:
        def __init__(self, mcfg, dfg):
            seen["master"] = (mcfg, dfg)

        def run(self):
            seen["master_ran"] = True

    monkeypatch.setattr(master_worker, "MasterWorker", Master)
    cfg = AsyncPPOMATHConfig(experiment_name="roles", trial_name="t",
                             n_rollout_workers=2, allocation_mode="gen.d1+d1",
                             n_gpus_per_node=2, backend="cpu")
    cfg.cluster.fileroot = str(tmp_path)
    remote.run_role(cfg, "master")
    remote.run_role(cfg, "trainer", rank=1, world=2)
    remote.run_role(cfg, "gen_fleet")
    remote.run_role(cfg, "rollout", index=1)
    assert seen["master_ran"]
    assert (seen["trainer"].dist_rank, seen["trainer"].dist_world) == (1, 2)
    assert len(seen["gen_fleet"][0]) >= 1
    assert seen["rollout"].worker_index == 1


def test_trainer_task_takes_its_local_gpu():
    """A trainer task sees every GPU of its node's allocation and keeps the
    ``SLURM_LOCALID``-th; outside a Slurm task nothing changes."""
    from areal_tpu_torch.apps import remote

    env = {"SLURM_LOCALID": "2", "CUDA_VISIBLE_DEVICES": "4,5,6,7"}
    assert remote.select_local_gpu(env) == "6"
    assert env["CUDA_VISIBLE_DEVICES"] == "6"
    env = {"SLURM_LOCALID": "1"}
    assert remote.select_local_gpu(env) == "1"
    assert remote.select_local_gpu({}) is None
