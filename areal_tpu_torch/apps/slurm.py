"""The Slurm client and launcher: one ``sbatch`` job per worker group.

The port's counterpart of ``areal_tpu/apps/slurm.py`` (reference
``realhf/scheduler/slurm/client.py:78`` and ``realhf/apps/main.py:80``):
:func:`render_sbatch_script`, :class:`SlurmClient` (submit, poll, cancel;
its command runner injectable, so tests need no cluster),
:func:`build_job_specs` and :class:`SlurmLauncher` (``mode=slurm``). Every
task runs ``python -m areal_tpu_torch.apps.remote`` over the dumped
``config.yaml``, so the worker code is that of local mode.

Differences from the reference, by design: GPUs are requested where it
requests TPUs (``--gres=gpu:N``, per node); the trainer job runs one task
per GPU (the port's rank per device, where the reference runs one process
per host), on ``ceil(world / n_gpus_per_node)`` nodes, and each task
selects its GPU by ``SLURM_LOCALID`` (``apps/remote.py``); the generation
job runs one task per server rank (``data_degree x tp``), one GPU each.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional

from areal_tpu_torch.base import logging

logger = logging.getLogger("apps.slurm")

Runner = Callable[..., "subprocess.CompletedProcess"]

# squeue states of a job still going, and the terminal states of a failure
ACTIVE_STATES = {"PENDING", "RUNNING", "CONFIGURING", "COMPLETING",
                 "SUSPENDED", "REQUEUED"}
FAILED_STATES = {"FAILED", "CANCELLED", "TIMEOUT", "NODE_FAIL",
                 "OUT_OF_MEMORY", "PREEMPTED", "BOOT_FAIL", "DEADLINE"}


@dataclasses.dataclass
class SlurmJobSpec:
    """One worker group: one sbatch job whose ``srun`` runs ``cmd`` in each
    of its ``ntasks`` tasks."""

    name: str
    cmd: str
    ntasks: int = 1
    nodes: Optional[int] = None  # None: Slurm packs the tasks
    ntasks_per_node: Optional[int] = None
    cpus_per_task: int = 2
    mem_per_task_mb: int = 8192
    gpus_per_node: int = 0  # a --gres=gpu:N request when > 0
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    time_limit: Optional[str] = None
    partition: Optional[str] = None
    container: Optional[str] = None  # a pyxis image, where the cluster has one
    exclusive: bool = False


def render_sbatch_script(spec: SlurmJobSpec, log_dir: str) -> str:
    """The sbatch file of one worker group (reference
    ``slurm/utils.py:144``)."""
    lines = ["#!/bin/bash", f"#SBATCH --job-name={spec.name}",
             f"#SBATCH --ntasks={spec.ntasks}"]
    if spec.nodes:
        lines.append(f"#SBATCH --nodes={spec.nodes}")
    if spec.ntasks_per_node:
        lines.append(f"#SBATCH --ntasks-per-node={spec.ntasks_per_node}")
    lines.append(f"#SBATCH --cpus-per-task={spec.cpus_per_task}")
    lines.append(f"#SBATCH --mem-per-cpu="
                 f"{max(1, spec.mem_per_task_mb // spec.cpus_per_task)}M")
    if spec.gpus_per_node:
        lines.append(f"#SBATCH --gres=gpu:{spec.gpus_per_node}")
    if spec.partition:
        lines.append(f"#SBATCH --partition={spec.partition}")
    if spec.time_limit:
        lines.append(f"#SBATCH --time={spec.time_limit}")
    if spec.exclusive:
        lines.append("#SBATCH --exclusive")
    lines += [f"#SBATCH --output={log_dir}/{spec.name}.%j.out",
              f"#SBATCH --error={log_dir}/{spec.name}.%j.err", ""]
    lines += [f"export {k}={v!r}" for k, v in sorted(spec.env.items())]
    srun = "srun"
    if spec.container:
        srun += f" --container-image={spec.container}"
    lines += [f"{srun} {spec.cmd}", ""]
    return "\n".join(lines)


class SlurmClient:
    """Submits, polls and cancels sbatch jobs through ``runner``
    (``subprocess.run`` by default)."""

    def __init__(self, log_dir: str, runner: Optional[Runner] = None):
        self.log_dir = log_dir
        self.runner = runner or subprocess.run
        self.jobs: Dict[str, str] = {}  # name -> job id

    def _run(self, cmd: List[str]) -> "subprocess.CompletedProcess":
        r = self.runner(cmd, capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cmd)} failed rc={r.returncode}: {r.stderr}")
        return r

    def submit(self, spec: SlurmJobSpec) -> str:
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, f"{spec.name}.sbatch")
        with open(path, "w") as f:
            f.write(render_sbatch_script(spec, self.log_dir))
        job_id = self._run(["sbatch", "--parsable", path]
                           ).stdout.strip().split(";")[0]
        self.jobs[spec.name] = job_id
        logger.info(f"submitted {spec.name} as slurm job {job_id}")
        return job_id

    def _sacct_states(self, ids: List[str]) -> Dict[str, str]:
        """Terminal states of jobs gone from the queue; {} where ``sacct``
        is not available (no accounting storage)."""
        try:
            r = self.runner(["sacct", "-j", ",".join(ids), "-n", "-X", "-P",
                             "-o", "JobID,State"],
                            capture_output=True, text=True, timeout=120)
        except Exception as e:  # noqa: BLE001 — sacct is best-effort
            logger.warning(f"sacct unavailable: {e}")
            return {}
        if r.returncode != 0:
            logger.warning(f"sacct rc={r.returncode}: {r.stderr.strip()}")
            return {}
        out = {}
        for line in r.stdout.strip().splitlines():
            parts = line.split("|")
            if len(parts) >= 2:  # "CANCELLED by 1234" -> CANCELLED
                out[parts[0]] = parts[1].split()[0] if parts[1] else ""
        return out

    def _squeue(self, ids: str, strict: bool = True
                ) -> Optional[Dict[str, str]]:
        """id -> state of the listed jobs still queued; None when squeue
        rejects the list (a purged id; with ``strict``, any other failure
        raises)."""
        r = self.runner(["squeue", "-j", ids, "-h", "-o", "%i %T"],
                        capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            if strict and "invalid job id" not in (r.stderr or "").lower():
                raise RuntimeError(f"squeue failed rc={r.returncode}: "
                                   f"{r.stderr}")
            return None
        return {p[0]: p[1] for p in (line.split() for line in
                                     r.stdout.strip().splitlines())
                if len(p) >= 2}

    def states(self) -> Dict[str, str]:
        """name -> Slurm state. A job gone from the queue reads its
        terminal state from sacct (a crashed job that aged out must not
        read as COMPLETED); squeue exits nonzero when any listed id was
        purged, saying nothing of the others, so each id is then asked
        alone."""
        if not self.jobs:
            return {}
        by_id = self._squeue(",".join(self.jobs.values()))
        if by_id is None:
            by_id = {}
            for jid in self.jobs.values():
                by_id.update(self._squeue(jid, strict=False) or {})
        gone = [j for j in self.jobs.values() if j not in by_id]
        sacct = self._sacct_states(gone) if gone else {}
        return {name: by_id.get(jid) or sacct.get(jid) or "COMPLETED"
                for name, jid in self.jobs.items()}

    def wait(self, poll_secs: float = 10.0, until_done: Optional[str] = None,
             timeout: Optional[float] = None) -> Dict[str, str]:
        """Until a job fails (raises), every job completes, or the job
        ``until_done`` completes (the launcher waits on the master)."""
        deadline = time.monotonic() + timeout if timeout else None
        while True:
            st = self.states()
            failed = {n: s for n, s in st.items() if s in FAILED_STATES}
            if failed:
                raise RuntimeError(f"slurm jobs failed: {failed}")
            if until_done and st.get(until_done) == "COMPLETED":
                return st
            if all(s == "COMPLETED" for s in st.values()):
                return st
            if deadline and time.monotonic() > deadline:
                raise TimeoutError(f"slurm wait timed out; states={st}")
            time.sleep(poll_secs)

    def cancel_all(self) -> None:
        for name, jid in self.jobs.items():
            try:
                self._run(["scancel", jid])
            except RuntimeError as e:  # noqa: PERF203 — best-effort teardown
                logger.warning(f"scancel {name} ({jid}): {e}")


def build_job_specs(exp_cfg, config_path: str) -> List[SlurmJobSpec]:
    """The experiment's worker groups as sbatch jobs: the master; the
    trainer, one task per GPU of its allocation; for a decoupled
    allocation the generation fleet and the rollout workers."""
    from areal_tpu_torch.experiments import registered_name_of
    from areal_tpu_torch.experiments.common import trainer_world
    from areal_tpu_torch.parallel.mesh import AllocationMode, server_spec

    exp = exp_cfg.experiment_name
    base = (f"python -m areal_tpu_torch.apps.remote --experiment-cls "
            f"{registered_name_of(exp_cfg)} --config {config_path}")
    am = AllocationMode.parse(getattr(exp_cfg, "allocation_mode", "") or "d1")
    per_node = max(1, getattr(exp_cfg, "n_gpus_per_node", 1))
    world = trainer_world(am)
    nodes = -(-world // per_node)
    specs = [
        SlurmJobSpec(name=f"{exp}-master", cmd=f"{base} --role master"),
        SlurmJobSpec(name=f"{exp}-trainer", cmd=f"{base} --role trainer",
                     ntasks=world, nodes=nodes,
                     ntasks_per_node=min(world, per_node),
                     gpus_per_node=min(world, per_node), cpus_per_task=8,
                     mem_per_task_mb=64 * 1024, exclusive=nodes > 1),
    ]
    if am.decoupled:
        # one task per server rank (dp servers of fsdp x pp x tp ranks),
        # one GPU each; task 0 also runs the manager (apps/remote.py)
        gen = am.gen_spec.dp * server_spec(am.gen_spec).world_size
        gen_nodes = -(-gen // per_node)
        specs.append(SlurmJobSpec(
            name=f"{exp}-gen", cmd=f"{base} --role gen_fleet",
            ntasks=gen, nodes=gen_nodes,
            ntasks_per_node=min(gen, per_node),
            gpus_per_node=min(gen, per_node), cpus_per_task=8,
            mem_per_task_mb=64 * 1024))
        # no --index: the batch shell would expand $SLURM_PROCID once (to
        # 0) before srun starts the tasks; remote.py reads it in each task
        specs.append(SlurmJobSpec(
            name=f"{exp}-rollout", cmd=f"{base} --role rollout",
            ntasks=max(1, getattr(exp_cfg, "n_rollout_workers", 1))))
    return specs


class SlurmLauncher:
    """``mode=slurm``: dump ``config.yaml``, submit one job per worker
    group, wait on the master, cancel every job at the end (reference
    ``apps/main.py:80``)."""

    def __init__(self, exp_cfg, runner: Optional[Runner] = None):
        self.exp_cfg = exp_cfg
        self.runner = runner

    def run(self) -> Dict[str, Any]:
        from areal_tpu_torch.api import cli_args as CA
        from areal_tpu_torch.experiments import common as C

        exp = self.exp_cfg
        exp.resolve_trial_name()
        C.setup_name_resolve(exp)
        log_dir = CA.get_log_path(exp)
        config_path = os.path.join(log_dir, "config.yaml")
        CA.save_yaml(exp, config_path)
        client = SlurmClient(log_dir, runner=self.runner)
        try:
            for spec in build_job_specs(exp, config_path):
                client.submit(spec)
            client.wait(until_done=f"{exp.experiment_name}-master")
            return {"steps": None, "slurm_jobs": dict(client.jobs)}
        finally:
            client.cancel_all()
