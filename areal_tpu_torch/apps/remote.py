"""The per-task worker entry point for cluster schedulers.

The port's counterpart of ``areal_tpu/apps/remote.py`` (reference
``realhf/apps/remote.py:54``): a scheduler (Slurm, or anything that runs a
command on a node) starts one process per worker with this module; it
rebuilds the experiment's config from the ``config.yaml`` the launcher
dumped and runs exactly one worker role. Workers find each other through
name-resolve, as in local mode, so only the placement of the processes
changes.

Usage (what ``apps/slurm.py`` renders):

    python -m areal_tpu_torch.apps.remote --experiment-cls async-ppo-math \
        --config <run>/logs/config.yaml --role trainer

``--rank``, ``--world`` and ``--index`` default from ``SLURM_PROCID`` and
``SLURM_NTASKS`` inside each task (never rendered into the command: the
batch shell would expand them once, to 0). A trainer rank takes one GPU
(the port runs one rank per device): the ``SLURM_LOCALID``-th of the GPUs
the node's task sees. So does a generation task: with several tasks, task
``p`` runs rank ``p % tp`` of server ``p // tp`` and task 0 also the
manager; one task runs the whole fleet.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from areal_tpu_torch.base import logging

logger = logging.getLogger("apps.remote")

ROLES = ("master", "trainer", "gen_fleet", "rollout")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def build_config(experiment_cls: str, config_path: str,
                 backend: Optional[str] = None):
    """The registered experiment ``experiment_cls``'s config with
    ``config_path`` merged onto it (``api/cli_args.load_yaml``)."""
    from areal_tpu_torch.api import cli_args as CA
    from areal_tpu_torch.experiments import make_experiment_cls

    cfg = make_experiment_cls(experiment_cls)()
    CA.load_yaml(cfg, config_path)
    if backend is not None:
        cfg.backend = backend
    CA.validate_config(cfg)
    cfg.resolve_trial_name()
    return cfg


def select_local_gpu(env=os.environ) -> Optional[str]:
    """Narrow ``CUDA_VISIBLE_DEVICES`` to this task's GPU: entry
    ``SLURM_LOCALID`` of the GPUs the task sees (every GPU of the node's
    allocation), before CUDA starts. Returns the GPU chosen, or None
    outside a Slurm task."""
    local = env.get("SLURM_LOCALID")
    if local in (None, ""):
        return None
    visible = env.get("CUDA_VISIBLE_DEVICES")
    gpus = ([g for g in visible.split(",") if g] if visible
            else [str(i) for i in range(int(local) + 1)])
    gpu = gpus[int(local)]
    env["CUDA_VISIBLE_DEVICES"] = gpu
    return gpu


def run_role(exp_cfg, role: str, rank: int = 0, world: int = 1,
             index: int = 0) -> None:
    """Run one worker role to its end (the scheduler owns the process)."""
    import dataclasses

    from areal_tpu_torch.apps import launcher as L
    from areal_tpu_torch.experiments import common as C

    if role not in ROLES:
        raise SystemExit(f"unknown role {role!r}; have {ROLES}")
    setup = exp_cfg.initial_setup()
    if role == "master":
        from areal_tpu_torch.system.master_worker import MasterWorker

        C.setup_name_resolve(exp_cfg)
        MasterWorker(setup["master"], setup["dfg"]).run()
    elif role == "trainer":
        tc = setup["trainer"]
        if world > 1:
            tc = dataclasses.replace(tc, dist_rank=rank, dist_world=world)
        if exp_cfg._device() is None:
            select_local_gpu()
        L.trainer_entry(exp_cfg, tc)
    elif role == "gen_fleet":
        if "gen_servers" not in setup:
            raise SystemExit("the experiment has no generation fleet (sync "
                             "mode)")
        if world <= 1:  # one task: the servers and the manager together
            L.gen_fleet_entry(exp_cfg, setup["gen_servers"],
                              setup["gserver_manager"])
            return
        # one task per server rank: server rank // n, its rank rank % n
        # (n: a server's fsdp x pp x tp ranks); task 0 also runs the
        # manager
        servers = setup["gen_servers"]
        n = servers[0].world
        if not 0 <= rank < len(servers) * n:
            raise SystemExit(f"generation task {rank} out of range (have "
                             f"{len(servers)} servers of {n} ranks)")
        if exp_cfg._device() is None:
            select_local_gpu()
        if rank == 0:
            from areal_tpu_torch.system.gserver_manager import GserverManager

            C.setup_name_resolve(exp_cfg)
            GserverManager(setup["gserver_manager"]).start()
        L.gen_server_entry(exp_cfg, dataclasses.replace(
            servers[rank // n], rank=rank % n))
    else:
        rcs = setup.get("rollout_workers", [])
        if not 0 <= index < len(rcs):
            raise SystemExit(f"rollout index {index} out of range (have "
                             f"{len(rcs)})")
        L.rollout_entry(exp_cfg, rcs[index])


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--experiment-cls", required=True,
                    help="registered experiment name")
    ap.add_argument("--config", required=True, help="path to config.yaml")
    ap.add_argument("--role", required=True, choices=ROLES)
    ap.add_argument("--rank", type=int, default=_env_int("SLURM_PROCID", 0))
    ap.add_argument("--world", type=int, default=_env_int("SLURM_NTASKS", 1))
    ap.add_argument("--index", type=int, default=_env_int("SLURM_PROCID", 0),
                    help="worker index within the role (rollout); "
                         "SLURM_PROCID inside a task")
    ap.add_argument("--backend", choices=("cuda", "cpu"), default=None,
                    help="every worker's device (default: the config's)")
    args = ap.parse_args(argv)
    cfg = build_config(args.experiment_cls, args.config, args.backend)
    logger.info(f"remote worker: role={args.role} rank={args.rank}/"
                f"{args.world} index={args.index} experiment="
                f"{cfg.experiment_name}/{cfg.trial_name}")
    run_role(cfg, args.role, rank=args.rank, world=args.world,
             index=args.index)


if __name__ == "__main__":
    main()
