"""Local experiment launcher.

The port of ``areal_tpu/apps/launcher.py`` (reference
``realhf/apps/main.py:80`` + ``scheduler/local/client.py:71`` +
``training/utils.py:123``) on its local paths: one spawned process per
worker, the master in this process, the children watched while it runs,
then an orderly teardown.

 - sync (``ppo-math``): the trainer (generation included);
 - async (``async-ppo-math``): the trainer, a generation-fleet process (the
   servers and the manager, each on threads of their own) and the rollout
   workers, which never initialise CUDA.

Processes are spawned, never forked, so no child inherits a CUDA context.
Every worker runs on ``exp_cfg.backend``'s device: ``cuda``, or the CPU
when asked for. A dead child fails the run loudly: nothing restarts it.
At the end the rollout workers are told to exit (their in-flight rollouts
return their quota), the trainer has exited on the master's word, and the
fleet process is terminated; every wait is bounded.

``probes`` is an instrumentation seam for measurement scripts: a map from
a worker kind (``trainer``, ``gen_fleet``, ``rollout``) to a picklable
callable that the child calls with its worker object(s) once they are
built; a callable it returns is called after the worker's run.

Left out: the supervisor's restarts, drain and relaunch, the autoscale
executor, the evaluator, reward workers and slurm (ROADMAP.md).
"""

from __future__ import annotations

import json
import multiprocessing as mp
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from areal_tpu_torch.base import logging

logger = logging.getLogger("apps.launcher")


def _device(exp_cfg) -> Optional[str]:
    return "cpu" if getattr(exp_cfg, "backend", "cuda") == "cpu" else None


def _resolve_tokenizer(exp_cfg):
    from areal_tpu_torch.experiments import common as C

    return C.make_tokenizer(exp_cfg, exp_cfg.actor.path)


def trainer_entry(exp_cfg, trainer_cfg, probe=None) -> None:
    from areal_tpu_torch.experiments import common as C
    from areal_tpu_torch.system.trainer_worker import TrainerWorker

    C.setup_name_resolve(exp_cfg)
    trainer_cfg.tokenizer = _resolve_tokenizer(exp_cfg)
    worker = TrainerWorker(trainer_cfg)
    done = probe(worker) if probe is not None else None
    worker.run()
    if done is not None:
        done()


def _build_gen_model(exp_cfg, device):
    """The generation servers' model from the actor's init: a tiny test
    model or an HF directory, in the actor's compute dtype (float32 for a
    tiny model, as its trainer engine computes)."""
    import torch

    from areal_tpu_torch.experiments.common import model_init_dict

    init = model_init_dict(exp_cfg.actor)
    dtype = (torch.bfloat16 if exp_cfg.actor.bf16 and "tiny" not in init
             else torch.float32)
    if "tiny" in init:
        from areal_tpu_torch.models.config import tiny_config
        from areal_tpu_torch.models.transformer import init_params

        kw = dict(init["tiny"])
        seed = kw.pop("seed", 0)
        cfg = tiny_config(**kw)
        params = init_params(cfg, seed=seed, device=device)
    else:
        from areal_tpu_torch.models import hf

        cfg, params = hf.load_hf_model(init["hf_dir"], device=device)
    return cfg, {k: v.to(dtype) for k, v in params.items()}


def gen_fleet_entry(exp_cfg, server_cfgs, manager_cfg, probe=None) -> None:
    """The generation servers and the manager in one process, until the
    launcher terminates it."""
    from areal_tpu_torch import resolve_device
    from areal_tpu_torch.experiments import common as C
    from areal_tpu_torch.system.generation_server import GenerationServer
    from areal_tpu_torch.system.gserver_manager import GserverManager

    C.setup_name_resolve(exp_cfg)
    device = resolve_device(_device(exp_cfg))
    cfg, params = _build_gen_model(exp_cfg, device)
    eos = getattr(_resolve_tokenizer(exp_cfg), "eos_token_id", None)
    servers = []
    for sc in server_cfgs:
        if eos is not None:
            sc.eos_token_id = int(eos)
        srv = GenerationServer(sc, cfg, params, device=device)
        srv.start()
        servers.append(srv)
    del params
    mgr = GserverManager(manager_cfg)
    mgr.start()
    if probe is not None:
        probe(servers, mgr)
    while True:
        time.sleep(3600)


def rollout_entry(exp_cfg, rollout_cfg, probe=None) -> None:
    """One rollout worker: asyncio and HTTP, no device."""
    from areal_tpu_torch.experiments import common as C
    from areal_tpu_torch.system.rollout_worker import RolloutWorker

    C.setup_name_resolve(exp_cfg)
    rollout_cfg.tokenizer = _resolve_tokenizer(exp_cfg)
    eos = getattr(rollout_cfg.tokenizer, "eos_token_id", None)
    if eos is not None:
        rollout_cfg.eos_token_id = int(eos)
    worker = RolloutWorker(rollout_cfg)
    done = probe(worker) if probe is not None else None
    worker.run()
    if done is not None:
        done()


class LocalLauncher:
    """Spawn the workers, run the master here, watch the children, tear
    down."""

    # bounds on the teardown's waits
    ROLLOUT_EXIT_SECS = 60.0
    TRAINER_EXIT_SECS = 60.0
    TERMINATE_SECS = 15.0

    def __init__(self, exp_cfg, probes: Optional[Dict[str, Callable]] = None):
        self.exp_cfg = exp_cfg
        self.probes = probes or {}
        self._ctx = mp.get_context("spawn")
        # (name, kind, process, required)
        self.children: List[tuple] = []

    def _spawn(self, target, *args, name: str, kind: str,
               required: bool = True) -> None:
        p = self._ctx.Process(target=target,
                              args=(*args, self.probes.get(kind)),
                              name=name, daemon=True)
        p.start()
        self.children.append((name, kind, p, required))
        logger.info(f"spawned {name} (pid {p.pid})")

    def _finishing(self) -> bool:
        """The master's marker: the trainer's clean exit is expected."""
        from areal_tpu_torch.base import name_resolve, names

        exp = self.exp_cfg
        try:
            st = json.loads(name_resolve.get(names.experiment_status(
                exp.experiment_name, exp.trial_name)))
        except (name_resolve.NameEntryNotFoundError, ValueError):
            return False
        return st.get("status") == "finishing"

    def _check_children(self) -> None:
        for name, kind, p, required in self.children:
            code = p.exitcode
            if code is None or (code == 0 and not required):
                continue
            if code == 0 and kind == "trainer" and self._finishing():
                continue
            raise RuntimeError(f"worker {name} exited with code {code} "
                               "while the experiment ran; no supervisor "
                               "restarts it")

    def run(self) -> Dict[str, Any]:
        from areal_tpu_torch.experiments import common as C
        from areal_tpu_torch.system.master_worker import MasterWorker

        exp = self.exp_cfg
        if _device(exp) is None:
            import torch

            # Fail here, not in every child; is_available() leaves this
            # process's CUDA uninitialised (the master never needs it).
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device available; pass "
                                   "backend=cpu (--backend=cpu) to run on "
                                   "the CPU")
        exp.resolve_trial_name()
        C.setup_name_resolve(exp)
        setup = exp.initial_setup()
        try:
            self._spawn(trainer_entry, exp, setup["trainer"], name="trainer",
                        kind="trainer")
            if "gen_servers" in setup:
                self._spawn(gen_fleet_entry, exp, setup["gen_servers"],
                            setup["gserver_manager"], name="gen_fleet",
                            kind="gen_fleet")
                for i, rc in enumerate(setup["rollout_workers"]):
                    # A bounded worker (max_rollouts) may finish early.
                    self._spawn(rollout_entry, exp, rc, name=f"rollout{i}",
                                kind="rollout",
                                required=rc.max_rollouts is None)
            master = MasterWorker(setup["master"], setup["dfg"])
            return self._run_master_monitored(master)
        finally:
            self.shutdown()

    def _run_master_monitored(self, master) -> Dict[str, Any]:
        result: Dict[str, Any] = {}
        err: List[BaseException] = []

        def run():
            try:
                result.update(master.run())
            except BaseException as e:  # noqa: BLE001 — surfaced below
                err.append(e)

        t = threading.Thread(target=run, daemon=True, name="master")
        t.start()
        while t.is_alive():
            # A dead child would leave the master waiting forever: fail the
            # run instead (the master thread is a daemon).
            self._check_children()
            t.join(timeout=1.0)
        if err:
            raise err[0]
        return result

    def shutdown(self) -> None:
        """Rollout workers exit on command (their in-flight rollouts return
        their quota); the trainer exits on the master's word; the fleet is
        terminated. Whatever outlives its bound is terminated, then
        killed."""
        from areal_tpu_torch.system.worker_base import WorkerControlPanel

        rollouts = [c for c in self.children if c[1] == "rollout"]
        if rollouts:
            exp = self.exp_cfg
            panel = WorkerControlPanel(exp.experiment_name, exp.trial_name,
                                       timeout=10.0)
            try:
                for name, _, p, _ in rollouts:
                    if p.is_alive():
                        panel.try_command(name, "exit")
            finally:
                panel.close()
            deadline = time.monotonic() + self.ROLLOUT_EXIT_SECS
            for _, _, p, _ in rollouts:
                p.join(max(deadline - time.monotonic(), 0.1))
        for name, kind, p, _ in self.children:
            if kind == "trainer":
                p.join(self.TRAINER_EXIT_SECS)
        for name, _, p, _ in self.children:
            if p.is_alive():
                p.terminate()
                p.join(self.TERMINATE_SECS)
            if p.is_alive():
                logger.warning(f"{name} outlived SIGTERM; killing it")
                p.kill()
                p.join(self.TERMINATE_SECS)


def run_experiment(exp_cfg, probes: Optional[Dict[str, Callable]] = None
                   ) -> Dict[str, Any]:
    """The entry of ``training/main_*.py`` (reference
    ``training/utils.py:339``): validate, launch locally, return the
    master's result (``steps``, per-step ``stats``)."""
    from areal_tpu_torch.api.cli_args import validate_config

    validate_config(exp_cfg)
    return LocalLauncher(exp_cfg, probes=probes).run()
