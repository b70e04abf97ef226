"""Local experiment launcher.

The port of ``areal_tpu/apps/launcher.py`` (reference
``realhf/apps/main.py:80`` + ``scheduler/local/client.py:71`` +
``training/utils.py:123``) on its local paths: one spawned process per
worker, the master in this process, the children supervised while it
runs, then an orderly teardown.

 - sync (``ppo-math``): the trainer (generation included);
 - async (``async-ppo-math``): the trainer, a generation-fleet process (the
   servers and the manager, each on threads of their own) and the rollout
   workers, which never initialise CUDA; with a decoupled allocation
   (``gen.d2f2p2t2+...``) the manager runs alone (``gen_manager``) and
   each of the spec's ``dp`` servers in processes of its own, one per
   rank of its ``fsdp × pp × tp`` (``gen_replica``), on GPUs of its own
   (:func:`derive_server_gpus`);
 - either, with ``reward_service.enabled``: the reward workers, CPU-only
   processes that see no card, spawned before the rollout side.

Processes are spawned, never forked, so no child inherits a CUDA context.
Every worker but the reward workers runs on ``exp_cfg.backend``'s device:
``cuda``, or the CPU when asked for.

Supervision (``system/supervisor.py``, ``fault_tolerance``): a dead
rollout worker, generation fleet or reward worker is respawned in place
with backoff behind a crash-loop breaker; a trainer's death escalates, and
``run_experiment``'s ``recover_mode=auto|fault`` loop relaunches the whole
experiment from the last recover checkpoint. With
``fault_tolerance.supervise=false`` any death fails the run. SIGTERM (or
:meth:`LocalLauncher.request_drain`) drains gracefully: pause, an
out-of-band recover checkpoint, orderly exits. At the end the rollout and
reward workers are told to exit (in-flight rollouts return their quota),
the trainer exits on the master's word, and the rest is terminated; every
wait is bounded.

With ``auto_eval`` an :class:`~areal_tpu_torch.apps.evaluator.
AutomaticEvaluator` watches the save directory of the graph's trained role
(``actor``, or SFT's ``default``) while the run lasts and scores each saved
checkpoint in an eval subprocess on the run's device; the scores go to
``eval/*`` beside the master's scalars and into the result's
``auto_eval``. At the end it is stopped, an eval still running included.

With ``autoscale.enabled`` the monitor loop also steps the
:class:`~areal_tpu_torch.system.autoscaler.AutoscaleExecutor`: it reads the
manager's plan and spawns dynamic single-server workers (``gen_server``,
not required, expendable) on the baseline fleet's device with the baseline
server's serving settings; each joins through the manager's discovery and
weight reconcile and serves a control endpoint, so that a drained one ends
in a commanded exit.

``probes`` is an instrumentation seam for measurement scripts: a map from
a worker kind (``trainer``, ``gen_fleet``, ``gen_server``,
``gen_replica``, ``gen_manager``, ``rollout``, ``reward``) to a picklable
callable that the child calls with its worker(s) once they are built (a
meshed server's leader only); a callable it returns is called after the
worker's run. A respawned child gets its kind's probe too.

Several trainer ranks (a trainer spec wider than one device, reference
``launcher.py:436-474``): one trainer process per rank, each with its
``dist_rank`` / ``dist_world``, supervised as the ``trainer`` kind, so a
dead rank escalates once as a trainer death and the supervisor's shutdown
(or ``recover_mode=auto``'s relaunch) takes the whole group down and up.
On ``cuda`` each rank sees one GPU (``CUDA_VISIBLE_DEVICES``, from
:func:`derive_chip_assignment`), and each rank of a decoupled allocation's
generation servers sees its own GPU (and, under the ``device`` transport,
the trainer's rank-0 GPU after it, where the publication lives). A meshed
server's ranks are one failure domain of the supervisor: a dead rank
brings the server's ranks down and up together.

The launcher dumps the merged config as ``config.yaml`` into the run's
log directory (``api/cli_args.save_yaml``; JSON where ``yaml`` is absent),
as the reference does (``launcher.py:420``); ``mode=slurm`` hands the
experiment to ``apps/slurm.py SlurmLauncher``, whose tasks start their
workers through ``apps/remote.py`` from that file.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from areal_tpu_torch.base import logging

logger = logging.getLogger("apps.launcher")


def derive_chip_assignment(alloc_mode: str,
                           n_gpus: int) -> Dict[str, List[int]]:
    """This host's GPUs split between the trainer and the generation fleet
    from a decoupled allocation mode (reference ``derive_chip_assignment:62``;
    the port sets ``CUDA_VISIBLE_DEVICES`` from it where the reference sets
    its TPU chip variables). Returns ``{"trainer": [...], "gen": [...]}``;
    raises when the layout does not fit."""
    from areal_tpu_torch.parallel.mesh import AllocationMode

    am = AllocationMode.parse(alloc_mode) if alloc_mode else None
    if am is None or not am.decoupled:
        return {"trainer": list(range(n_gpus)), "gen": []}
    need_t = am.global_spec.world_size
    need_g = am.gen_spec.world_size
    if need_t + need_g > n_gpus:
        raise RuntimeError(
            f"allocation mode '{alloc_mode}' needs {need_t} trainer + "
            f"{need_g} generation GPUs but this host has {n_gpus}; shrink "
            "the specs (e.g. gen.d1+d1 needs 2 GPUs) or run sync mode "
            "(colocated) where trainer and generation share the same GPUs")
    return {"trainer": list(range(need_t)),
            "gen": list(range(need_t, need_t + need_g))}


def derive_server_gpus(alloc_mode: str, n_gpus: int,
                       device_transport: bool = False
                       ) -> List[List[List[int]]]:
    """Each generation server's GPUs of a decoupled allocation, by rank:
    the generation spec's ``dp`` servers, server ``i`` taking the
    generation GPUs ``[i*n, (i+1)*n)`` of :func:`derive_chip_assignment`
    for its ``n = fsdp*pp*tp`` ranks, one per rank (one process each). With
    the ``device`` transport every rank also sees the trainer's rank-0 GPU,
    after its own: its publication is opened there (by UUID,
    ``parallel/reshard.py``) and copied to the rank's GPU. Returns
    ``[server][rank] -> visible GPUs``; [] when not decoupled."""
    from areal_tpu_torch.parallel.mesh import AllocationMode, server_spec

    asg = derive_chip_assignment(alloc_mode, n_gpus)
    if not asg["gen"]:
        return []
    gen_spec = AllocationMode.parse(alloc_mode).gen_spec
    n = server_spec(gen_spec).world_size
    extra = [asg["trainer"][0]] if device_transport else []
    return [[[asg["gen"][i * n + r], *extra] for r in range(n)]
            for i in range(gen_spec.dp)]


def _gpu_env(gpus: Optional[List[int]]) -> Dict[str, str]:
    return ({} if not gpus
            else {"CUDA_VISIBLE_DEVICES": ",".join(str(g) for g in gpus)})


def _resolve_tokenizer(exp_cfg):
    from areal_tpu_torch.experiments import common as C

    role = getattr(exp_cfg, "actor", None) or exp_cfg.model  # SFT: model
    return C.make_tokenizer(exp_cfg, role.path)


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
    device = resolve_device(exp_cfg._device())
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


def _server_mesh(exp_cfg, server_cfg, device):
    """A meshed server's process group (its fsdp x pp x tp ranks, a
    rendezvous of its own under the server's id and incarnation, apart
    from the trainer's) and its mesh."""
    from areal_tpu_torch.parallel import distributed as dist_mod
    from areal_tpu_torch.parallel.mesh import ParallelSpec, make_mesh
    from areal_tpu_torch.system import worker_base as wb

    inc = os.environ.get(wb.ENV_INCARNATION, "1")
    dist_mod.initialize(exp_cfg.experiment_name, exp_cfg.trial_name,
                        server_cfg.rank, server_cfg.world,
                        group=f"gen_{server_cfg.server_id}_{inc}",
                        device=device)
    return make_mesh(ParallelSpec.parse(server_cfg.spec))


def gen_server_entry(exp_cfg, server_cfg, probe=None) -> None:
    """One generation server, or rank ``server_cfg.rank`` of a meshed one
    (a spec of more than one rank: one process per rank,
    ``system/server_mesh.py``): a
    decoupled allocation's servers, and the autoscaler's unit of
    scale-up. A server starts from the actor's initial weights, registers
    under ``names.gen_servers`` and is reconciled to the current version
    by the manager's health gate before it serves; its control endpoint
    (``genserver_<server_id>``, the leader's) takes the commanded exit of
    a drained scale-down or of the launcher's shutdown. The endpoint opens
    before the model is built: an exit commanded while the server builds
    waits there and is served once it is built, and the server then exits
    without serving (otherwise the command finds no endpoint, and the
    shutdown terminates the server when its wait runs out). A follower
    replays its leader's calls until the leader stops; a meshed server
    that fails as a unit ends its process with an error, so that the
    supervisor respawns its ranks together."""
    from areal_tpu_torch import resolve_device
    from areal_tpu_torch.experiments import common as C
    from areal_tpu_torch.system.generation_server import GenerationServer
    from areal_tpu_torch.system.server_mesh import MeshServerError
    from areal_tpu_torch.system.worker_base import WorkerControl

    C.setup_name_resolve(exp_cfg)
    device = resolve_device(exp_cfg._device())
    mesh = (_server_mesh(exp_cfg, server_cfg, device)
            if server_cfg.world > 1 else None)
    if server_cfg.rank > 0:
        cfg, params = _build_gen_model(exp_cfg, device)
        srv = GenerationServer(server_cfg, cfg, params, device=device,
                               mesh=mesh)
        del params
        srv.follow()
        return
    ctrl = WorkerControl(exp_cfg.experiment_name, exp_cfg.trial_name,
                         f"genserver_{server_cfg.server_id}")
    done = None

    def status():  # served once the server is built
        return {"server_id": server_cfg.server_id, "version": srv.version}

    try:
        cfg, params = _build_gen_model(exp_cfg, device)
        eos = getattr(_resolve_tokenizer(exp_cfg), "eos_token_id", None)
        if eos is not None:
            server_cfg.eos_token_id = int(eos)
        srv = GenerationServer(server_cfg, cfg, params, device=device,
                               mesh=mesh)
        del params
        # before the start: the manager may route to the server as soon as
        # it registers
        done = probe(srv) if probe is not None else None
        ctrl.step(status)  # an exit commanded while the model was built
        if not ctrl.should_exit:
            srv.start()
        try:
            while not ctrl.should_exit:
                if srv.failed is not None:
                    raise MeshServerError(
                        f"server {server_cfg.server_id} failed as a unit: "
                        f"{srv.failed!r}")
                ctrl.step(status, 200)
        finally:
            srv.stop()
    finally:
        ctrl.close()
    if done is not None:
        done()


def gen_manager_entry(exp_cfg, manager_cfg, probe=None) -> None:
    """The generation manager alone, until the launcher terminates it: a
    decoupled allocation's servers run in processes of their own
    (:func:`gen_server_entry`)."""
    from areal_tpu_torch.experiments import common as C
    from areal_tpu_torch.system.gserver_manager import GserverManager

    C.setup_name_resolve(exp_cfg)
    mgr = GserverManager(manager_cfg)
    mgr.start()
    if probe is not None:
        probe(mgr)
    while True:
        time.sleep(3600)


def reward_worker_entry(exp_cfg, rw_cfg, probe=None) -> None:
    """One sandbox reward worker (``system/reward_worker.py``). It sees no
    card (the launcher spawns it with ``CUDA_VISIBLE_DEVICES=""``):
    untrusted code grades on spare host cores, never on the card that
    trains."""
    from areal_tpu_torch.experiments import common as C
    from areal_tpu_torch.system.reward_worker import RewardWorker

    C.setup_name_resolve(exp_cfg)
    worker = RewardWorker(rw_cfg)
    done = probe(worker) if probe is not None else None
    worker.run()
    if done is not None:
        done()


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
    """Spawn the workers, run the master here, supervise, tear down."""

    # bounds on the teardown's waits
    ROLLOUT_EXIT_SECS = 60.0
    TRAINER_EXIT_SECS = 60.0
    TERMINATE_SECS = 15.0

    def __init__(self, exp_cfg, probes: Optional[Dict[str, Callable]] = None):
        from areal_tpu_torch.api.train_config import FaultToleranceConfig

        self.exp_cfg = exp_cfg
        self.probes = probes or {}
        self.ft = (getattr(exp_cfg, "fault_tolerance", None)
                   or FaultToleranceConfig())
        self.supervisor = None  # built in run() once the trial is known
        self._scaler = None  # the AutoscaleExecutor, with autoscale on
        self.evaluator = None  # the AutomaticEvaluator, with auto_eval on
        self._server_gpus: List[List[List[int]]] = []
        self._drain_evt = threading.Event()
        self._drain_thread: Optional[threading.Thread] = None
        self._drain_deadline: Optional[float] = None
        self._drain_failed = False

    def request_drain(self) -> None:
        """Ask for a graceful drain (the SIGTERM handler's path): pause,
        an out-of-band recover checkpoint, orderly exits. Safe from any
        thread or signal handler."""
        self._drain_evt.set()

    @property
    def procs(self) -> List:
        return self.supervisor.procs() if self.supervisor else []

    def _spawn(self, target, *args, name: str, kind: str,
               required: bool = True, expendable: bool = False,
               env: Optional[Dict[str, str]] = None,
               group: Optional[str] = None, rank: int = 0) -> None:
        from areal_tpu_torch.system.supervisor import WorkerSpec

        self.supervisor.spawn(WorkerSpec(
            name=name, kind=kind, target=target,
            args=(*args, self.probes.get(kind)), required=required,
            expendable=expendable, env=env or {}, group=group, rank=rank))

    def _spawn_server(self, exp, sc, kind: str,
                      gpus: Optional[List[List[int]]] = None,
                      required: bool = True,
                      expendable: bool = False) -> None:
        """One generation server's processes, one per rank of its spec
        (``gpus``: each rank's visible GPUs), supervised as one failure
        domain."""
        for r in range(sc.world):
            self._spawn(
                gen_server_entry, exp, dataclasses.replace(sc, rank=r),
                name=(f"genserver_{sc.server_id}" if r == 0
                      else f"genrank_{sc.server_id}_{r}"),
                kind=kind, required=required, expendable=expendable,
                env=_gpu_env(gpus[r] if gpus else None),
                group=f"genserver_{sc.server_id}" if sc.world > 1 else None,
                rank=r)

    def _build_scaler(self, exp, setup: Dict[str, Any]):
        """The actuator of the manager's plan: dynamic single-server
        workers from a copy of the baseline server's config, on the same
        device. Not required (a commanded exit after a drain is expected)
        and expendable (a crash loop removes one; the plan replaces it)."""
        import copy

        from areal_tpu_torch.system.autoscaler import AutoscaleExecutor

        template = setup["gen_servers"][0]
        # a meshed dynamic server's ranks share the GPUs of the first
        # baseline server's ranks
        gpus = self._server_gpus[0] if self._server_gpus else None

        def spawn_dyn(server_id: str) -> None:
            sc = copy.deepcopy(template)
            sc.server_id = server_id
            sc.port = None
            self._spawn_server(exp, sc, "gen_server", gpus, required=False,
                               expendable=True)

        return AutoscaleExecutor(exp.experiment_name, exp.trial_name,
                                 self.supervisor, spawn_dyn)

    def _check_children(self) -> None:
        """One supervision sweep: a stateless death respawns in place; a
        stateful death or a crash loop raises SupervisorEscalation."""
        self.supervisor.check()

    def _install_sigterm(self) -> Callable[[], None]:
        """SIGTERM drives the graceful drain instead of killing children
        outright. Returns the restore; a no-op off the main thread (a test
        launching in a thread)."""
        import signal

        try:
            prev = signal.getsignal(signal.SIGTERM)

            def on_term(signum, frame):
                logger.warning("SIGTERM: starting the graceful drain")
                self._drain_evt.set()

            signal.signal(signal.SIGTERM, on_term)
            return lambda: signal.signal(signal.SIGTERM, prev)
        except ValueError:  # not the main thread
            return lambda: None

    def run(self) -> Dict[str, Any]:
        from areal_tpu_torch.experiments import common as C
        from areal_tpu_torch.system.master_worker import MasterWorker
        from areal_tpu_torch.system.supervisor import (
            RESTARTABLE_KINDS,
            RestartPolicy,
            Supervisor,
        )

        exp = self.exp_cfg
        if exp._device() is None:
            import torch

            # Fail here, not in every child; is_available() leaves this
            # process's CUDA uninitialised (the master never needs it).
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device available; pass "
                                   "backend=cpu (--backend=cpu) to run on "
                                   "the CPU")
        exp.resolve_trial_name()
        C.setup_name_resolve(exp)
        self.supervisor = Supervisor(
            exp.experiment_name, exp.trial_name,
            policy=RestartPolicy.from_config(self.ft),
            keepalive_ttl=self.ft.keepalive_ttl_secs,
            heartbeat_interval=self.ft.heartbeat_interval_secs,
            # supervise=false: any death escalates at once
            restartable_kinds=RESTARTABLE_KINDS if self.ft.supervise else ())
        setup = exp.initial_setup()
        # the merged config beside the run, as the remote workers read it
        from areal_tpu_torch.api import cli_args as CA

        CA.save_yaml(exp, os.path.join(CA.get_log_path(exp), "config.yaml"))
        n_dist = C.trainer_world(C.resolve_allocation(exp))
        gpus = self._gpu_assignment(exp, n_dist)
        restore_sigterm = lambda: None  # noqa: E731
        try:
            for r in range(n_dist):
                tc = setup["trainer"]
                if n_dist > 1:
                    tc = dataclasses.replace(tc, dist_rank=r,
                                             dist_world=n_dist)
                self._spawn(
                    trainer_entry, exp, tc, kind="trainer",
                    name="trainer" if n_dist == 1 else f"trainer{r}",
                    env=_gpu_env(None if gpus is None
                                 else [gpus["trainer"][r]]))
            # The reward fleet before the rollout side: it registers well
            # within the fleet's start-up, so the first grade never races
            # its registration into local code execution.
            for i, rw in enumerate(setup.get("reward_workers", [])):
                self._spawn(reward_worker_entry, exp, rw, name=f"reward{i}",
                            kind="reward", env={"CUDA_VISIBLE_DEVICES": ""})
            if "gen_servers" in setup and not C.resolve_allocation(
                    exp).decoupled:
                self._spawn(gen_fleet_entry, exp, setup["gen_servers"],
                            setup["gserver_manager"], name="gen_fleet",
                            kind="gen_fleet",
                            env=_gpu_env(gpus and gpus["gen"]))
            elif "gen_servers" in setup:
                # decoupled: the manager alone, and each server's ranks in
                # processes of their own on the server's GPUs
                self._spawn(gen_manager_entry, exp, setup["gserver_manager"],
                            name="gen_manager", kind="gen_manager",
                            env={"CUDA_VISIBLE_DEVICES": ""})
                if gpus is not None:
                    self._server_gpus = derive_server_gpus(
                        exp.allocation_mode, gpus["n_gpus"],
                        exp.weight_sync.transport == "device")
                for i, sc in enumerate(setup["gen_servers"]):
                    self._spawn_server(
                        exp, sc, "gen_replica",
                        self._server_gpus[i] if self._server_gpus else None)
            if "gen_servers" in setup:
                for i, rc in enumerate(setup["rollout_workers"]):
                    # A bounded worker (max_rollouts) finishing its quota
                    # exits 0 by design.
                    self._spawn(rollout_entry, exp, rc, name=f"rollout{i}",
                                kind="rollout",
                                required=rc.max_rollouts is None)
                if getattr(getattr(exp, "autoscale", None), "enabled", False):
                    self._scaler = self._build_scaler(exp, setup)
            if getattr(exp, "auto_eval", False):
                self.evaluator = self._build_evaluator(exp, setup)
                self.evaluator.start()
            master = MasterWorker(setup["master"], setup["dfg"])
            restore_sigterm = self._install_sigterm()
            result = self._run_master_monitored(master)
        finally:
            restore_sigterm()
            if self.evaluator is not None:
                self.evaluator.stop()
            self.shutdown()
        if self.evaluator is not None:
            result["auto_eval"] = [dataclasses.asdict(s)
                                   for s in self.evaluator.steps]
        return result

    @staticmethod
    def _gpu_assignment(exp, n_dist: int) -> Optional[Dict[str, List[int]]]:
        """On ``cuda`` with several trainer ranks or a decoupled
        allocation: the GPUs of each role (one per trainer rank). None
        otherwise: every worker sees every GPU, as on one card."""
        from areal_tpu_torch.parallel.mesh import AllocationMode

        alloc = getattr(exp, "allocation_mode", "") or ""
        decoupled = bool(alloc) and AllocationMode.parse(alloc).decoupled
        if exp._device() is not None or (n_dist <= 1 and not decoupled):
            return None
        import torch

        n_gpus = torch.cuda.device_count()
        asg = dict(derive_chip_assignment(alloc, n_gpus), n_gpus=n_gpus)
        if len(asg["trainer"]) < n_dist:
            raise RuntimeError(
                f"a trainer of {n_dist} ranks needs a GPU per rank; the "
                f"trainer has {len(asg['trainer'])}")
        logger.info(f"GPU assignment: {asg}")
        return asg

    def _build_evaluator(self, exp, setup: Dict[str, Any]):
        """The evaluator of ``auto_eval`` (reference launcher.py:506-572):
        held-out data, the ``eval/`` writer, the reward-fleet hand-off,
        and the role whose checkpoints it scores."""
        from areal_tpu_torch.api.cli_args import AutomaticEvaluatorConfig
        from areal_tpu_torch.api.dfg import MFCInterfaceType
        from areal_tpu_torch.apps.evaluator import AutomaticEvaluator
        from areal_tpu_torch.experiments import common as C

        eval_data = exp.auto_eval_config.data_names
        default_names = AutomaticEvaluatorConfig().data_names
        if not os.path.isfile(eval_data):
            if eval_data and eval_data != default_names:
                # An explicit eval set that does not exist is a config
                # error: scoring the training set would pass for held-out
                # accuracy.
                raise FileNotFoundError(
                    f"auto_eval_config.data_names={eval_data!r} does not "
                    f"exist; point it at a prompt jsonl (the default "
                    f"{default_names!r} falls back to the training set)")
            logger.warning(
                f"auto_eval_config.data_names={eval_data!r} is not a local "
                f"file: the evaluator scores the training dataset "
                f"({exp.dataset.path}); eval/* metrics are NOT held-out")
            eval_data = exp.dataset.path
        writer = None
        tb = getattr(setup["master"], "tensorboard_path", None)
        if tb:
            from areal_tpu_torch.base.monitor import MetricWriter

            writer = MetricWriter(tensorboard_path=os.path.join(tb, "eval"))
        # With the reward fleet up, eval generations grade there too:
        # untrusted output must not run in the eval subprocess either.
        rs = None
        if getattr(getattr(exp, "reward_service", None), "enabled", False):
            nr_cfg = exp.cluster.name_resolve
            nr_root = ""
            if nr_cfg.type == "nfs":  # a memory repo cannot cross processes
                nr_root = (nr_cfg.nfs_record_root
                           or C.experiment_paths(exp)["name_resolve"])
            rs = (exp.experiment_name, exp.trial_name, nr_root,
                  json.dumps(dataclasses.asdict(exp.reward_service)))
        # The graph's trained role: the master saves each under
        # {save_dir}/{model_name}/step{N}; PPO's actor, SFT's default.
        trained = [n.model_name for n in setup["dfg"].nodes.values()
                   if n.interface_type == MFCInterfaceType.TRAIN_STEP]
        role = "actor" if "actor" in trained or not trained else trained[0]
        evaluator = AutomaticEvaluator(
            exp.auto_eval_config, save_dir=setup["master"].save_dir,
            dataset_path=eval_data, role=role, metric_writer=writer,
            mock_tokenizer=bool(getattr(exp, "mock_tokenizer", False)),
            reward_service=rs, device=exp._device() or "cuda")
        logger.info(f"automatic evaluator watching "
                    f"{setup['master'].save_dir}/{role} (data: {eval_data})")
        return evaluator

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
            if self._drain_evt.is_set() and self._drain_thread is None:
                self._start_drain()
            if self._drain_deadline is not None and (
                    self._drain_failed
                    or time.monotonic() > self._drain_deadline):
                # The graceful path failed or overran its budget while the
                # master kept running: tear down now rather than train
                # through a preemption notice.
                raise RuntimeError("graceful drain failed or timed out; "
                                   "forcing teardown")
            # A dead child would leave the master waiting forever: the
            # supervisor respawns it or escalates.
            self._check_children()
            if self._scaler is not None:
                try:
                    self._scaler.step()
                except Exception as e:  # noqa: BLE001 — scaling is best
                    # effort: a bad plan must not end the run
                    logger.warning(f"autoscale executor step failed: {e}")
            t.join(timeout=1.0)
        if err:
            # A dead child is the likelier cause (the master's stream to a
            # killed trainer breaks first): the supervisor's verdict wins.
            self._check_children()
            raise err[0]
        return result

    def _start_drain(self) -> None:
        """The drain's control sequence on a side thread, while the monitor
        loop keeps watching the children; the master returning ends the
        run. If the sequence fails, or the master outlives twice the
        budget, the monitor loop tears the run down."""
        from areal_tpu_torch.system.supervisor import drain_experiment

        exp = self.exp_cfg
        self.supervisor.begin_drain()
        budget = self.ft.drain_timeout_secs
        self._drain_deadline = time.monotonic() + 2 * budget

        def _drain():
            try:
                drain_experiment(exp.experiment_name, exp.trial_name,
                                 timeout=budget)
            except Exception as e:  # noqa: BLE001 — the monitor enforces
                logger.warning(f"graceful drain failed ({e}); the monitor "
                               "loop will force the teardown")
                self._drain_failed = True

        self._drain_thread = threading.Thread(target=_drain, daemon=True,
                                              name="drain")
        self._drain_thread.start()

    def shutdown(self) -> None:
        """Rollout and reward workers exit on command, the trainer on the
        master's word; the rest is terminated, then killed. Every child is
        joined before this returns."""
        if self._drain_thread is not None:
            self._drain_thread.join(timeout=self.ft.drain_timeout_secs)
        if self.supervisor is not None:
            self.supervisor.shutdown(timeout=2 * self.TERMINATE_SECS,
                                     exit_secs=self.ROLLOUT_EXIT_SECS,
                                     stateful_secs=self.TRAINER_EXIT_SECS)


def run_experiment(exp_cfg, probes: Optional[Dict[str, Callable]] = None
                   ) -> Dict[str, Any]:
    """The entry of ``training/main_*.py`` (reference
    ``training/utils.py:339``): validate, launch locally, return the
    master's result (``steps``, per-step ``stats``).

    ``recover_mode`` in {disabled, resume, auto, fault}: "resume" restores
    from the last recover checkpoint; "auto" and "fault" also relaunch the
    whole experiment, with recovery, when a launch fails (a supervisor
    escalation among the causes), up to ``recover_retries`` times, after a
    capped exponential backoff. Before a relaunch the trial's name-resolve
    subtree is cleared: every key in it belongs to the torn-down launch."""
    from areal_tpu_torch.api.cli_args import validate_config

    validate_config(exp_cfg)
    if getattr(exp_cfg, "mode", "local") == "slurm":
        from areal_tpu_torch.apps.slurm import SlurmLauncher

        return SlurmLauncher(exp_cfg).run()
    recover_mode = getattr(exp_cfg, "recover_mode", "disabled")
    retries = (getattr(exp_cfg, "recover_retries", 1)
               if recover_mode in ("auto", "fault") else 0)
    ft = getattr(exp_cfg, "fault_tolerance", None)
    base = getattr(ft, "relaunch_backoff_secs", 5.0)
    cap = getattr(ft, "relaunch_backoff_max_secs", 60.0)
    attempt = 0
    while True:
        try:
            return LocalLauncher(exp_cfg, probes=probes).run()
        except Exception:
            attempt += 1
            if attempt > retries:
                raise
            backoff = min(base * 2 ** (attempt - 1), cap)
            logger.warning(f"experiment failed (attempt {attempt}/{retries}); "
                           f"relaunching with recovery in {backoff:.1f}s")
            try:
                from areal_tpu_torch.base import name_resolve, names

                name_resolve.clear_subtree(names.trial_root(
                    exp_cfg.experiment_name, exp_cfg.trial_name))
            except Exception as e:  # noqa: BLE001 — best-effort hygiene
                logger.warning(f"stale name_resolve clear failed: {e}")
            time.sleep(backoff)
            exp_cfg.recover_mode = "resume"
