"""The trainer worker: hosts the model roles and executes MFCs.

The port's counterpart of ``areal_tpu/system/trainer_worker.py:68-1164``
(reference ``realhf/system/model_worker.py:101``). One process holds every
role's engine on one device and serves the master's request stream:

 - ``fetch``       the next dataset batch → store → metadata
 - ``mfc``         one MFC (generate / inference / train_step) over stored
                   samples, with its hooks; outputs stored, metadata replied
 - ``clear``       drop sample ids from the store
 - ``model_info``  geometry and device for the master's FLOPs and MFU
 - ``ckpt`` / ``restore``  recover checkpoints (train state, interface
                   state, the dataset cursor); a restore republishes the
                   roles the master names, at the restored version
 - ``version`` / ``exit``

Hooks on an MFC: ``weight_update`` publishes a role's weights for the
generation servers over ``weight_sync.transport`` (``disk``: a native
checkpoint under ``realloc_dir/<role>/<version>``; ``stream``: the role's
``WeightStreamPublisher``; ``device``: one packed device buffer shared by
its CUDA IPC handle, ``parallel/reshard.py publish_device``), sets
``names.model_version_time`` and ``names.model_version`` and deletes the
other transports' keys; ``save`` writes an HF checkpoint;
``param_realloc`` moves the source role's weights into the target's layout
(``reshard_pytree``, no copy when they match) and then the target toward
them by EMA, in f32.

Several ranks (``dist_world > 1``, reference ``trainer_worker.py:144``):
one trainer process per device joins one process group
(``parallel/distributed.py initialize``) and each role's engine runs on a
mesh of the role's ``parallel_spec``. Rank 0 alone owns the control plane
(the request stream, the dataset or the trajectory puller, telemetry) and
broadcasts each fetched batch and each request; the other ranks replay them
in the same order (``_follow_once``). A rank-local failure of a handler
that mutates state (``mfc``, ``restore``, ``clear``) raises on that rank,
which brings the group down, rather than let the ranks diverge.
Checkpoints and published weights are gathered on every rank and written
by rank 0.

With ``stream_dataset`` (the async loop) there is no dataset: a
``TrajectoryPuller`` registered under the trainer's handler name receives
the rollout workers' trajectories on a thread of its own, and ``fetch``
returns whatever arrived within 0.5 s (possibly fewer samples than asked,
possibly none; the master accumulates across fetches).

Observability (``telemetry``, ``goodput``, ``compile_watch``; all off by
default): the ``trainer/data_wait``, ``trainer/mfc`` and
``trainer/weight_publish`` spans, the ``train/*`` gauges of every train
step (what the sentinel's rules read), live MFU, the terminal
``trainer/train_sample`` span of every traced sample, the goodput ledger
(data_wait / compute / comm / idle), device-memory gauges and watermarks,
and the profiler trigger (``torch.profiler``), polled between requests.
With ``AREAL_DUMP_TRACE=<dir>`` every MFC runs under its own
``torch.profiler`` capture (a Chrome trace under ``<dir>/<mfc>_<version>``).

Durable ingest (``system/sample_spool.py``): a pushed dict that carries
``_spool`` passes :class:`~areal_tpu_torch.system.sample_spool.SpoolIngest`
at the puller (duplicates dropped, a replay past
``durability.replay_staleness_limit`` durably dropped and acked), and
``clear``, which the master sends after the step's recover checkpoint,
acks the settled samples back to each rollout worker's ack channel.

"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import queue
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from areal_tpu_torch import resolve_device
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model import (
    FinetuneSpec,
    Model,
    make_backend,
    make_dataset,
    make_interface,
)
from areal_tpu_torch.api.train_config import (
    CompileWatchConfig,
    DurabilityConfig,
    GoodputConfig,
    RewardServiceConfig,
    TelemetryConfig,
    WeightSyncConfig,
)
from areal_tpu_torch.base import (
    compile_watch,
    logging,
    monitor,
    name_resolve,
    names,
    telemetry,
)
from areal_tpu_torch.models import convert, hf
from areal_tpu_torch.system import goodput as goodput_mod
from areal_tpu_torch.system import memwatch
from areal_tpu_torch.system.sample_spool import (
    SPOOL_KEY,
    SpoolIngest,
    ack_channel_name,
)
from areal_tpu_torch.system.streams import (
    Payload,
    TrajectoryPuller,
    TrajectoryPusher,
    WorkerRequestServer,
)
from areal_tpu_torch.system.weight_stream import WeightStreamPublisher
from areal_tpu_torch.system.worker_base import WorkerControl

logger = logging.getLogger("system.trainer")


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the tensor itself otherwise)."""
    return getattr(t, "_local_tensor", t)


@dataclasses.dataclass
class ModelRoleConfig:
    """One model role (actor / critic / ref / reward) of the trainer."""

    # The model's source: {"hf_dir": path} (an HF model directory; with
    # "is_critic": True a value head instead of the LM head),
    # {"ckpt_dir": path} (a native or port HF checkpoint),
    # {"tiny": {**tiny_config kwargs, "seed": n}} or {"null": True}.
    init: Dict[str, Any] = dataclasses.field(default_factory=dict)
    backend: str = "torch_train"
    backend_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    train: bool = True


@dataclasses.dataclass
class MFCRuntimeConfig:
    """Interface binding for one MFC name."""

    interface: str = "ppo_actor"
    interface_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    model_name: str = "actor"
    method: str = "train_step"


@dataclasses.dataclass
class TrainerWorkerConfig:
    experiment: str = "exp"
    trial: str = "trial"
    handler: str = "trainer"
    models: Dict[str, ModelRoleConfig] = dataclasses.field(default_factory=dict)
    mfcs: Dict[str, MFCRuntimeConfig] = dataclasses.field(default_factory=dict)
    dataset: Optional[str] = None
    dataset_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    batch_size: int = 8
    ft_spec: FinetuneSpec = dataclasses.field(default_factory=FinetuneSpec)
    tokenizer: Any = None
    # The async loop: samples come from the rollout stream, not a dataset.
    stream_dataset: bool = False
    realloc_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "areal_tpu", "realloc"))
    # The worker's default transport is disk, as the reference's is.
    weight_sync: WeightSyncConfig = dataclasses.field(
        default_factory=lambda: WeightSyncConfig(transport="disk"))
    telemetry: TelemetryConfig = dataclasses.field(
        default_factory=TelemetryConfig)
    goodput: GoodputConfig = dataclasses.field(default_factory=GoodputConfig)
    # arms the kernel-build watch and the device-memory gauges
    compile_watch: CompileWatchConfig = dataclasses.field(
        default_factory=CompileWatchConfig)
    # Sync mode's rw_inf grades on the reward fleet when it is enabled.
    reward_service: RewardServiceConfig = dataclasses.field(
        default_factory=RewardServiceConfig)
    # Where every role lives (areal_tpu_torch.resolve_device): cuda unless
    # named; without a GPU and without a device, setup() raises.
    device: Optional[str] = None
    # the staleness gate of spooled replays (replay_staleness_limit)
    durability: DurabilityConfig = dataclasses.field(
        default_factory=DurabilityConfig)
    # Several ranks: this process's rank and the group's size (one rank per
    # device; the launcher starts one process per rank).
    dist_rank: int = 0
    dist_world: int = 1


class TrainerWorker:
    def __init__(self, cfg: TrainerWorkerConfig,
                 model_factory: Optional[Callable[[str, ModelRoleConfig],
                                                  Model]] = None):
        """``model_factory(role, role_cfg) -> Model`` lets a caller bring
        its own models; the default builds them from ``role_cfg.init``.
        ``setup()`` builds the roles; a caller that sets ``models`` itself
        may publish without it."""
        self.cfg = cfg
        self.store: Dict[Any, SequenceSample] = {}
        self.models: Dict[str, Model] = {}
        self.interfaces: Dict[str, Any] = {}
        self._mfc_cfg = cfg.mfcs
        self._server: Optional[WorkerRequestServer] = None
        self._dataset = None
        self._data_iter: List[int] = []
        self._epoch = 0
        self._epoch_pos = 0
        self._model_factory = model_factory or self._default_model_factory
        self._exiting = False
        self._followers_told_exit = False
        self._weight_publishers: Dict[str, WeightStreamPublisher] = {}
        self.device: Optional[torch.device] = None
        self._puller: Optional[TrajectoryPuller] = None
        self._pull_q: "queue.Queue[SequenceSample]" = queue.Queue()
        self._pull_thread: Optional[threading.Thread] = None
        # durable ingest (armed with the puller) and one ack pusher per
        # rollout worker
        self._ingest: Optional[SpoolIngest] = None
        self._ack_pushers: Dict[int, TrajectoryPusher] = {}
        self._ack_lock = threading.Lock()
        # Observability, armed by setup() (the null objects while off).
        self._profiler: Optional[telemetry.ProfilerTriggerWatcher] = None
        self._ledger = goodput_mod.NULL_LEDGER
        self._mfu: Optional[goodput_mod.MfuEmitter] = None

    @property
    def _rank0(self) -> bool:
        return self.cfg.dist_rank == 0

    def _bcast(self, obj):
        """Rank 0's ``obj`` on every rank (itself at one rank)."""
        if self.cfg.dist_world > 1:
            from areal_tpu_torch.parallel import distributed as dist

            return dist.broadcast_pyobj(obj)
        return obj

    # ---------------- setup ----------------

    def _default_model_factory(self, role: str, rc: ModelRoleConfig) -> Model:
        if "hf_dir" in rc.init:
            # The reference loads hf_dir with an LM head whatever the role
            # (its trainer_worker.py:195-196); "is_critic" asks for the
            # value head (ROADMAP.md, accepted differences).
            cfg, params = hf.load_hf_model(
                rc.init["hf_dir"], is_critic=bool(rc.init.get("is_critic")),
                device=self.device)
            return Model(role, (cfg, params))
        if "ckpt_dir" in rc.init:
            return Model(role, hf.load_checkpoint_auto(rc.init["ckpt_dir"],
                                                       self.device))
        if "tiny" in rc.init:  # a fabricated test model
            from areal_tpu_torch.models.config import tiny_config
            from areal_tpu_torch.models.transformer import init_params

            kw = dict(rc.init["tiny"])
            seed = kw.pop("seed", 0)
            cfg = tiny_config(**kw)
            return Model(role, (cfg, init_params(cfg, seed, self.device)))
        if rc.init.get("null"):  # tokenizer-only role (rule-based reward)
            return Model(role, None)
        raise ValueError(f"role {role}: no model source in init={rc.init}")

    def setup(self) -> None:
        # The registries fill as their modules import.
        import areal_tpu_torch.algorithms.fused  # noqa: F401
        import areal_tpu_torch.algorithms.ppo  # noqa: F401
        import areal_tpu_torch.algorithms.reward  # noqa: F401
        import areal_tpu_torch.algorithms.rw  # noqa: F401
        import areal_tpu_torch.algorithms.sft  # noqa: F401
        import areal_tpu_torch.backend.torch_train  # noqa: F401
        import areal_tpu_torch.datasets.jsonl  # noqa: F401

        cfg = self.cfg
        self.device = resolve_device(cfg.device)
        if cfg.dist_world > 1:
            from areal_tpu_torch.parallel import distributed as dist

            dist.initialize(cfg.experiment, cfg.trial, cfg.dist_rank,
                            cfg.dist_world, group="trainer",
                            device=self.device)
        for role, rc in cfg.models.items():
            model = self._model_factory(role, rc)
            if model.tokenizer is None:
                model.tokenizer = cfg.tokenizer
            if rc.backend == "null" or model.module is None:
                self.models[role] = model
                continue
            backend = make_backend(rc.backend, **{
                "train": rc.train, "device": self.device, **rc.backend_args})
            self.models[role] = backend.initialize(model, cfg.ft_spec)
        for mfc_name, mc in self._mfc_cfg.items():
            self.interfaces[mfc_name] = make_interface(mc.interface,
                                                       **mc.interface_args)
        # This process's grading mode (rewards/client.py): with the service
        # on, rw_inf's batch_reward fans out to the reward fleet; off, the
        # local path is unchanged.
        from areal_tpu_torch.rewards import client as reward_client

        reward_client.configure_service(cfg.reward_service, cfg.experiment,
                                        cfg.trial)
        # Rank 0 owns the data plane and the master's request stream; the
        # other ranks receive everything by broadcast.
        if not self._rank0:
            logger.info(f"trainer rank {cfg.dist_rank}/{cfg.dist_world} up "
                        f"on {self.device}: models={list(self.models)}")
            return
        if cfg.dataset is not None:
            self._dataset = make_dataset(cfg.dataset, tokenizer=cfg.tokenizer,
                                         **cfg.dataset_args)
            self._reshuffle()
        if cfg.stream_dataset:
            self._puller = TrajectoryPuller(cfg.experiment, cfg.trial,
                                            cfg.handler)
            self._ingest = SpoolIngest(
                staleness_limit=cfg.durability.replay_staleness_limit)
            self._pull_thread = threading.Thread(
                target=self._pull_loop, daemon=True, name="trainer-pull")
            self._pull_thread.start()
        self._server = WorkerRequestServer(cfg.experiment, cfg.trial,
                                           cfg.handler)
        if cfg.telemetry.enabled:
            self._setup_observability()
        logger.info(f"trainer up on {self.device}: models={list(self.models)} "
                    f"mfcs={list(self.interfaces)}")

    def _setup_observability(self) -> None:
        """Telemetry, the profiler trigger, the goodput ledger with live
        MFU, and the compile and memory watches (the module-global
        facades the engine's spans and watermarks call through)."""
        cfg = self.cfg
        telemetry.configure(cfg.experiment, cfg.trial, "trainer", 0,
                            cfg.telemetry)
        self._profiler = telemetry.ProfilerTriggerWatcher(cfg.experiment,
                                                          cfg.trial)
        if cfg.goodput.enabled:
            self._ledger = goodput_mod.make_ledger(cfg.goodput,
                                                   telemetry.get())
            self._mfu = goodput_mod.MfuEmitter(
                telemetry.get(),
                goodput_mod.resolve_peak_flops(cfg.goodput,
                                               self._device_kind()),
                tflops_name="train/achieved_tflops", mfu_name="train/mfu",
                context="trainer")
        compile_watch.configure(cfg.compile_watch, telemetry.get())
        memwatch.configure(cfg.compile_watch, telemetry.get())

    def _device_kind(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return str(self.device)

    def _reshuffle(self):
        rng = np.random.RandomState(self._epoch + 1)
        self._data_iter = list(rng.permutation(len(self._dataset)))
        self._epoch_pos = 0

    def _pull_loop(self) -> None:
        while not self._exiting:
            obj = self._puller.pull(timeout_ms=200)
            if obj is not None:
                # the durable spool's framing, absent on a plain push
                spool_meta = (obj.pop(SPOOL_KEY, None)
                              if isinstance(obj, dict) else None)
                # The rollout worker's trace context rides in the sample's
                # metadata through the master's buffer and this store, so
                # the train step can close the trace.
                trace = telemetry.extract_payload(obj)
                s = SequenceSample.from_json_compatible(obj)
                if trace is not None:
                    s.metadata["_trace"] = [trace.as_dict()]
                if (spool_meta is not None and self._ingest is not None
                        and not self._ingest_spooled(s, spool_meta)):
                    continue
                self._pull_q.put(s)

    def _ingest_spooled(self, s: SequenceSample, meta: Dict) -> bool:
        """The at-least-once ingest decision; False: drop the sample.

        A duplicate is a normal event (a re-send racing its own ack, or a
        replay of a settled record whose ack was lost): dropped, and acked
        again when already settled. A replay whose version lags past the
        bound is durably dropped, counted and acked: the staleness contract
        holds across a trainer outage too."""
        cur = max((m.version.global_step for m in self.models.values()),
                  default=0)
        sample_ver = None
        if "version_end" in s.data:
            sample_ver = float(np.asarray(s.data["version_end"]).reshape(-1)[0])
        action, ackp = self._ingest.observe(s.ids[0], meta, cur, sample_ver)
        if action == "duplicate":
            telemetry.inc("spool/duplicate_dropped")
            if ackp is not None:
                self._send_acks({ackp[0]: [ackp[1]]})
            return False
        if action == "stale":
            telemetry.inc("spool/replay_stale_dropped")
            self._send_acks({ackp[0]: [ackp[1]]})
            return False
        return True

    def _send_acks(self, by_worker: Dict[int, List[int]]) -> None:
        """Push settled seqnos to each rollout worker's ack channel. Best
        effort: a lost ack is recovered by the worker's resend timer and the
        settled-duplicate re-ack here, so a failure is logged, not
        retried."""
        if not by_worker:
            return
        with self._ack_lock:
            for w, seqnos in by_worker.items():
                try:
                    pusher = self._ack_pushers.get(w)
                    if pusher is None:
                        pusher = TrajectoryPusher(
                            self.cfg.experiment, self.cfg.trial,
                            ack_channel_name(w), timeout=5.0, block_secs=1.0)
                        self._ack_pushers[w] = pusher
                    pusher.push({"seqnos": [int(x) for x in seqnos]})
                except Exception as e:  # noqa: BLE001 — worker down/respawning
                    logger.warning(f"ack push to rollout worker {w} failed "
                                   f"({e}); its resend timer will recover")
                    # a respawned worker binds a new address under the key
                    stale = self._ack_pushers.pop(w, None)
                    if stale is not None:
                        stale.close()

    # ---------------- handlers ----------------

    def _read_batch(self, n: int) -> Optional[SequenceSample]:
        """The next ``n`` dataset samples; in stream mode whatever arrived
        within 0.5 s (fewer than ``n``, or None): returning early keeps the
        serve loop responsive while the master accumulates."""
        if self.cfg.stream_dataset:
            out: List[SequenceSample] = []
            deadline = time.monotonic() + 0.5
            while len(out) < n and time.monotonic() < deadline:
                try:
                    out.append(self._pull_q.get(timeout=0.1))
                except queue.Empty:
                    if out:
                        break
            return SequenceSample.gather(out) if out else None
        idx = []
        while len(idx) < n and self._dataset is not None:
            if self._epoch_pos >= len(self._data_iter):
                self._epoch += 1
                self._reshuffle()
            idx.append(self._data_iter[self._epoch_pos])
            self._epoch_pos += 1
        return SequenceSample.gather([self._dataset[i] for i in idx])

    def _store_batch(self, batch: SequenceSample) -> None:
        for i in range(batch.bs):
            s = batch.select_idx([i])
            self.store[s.ids[0]] = s

    def _handle_fetch(self, p: Payload) -> Any:
        with telemetry.span("trainer/data_wait",
                            stream=self.cfg.stream_dataset) as attrs, \
                self._ledger.state("data_wait"):
            batch = self._read_batch(int(p.data or self.cfg.batch_size))
            attrs["n_seqs"] = batch.bs if batch is not None else 0
        telemetry.set_gauge("trainer/pull_queue_depth", self._pull_q.qsize())
        if batch is not None:
            # every rank stores the same batch
            self._bcast(("fetch", batch))
            self._store_batch(batch)
        return {
            "meta": batch.meta() if batch is not None else None,
            "epoch": self._epoch,
            "epoch_pos": self._epoch_pos,
            "dataset_size": len(self._dataset) if self._dataset else -1,
        }

    def _gather_input(self, ids, input_keys, remap) -> SequenceSample:
        batch = SequenceSample.gather([self.store[i] for i in ids])
        if remap:
            batch = SequenceSample(
                ids=list(batch.ids), keys=set(batch.keys),
                seqlens=dict(batch.seqlens), data=dict(batch.data),
                metadata=dict(batch.metadata))
            batch.remap_keys_(remap)
        return batch

    def _handle_mfc(self, p: Payload) -> Any:
        req = p.data  # {"mfc": name, "ids": [...], "method": ...}
        if req.get("method") == "noop":
            # a hook-only request (a save the master asked for)
            for hook in p.pre_hooks + p.post_hooks:
                self._run_hook(hook)
            return {"stats": None, "meta": None}
        mfc_name = req["mfc"]
        mc = self._mfc_cfg[mfc_name]
        iface = self.interfaces[mfc_name]
        model = self.models[mc.model_name]
        batch = self._gather_input(req["ids"], req.get("input_keys"),
                                   req.get("input_remap"))
        mb_spec = p.mb_spec or MicroBatchSpec()
        method = req.get("method", mc.method)
        for hook in p.pre_hooks:
            self._run_hook(hook)
        trace_dir = os.environ.get("AREAL_DUMP_TRACE")
        t_mfc_wall = time.time()
        t_mfc = time.monotonic()
        with telemetry.span("trainer/mfc", mfc=mfc_name, method=method,
                            n_seqs=batch.bs), \
                self._ledger.state("compute"):
            if trace_dir:
                out = self._profiled_mfc(
                    os.path.join(trace_dir,
                                 f"{mfc_name}_{model.version.global_step}"),
                    getattr(iface, method), model, batch, mb_spec)
            else:
                out = getattr(iface, method)(model, batch, mb_spec)
        result: Dict[str, Any] = {"stats": None, "meta": None}
        if method == "train_step":
            result["stats"] = out
            dur = time.monotonic() - t_mfc
            self._export_train_stats(mfc_name, out)
            self._emit_mfu(mc.model_name, batch, dur)
            self._emit_terminal_spans(req["ids"], model, t_mfc_wall, dur)
        elif out is not None:
            remap = req.get("output_remap") or {}
            if remap:
                out.remap_keys_(remap)
            if method == "generate":
                # Flattened trajectories replace the prompt samples.
                for i in range(out.bs):
                    s = out.select_idx([i])
                    self.store[s.ids[0]] = s
                for old_id in req["ids"]:
                    self.store.pop(old_id, None)
            else:
                for i, sid in enumerate(out.ids):
                    self.store[sid].update_(out.select_idx([i]))
            result["meta"] = out.meta()
        for hook in p.post_hooks:
            self._run_hook(hook)
        return result

    def _profiled_mfc(self, out_dir: str, fn, *args):
        """One MFC under its own ``torch.profiler`` capture (reference
        ``REAL_DUMP_TRACE``), written as a Chrome trace under
        ``out_dir``."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            out = fn(*args)
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        return out

    # The divergence signatures that kill RL runs get a distribution view
    # on top of the last-value gauge (suffix _dist: a gauge and a
    # histogram cannot share one Prometheus family name).
    _TRAIN_DIST_KEYS = ("approx_kl", "entropy", "grad_norm",
                        "importance_weight", "clip_ratio")

    def _export_train_stats(self, mfc_name: str,
                            stats: Optional[Dict[str, Any]]) -> None:
        """Every train-step scalar as a ``train/<name>{mfc=...}`` gauge:
        the sentinel's rules and any Prometheus reader consume these.
        No-op with telemetry disabled."""
        if not stats or not telemetry.enabled():
            return
        for k, v in stats.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)) \
                    or not math.isfinite(v):
                continue
            telemetry.set_gauge(f"train/{k}{{mfc={mfc_name}}}", float(v))
            if k in self._TRAIN_DIST_KEYS:
                telemetry.observe(f"train/{k}_dist{{mfc={mfc_name}}}",
                                  float(v))

    def _emit_mfu(self, role: str, batch: SequenceSample,
                  dur_secs: float) -> None:
        """Live achieved FLOP/s and MFU of one train MFC: the batch's
        token counts through ``base/monitor.py``'s formulas (the engine's
        remat factor included) over the MFC's wall time on this one
        device. No-op with goodput disabled."""
        if self._mfu is None or dur_secs <= 0:
            return
        engine = self.models[role].module
        cfg = getattr(engine, "cfg", None)
        if cfg is None or not batch.seqlens:
            return
        # The main token key: seqlens also holds scalar keys.
        lens = [float(v) for v in batch.total_lens()]
        n_tokens = sum(lens)
        if n_tokens <= 0:
            return
        flops = monitor.FlopsCounter()
        flops.add_train(cfg, n_tokens, n_tokens / max(len(lens), 1),
                        remat=bool(getattr(engine, "remat", False)))
        self._mfu.emit(flops.pop() / dur_secs)

    def _emit_terminal_spans(self, ids, model, t_start: float,
                             dur_secs: float) -> None:
        """Close each traced sample's lineage with a terminal
        ``trainer/train_sample`` span naming the weight version that
        trained it. The trace is consumed from the stored sample's
        metadata: when several train MFCs read one sample in a step, the
        first to train it terminates the trace. No-op with telemetry
        disabled or for untraced samples."""
        if not telemetry.enabled():
            return
        version = model.version.global_step
        for sid in ids:
            s = self.store.get(sid)
            if s is None:
                continue
            tr = (s.metadata.pop("_trace", None) or [None])[0]
            if not isinstance(tr, dict):
                continue
            ctx = telemetry.TraceContext.from_dict(tr)
            if ctx is None:
                continue
            telemetry.add_span(
                "trainer/train_sample", t_start, dur_secs, trace=ctx,
                sample_id=str(sid), weight_version=version)

    @torch.no_grad()
    def _run_hook(self, hook: Dict) -> None:
        kind = hook.get("kind")
        if kind == "weight_update":
            self.publish_weights(hook.get("role", "actor"))
        elif kind == "save":
            self._save_role(hook.get("role", "actor"), hook["path"])
        elif kind == "param_realloc":
            # The source moved into the target's layout first (no copy when
            # the layouts match, reference :653-683), then the EMA: target
            # := eta * source + (1 - eta) * target, in f32, cast back to
            # each target tensor's dtype.
            from areal_tpu_torch.parallel import reshard as rsh

            src = self.models[hook["source"]].module.params
            dst = self.models[hook["target"]].module.params
            src, plan = rsh.reshard_pytree(src, rsh.shardings_of(dst))
            if plan.n_moved:
                logger.info(f"param_realloc reshard {hook['source']} -> "
                            f"{hook['target']}: {plan.describe()}")
            eta = float(hook.get("eta", 1.0))
            for name, d in dst.items():
                s, d = _local(src[name]), _local(d)
                s = s.detach().to(d.device, torch.float32)
                d.copy_((eta * s + (1 - eta) * d.float()).to(d.dtype))
        else:
            raise ValueError(f"unknown hook {hook}")

    # ---------------- weights ----------------

    def _save_role(self, role: str, path: str, fmt: str = "hf") -> int:
        """The role's weights under ``path``: an HF checkpoint of the
        masters, or (``fmt="native"``) the weight-sync layout in the
        compute dtype. Returns the bytes written."""
        from areal_tpu_torch.parallel import distributed as dist

        model = self.models[role]
        meta = {"version": model.version.global_step}
        params = dist.allgather_params(
            self._compute_dtype_params(role) if fmt == "native"
            else model.module.params)
        if not self._rank0:
            return 0  # every rank joins the gather; rank 0 writes
        if fmt == "native":
            return hf.save_native_checkpoint(params, model.module.cfg, path,
                                             meta=meta)
        return hf.save_hf_checkpoint(params, model.module.cfg, path,
                                     meta=meta)

    @torch.no_grad()
    def _compute_dtype_params(self, role: str) -> Dict[str, torch.Tensor]:
        """The role's parameters cast (on their device) to the engine's
        compute dtype: weight-sync payloads travel in it, halving the bytes
        of f32 masters in bf16. Every tensor is a copy this call owns: the
        optimizer updates the masters in place, so where the cast returns
        the master itself (an f32 compute dtype, or an inference engine's
        own dtype) it is cloned."""
        engine = self.models[role].module
        cd = engine.compute_dtype
        if getattr(engine, "mesh", None) is not None:
            return engine.full_params(cd)  # cast, then gathered: new tensors
        out = {}
        for name, p in engine.params.items():
            p = p.detach()
            t = p.to(cd) if p.is_floating_point() else p
            out[name] = t.clone() if t.data_ptr() == p.data_ptr() else t
        return out

    def publish_weights(self, role: str) -> None:
        """Make the role's weights visible to the generation servers and
        bump ``names.model_version``, over ``weight_sync.transport``."""
        transport = self.cfg.weight_sync.transport
        if transport == "stream":
            self._publish_weights_stream(role)
            return
        if transport == "device":
            self._publish_weights_device(role)
            return
        if transport != "disk":
            raise ValueError(f"unknown weight_sync.transport {transport!r}")
        version = self.models[role].version.global_step
        path = os.path.join(self.cfg.realloc_dir, role, str(version))
        t0 = time.monotonic()
        with self._publish_span(role, version, "disk"):
            self._save_role(role, path, fmt="native")
        save_secs = time.monotonic() - t0
        self._publish_done(save_secs)
        if not self._rank0:
            return
        # A stream-mode predecessor may have left its endpoint behind.
        self._clear_stale_transport_keys(role, keep="disk")
        self._bump_version(role, version, save_secs)
        logger.info(f"published {role} weights v{version} -> {path} "
                    f"(save {save_secs:.2f}s)")

    def _publish_weights_stream(self, role: str) -> None:
        model = self.models[role]
        version = model.version.global_step
        t0 = time.monotonic()
        with self._publish_span(role, version, "stream"):
            flat = convert.params_to_reference(
                self._compute_dtype_params(role), model.module.cfg)
            if not self._rank0:
                return  # every rank joins the gather; rank 0 publishes
            pub = self._weight_publishers.get(role)
            if pub is None:
                pub = WeightStreamPublisher(
                    self.cfg.experiment, self.cfg.trial, role,
                    chunk_bytes=self.cfg.weight_sync.chunk_mb << 20)
                self._weight_publishers[role] = pub
            # publish() returns once the manifest is registered; the d2h
            # gather runs in the publisher's thread, overlapping the wire
            # leg.
            pub.publish(sorted(flat.items()), version)
        publish_secs = time.monotonic() - t0
        self._publish_done(publish_secs)
        self._clear_stale_transport_keys(role, keep="stream")
        self._bump_version(role, version, publish_secs)
        logger.info(f"published {role} weights v{version} -> {pub.endpoint} "
                    f"(stream publish {publish_secs:.2f}s; the gather "
                    "continues in the background)")

    def _publish_weights_device(self, role: str) -> None:
        """Transport ``device`` (reference ``_publish_weights_device:808``):
        the role's weights in the compute dtype, whole on this device (the
        layout the port's un-meshed servers hold), packed into one device
        buffer whose CUDA IPC handle, manifest and digest go under
        ``names.weight_device``. Off a mesh the masters are cast as they
        are packed; on one, every rank gathers and rank 0 publishes. The
        reference's ``_device_publish_shardings`` (a meshed fleet's layout)
        comes with such a fleet."""
        from areal_tpu_torch.parallel import reshard as rsh

        model = self.models[role]
        engine = model.module
        version = model.version.global_step
        t0 = time.monotonic()
        with self._publish_span(role, version, "device"):
            if getattr(engine, "mesh", None) is not None:
                params = engine.full_params(engine.compute_dtype)
            else:
                params = {n: p.detach() for n, p in engine.params.items()}
            if not self._rank0:
                return
            pub = rsh.publish_device(
                self.cfg.experiment, self.cfg.trial, role, params,
                version=version, dtype=engine.compute_dtype)
        publish_secs = time.monotonic() - t0
        self._publish_done(publish_secs)
        telemetry.observe("trainer/weight_publish_latency_secs",
                          publish_secs)
        self._clear_stale_transport_keys(role, keep="device")
        self._bump_version(role, version, publish_secs)
        logger.info(f"published {role} weights v{version} on device "
                    f"({len(pub.manifest)} leaves, {publish_secs:.3f}s)")

    @contextlib.contextmanager
    def _publish_span(self, role: str, version: int, transport: str):
        """A weight publish: its span, the ledger's comm state and the
        device-memory watermark."""
        with telemetry.span("trainer/weight_publish", role=role,
                            version=version, transport=transport), \
                self._ledger.state("comm"), \
                memwatch.watermark("trainer/weight_publish"):
            yield

    @staticmethod
    def _publish_done(secs: float) -> None:
        telemetry.set_gauge("trainer/weight_publish_secs", secs)
        telemetry.inc("trainer/weight_publishes")

    def _clear_stale_transport_keys(self, role: str, keep: str) -> None:
        """Drop the other transports' discovery keys, so nothing steers a
        server at a transport this trainer does not publish on."""
        stale = {"stream": names.weight_stream}
        if keep != "device":  # the key, and this process's publication
            from areal_tpu_torch.parallel import reshard as rsh

            rsh.clear_publication(self.cfg.experiment, self.cfg.trial, role)
        stale.pop(keep, None)
        for key in stale.values():
            try:
                name_resolve.delete(key(self.cfg.experiment, self.cfg.trial,
                                        role))
            except name_resolve.NameEntryNotFoundError:
                pass

    def _bump_version(self, role: str, version: int,
                      publish_secs: float) -> None:
        # The publish start anchors the end-to-end weight-sync latency
        # (publish start → the servers serve the new version).
        name_resolve.add(
            names.model_version_time(self.cfg.experiment, self.cfg.trial, role),
            repr(time.time() - publish_secs), replace=True)
        name_resolve.add(
            names.model_version(self.cfg.experiment, self.cfg.trial, role),
            str(version), replace=True)

    # ---------------- bookkeeping ----------------

    def _handle_model_info(self) -> Dict[str, Any]:
        """Model geometry and device for the master's FLOPs and MFU."""
        from areal_tpu_torch.models.transformer import (
            activated_param_count,
            param_count,
        )

        cuda = self.device.type == "cuda"
        info: Dict[str, Any] = {
            "n_devices": self.cfg.dist_world,  # one device per rank
            "device_kind": (torch.cuda.get_device_name(self.device) if cuda
                            else str(self.device)),
            "roles": {},
        }
        for role, m in self.models.items():
            cfg = getattr(m.module, "cfg", None)
            if cfg is None:
                continue
            moe = cfg.moe
            info["roles"][role] = {
                "n_layers": cfg.n_layers, "hidden_dim": cfg.hidden_dim,
                "q_dim": cfg.q_dim, "kv_dim": cfg.kv_dim,
                "intermediate_dim": cfg.intermediate_dim,
                "vocab_size": cfg.vocab_size, "is_critic": cfg.is_critic,
                "n_params": param_count(cfg),
                "n_params_activated": activated_param_count(cfg),
                "moe": None if moe is None else {
                    "num_experts": moe.num_experts, "top_k": moe.top_k,
                    "routed_intermediate_dim": moe.routed_intermediate_dim,
                    "shared_intermediate_dim": moe.shared_intermediate_dim,
                },
                # remat runs the forward again in the backward: 4x forward
                # FLOPs instead of 3x
                "remat": bool(getattr(m.module, "remat", False)),
            }
        return info

    def _handle_clear(self, p: Payload) -> Any:
        sids = list(p.data or [])
        for sid in sids:
            self.store.pop(sid, None)
        if self._ingest is not None and sids:
            # Freed ids are settled samples (consumed by every MFC after the
            # step's recover checkpoint, or durably dropped by the master's
            # buffer): the ack point of the at-least-once loop.
            self._send_acks(self._ingest.pop_settled(sids))
        return {"n_stored": len(self.store)}

    # A recover checkpoint: every trainable role's train state (masters,
    # optimizer moments, step count) and version, each interface's state
    # (KL controller, value normalizer) and the dataset cursor
    # (reference megatron.py:711-760, master_worker.py:585).

    def _handle_ckpt(self, p: Payload) -> Any:
        ckpt_dir = p.data["dir"]
        os.makedirs(ckpt_dir, exist_ok=True)
        meta: Dict[str, Any] = {"versions": {}, "epoch": self._epoch,
                                "epoch_pos": self._epoch_pos}
        for role, model in self.models.items():
            if hasattr(model.module, "save_train_state"):
                model.module.save_train_state(os.path.join(ckpt_dir, role))
            meta["versions"][role] = model.version.global_step
        iface_states = {n: iface.state_dict()
                        for n, iface in self.interfaces.items()
                        if hasattr(iface, "state_dict")}
        if not self._rank0:
            return {"ok": True}
        # trainer_state.json also marks the directory complete
        # (recover.ckpt_is_complete): written whole or not at all.
        path = os.path.join(ckpt_dir, "trainer_state.json")
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"meta": meta, "interfaces": iface_states}, f)
        os.replace(tmp, path)
        logger.info(f"checkpointed trainer state -> {ckpt_dir}")
        return {"ok": True}

    def _handle_restore(self, p: Payload) -> Any:
        ckpt_dir = p.data["dir"]
        with open(os.path.join(ckpt_dir, "trainer_state.json")) as f:
            d = json.load(f)
        meta = d["meta"]
        for role, model in self.models.items():
            role_dir = os.path.join(ckpt_dir, role)
            if hasattr(model.module, "load_train_state") \
                    and os.path.isdir(role_dir):
                model.module.load_train_state(role_dir)
            model.version.global_step = int(meta["versions"].get(role, 0))
        for mfc_name, st in d["interfaces"].items():
            iface = self.interfaces.get(mfc_name)
            if iface is not None and hasattr(iface, "load_state_dict"):
                iface.load_state_dict(st)
        self._epoch = int(meta["epoch"])
        self._epoch_pos = int(meta["epoch_pos"])
        if self._dataset is not None:
            # The same seed gives the same permutation: (epoch, pos) resume
            # the dataset where the checkpoint left it.
            rng = np.random.RandomState(self._epoch + 1)
            self._data_iter = list(rng.permutation(len(self._dataset)))
        logger.info(f"restored trainer state from {ckpt_dir}")
        # Republished at the restored version: the fleet's weights are the
        # checkpoint's from here on.
        for role in p.data.get("publish", ()):
            if role in self.models:
                self.publish_weights(role)
        return {"ok": True, "versions": meta["versions"]}

    # ---------------- loop ----------------

    def _dispatch(self, p: Payload) -> None:
        """Execute one request; a failure travels back to the master."""
        try:
            if p.handle_name == "fetch":
                p.output = self._handle_fetch(p)
            elif p.handle_name == "mfc":
                p.output = self._handle_mfc(p)
            elif p.handle_name == "clear":
                p.output = self._handle_clear(p)
            elif p.handle_name == "version":
                p.output = {r: m.version.global_step
                            for r, m in self.models.items()}
            elif p.handle_name == "model_info":
                p.output = self._handle_model_info()
            elif p.handle_name == "ckpt":
                p.output = self._handle_ckpt(p)
            elif p.handle_name == "restore":
                p.output = self._handle_restore(p)
            elif p.handle_name == "exit":
                p.output = "bye"
                self._exiting = True
                # Hand the last step's spans to the aggregator before the
                # reply: the master closes the aggregator once it has it.
                pusher = telemetry.get().pusher
                if pusher is not None:
                    pusher.flush()
            else:
                raise ValueError(f"unknown handle {p.handle_name}")
        except Exception as e:  # noqa: BLE001 — surfaced to the master
            p.exception = f"{e}\n{traceback.format_exc()}"
            logger.error(f"handler {p.handle_name} failed: {p.exception}")

    def serve_once(self, timeout_ms: int = 100) -> bool:
        p = self._server.poll(timeout_ms)
        if p is None:
            return False
        if p.handle_name != "fetch":
            # _handle_fetch broadcasts its own batch after rank 0's read;
            # every other request is replayed as it came
            self._bcast(("cmd", p.handle_name, p.data, p.mb_spec,
                         p.pre_hooks, p.post_hooks))
            self._followers_told_exit |= p.handle_name == "exit"
        self._dispatch(p)
        self._server.reply(p)
        return True

    def _follow_once(self) -> None:
        """A rank > 0: receive one broadcast request and replay it
        (reference ``_follow_once:1070``)."""
        msg = self._bcast(None)
        if msg[0] == "fetch":
            self._store_batch(msg[1])
            return
        _, handle_name, data, mb_spec, pre, post = msg
        p = Payload(handler=self.cfg.handler, handle_name=handle_name,
                    data=data, mb_spec=mb_spec, pre_hooks=pre,
                    post_hooks=post)
        self._dispatch(p)
        if p.exception:
            # A failure that fails alike on every rank keeps the group in
            # step (rank 0 logs it and serves on). A rank-local failure of
            # a handler that mutates state leaves this rank's weights or
            # store apart from the group's: fail loudly instead.
            if handle_name in ("mfc", "restore", "clear"):
                raise RuntimeError(
                    f"rank {self.cfg.dist_rank} replay of state-mutating "
                    f"{handle_name} failed; exiting so that the group does "
                    f"not diverge: {p.exception}")
            logger.error(f"rank {self.cfg.dist_rank} replay of "
                         f"{handle_name} failed (read-only; staying in "
                         f"step): {p.exception}")

    def run(self) -> None:
        self.setup()
        if not self._rank0:
            try:
                while not self._exiting:
                    self._follow_once()
            finally:
                self.close()
            return
        # The heartbeat publishes names.compile_inflight while a kernel
        # library builds (the null watch reports none).
        ctrl = WorkerControl(self.cfg.experiment, self.cfg.trial,
                             self.cfg.handler,
                             inflight_fn=compile_watch.inflight)
        # Under a supervisor the control heartbeat also keeps the request
        # stream's and the trajectory puller's advertisements leased.
        ctrl.lease(self._server._key, self._server._addr)
        if self._puller is not None:
            ctrl.lease(self._puller._key, self._puller._addr)
        try:
            while not self._exiting:
                ctrl.step(lambda: {"roles": sorted(self.models)})
                if ctrl.should_exit:
                    break
                if self._profiler is not None:
                    self._profiler.poll()
                self.serve_once(timeout_ms=100)
                # Accrue the in-progress state (idle between requests)
                # so the scrape moves even when no handler runs.
                self._ledger.poll()
                # rate-limited inside the watch; the null watch is a no-op
                memwatch.sample()
                telemetry.set_gauge("trainer/store_size", len(self.store))
        finally:
            if self.cfg.dist_world > 1 and not self._followers_told_exit:
                # rank 0 left without the master's exit (a control-plane
                # stop): release the ranks waiting on its next broadcast
                self._bcast(("cmd", "exit", None, None, [], []))
            ctrl.close()
            self.close()

    def close(self) -> None:
        """Withdraw the request stream and the trajectory puller and stop
        every weight-stream publisher (their keys are deleted)."""
        self._exiting = True
        if self._server is not None:
            self._server.close()
            self._server = None
        if self._pull_thread is not None:
            # the loop sees _exiting within one 200 ms poll
            self._pull_thread.join(timeout=2.0)
            self._pull_thread = None
        if self._puller is not None:
            self._puller.close()
            self._puller = None
        with self._ack_lock:
            for pusher in self._ack_pushers.values():
                pusher.close()
            self._ack_pushers.clear()
        for pub in self._weight_publishers.values():
            pub.close()
        self._weight_publishers.clear()
        if self.cfg.weight_sync.transport == "device" and self._rank0:
            from areal_tpu_torch.parallel import reshard as rsh

            for role in self.models:
                rsh.clear_publication(self.cfg.experiment, self.cfg.trial,
                                      role)
        if self._profiler is not None:  # this worker armed observability
            self._profiler = None
            self._ledger.flush()
            memwatch.shutdown()
            compile_watch.shutdown()
            telemetry.shutdown()  # the final flush to the aggregator
