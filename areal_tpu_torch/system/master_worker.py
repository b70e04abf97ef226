"""The master worker: owns the training loop and walks the dataflow graph.

The port's counterpart of ``areal_tpu/system/master_worker.py:108-547``
(reference ``realhf/system/master_worker.py:49`` + ``function_executor.py:24``
+ ``model_function_call.py:54``). Per training step it runs one asyncio
task per MFC plus a data-loading task; each MFC task waits on the metadata
buffer until its input keys are ready for ``n_seqs`` samples, sends the call
to the trainer over the request stream and amends the buffer with the
outputs. Save and recover-checkpoint cadence come from ``FrequencyControl``;
epochs from the trainer's fetch replies; per-step ``timeperf/*`` seconds,
analytic TFLOP/s and MFU against the card's peak (``base/monitor.py``).

With ``telemetry.enabled`` the master hosts the fleet's
:class:`~areal_tpu_torch.base.telemetry.TelemetryAggregator` (up before
anything else looks for it), with the sentinel (``sentinel.enabled``) and
fleet goodput (``goodput.enabled``) inside it; the step loop records the
``master/mfc_gate``, ``master/mfc_exec`` and ``master/step`` spans and the
``master/step_secs`` gauge, which it also feeds to the sentinel directly.
With telemetry off none of it is constructed.

The durable spool (``durability``) reaches the master only through the
order of a step's end: the recover checkpoint is written before ``clear``
names the freed samples, and ``clear`` is where the trainer acks them, so
no ack runs ahead of a checkpoint taken every step; with the sentinel on,
durability also arms its ``sample_loss`` rule on ``spool/acked``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import shutil
import tempfile
import time
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.api.dfg import (
    DataFlowGraph,
    MFCDef,
    MFCInterfaceType,
    ParamReallocHook,
    WeightUpdateHook,
)
from areal_tpu_torch.api.train_config import (
    CompileWatchConfig,
    DurabilityConfig,
    ExperimentSaveEvalControl,
    GoodputConfig,
    SentinelConfig,
    TelemetryConfig,
)
from areal_tpu_torch.base import (
    logging,
    monitor,
    name_resolve,
    names,
    recover,
    telemetry,
)
from areal_tpu_torch.base.stats_tracker import StatsTracker
from areal_tpu_torch.base.timeutil import FrequencyControl
from areal_tpu_torch.system.buffer import AsyncSequenceBuffer
from areal_tpu_torch.system.streams import MasterRequestStream, Payload
from areal_tpu_torch.system.worker_base import WorkerControl

logger = logging.getLogger("system.master")


@dataclasses.dataclass
class MasterWorkerConfig:
    experiment: str = "exp"
    trial: str = "trial"
    trainer_handler: str = "trainer"
    train_batch_size: int = 8
    exp_ctrl: ExperimentSaveEvalControl = dataclasses.field(
        default_factory=ExperimentSaveEvalControl)
    save_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "areal_tpu", "ckpt"))
    tensorboard_path: Optional[str] = None
    wandb_mode: str = "disabled"
    # recover checkpoints (RecoverInfo + the trainer's train state) live here
    recover_dir: str = ""
    # resume from the latest recover checkpoint at startup
    recover: bool = False
    keep_recover_ckpts: int = 2
    telemetry: TelemetryConfig = dataclasses.field(
        default_factory=TelemetryConfig)
    sentinel: SentinelConfig = dataclasses.field(
        default_factory=SentinelConfig)
    goodput: GoodputConfig = dataclasses.field(default_factory=GoodputConfig)
    # arms the sentinel's compile/memory rules
    compile_watch: CompileWatchConfig = dataclasses.field(
        default_factory=CompileWatchConfig)
    # arms the sentinel's sample_loss rule (the spool's acks)
    durability: DurabilityConfig = dataclasses.field(
        default_factory=DurabilityConfig)


class MasterWorker:
    def __init__(self, cfg: MasterWorkerConfig, dfg: DataFlowGraph):
        self.cfg = cfg
        self.dfg = dfg
        # Every node reads its inputs from the buffer once.
        self.buffer = AsyncSequenceBuffer(n_rpcs_reading=len(dfg.nodes))
        self.stream: Optional[MasterRequestStream] = None
        self.step = 0
        self.epoch = 0
        self._train_nodes = [
            n for n in dfg.nodes.values()
            if n.interface_type == MFCInterfaceType.TRAIN_STEP
        ]
        self.stats = StatsTracker()
        self._save_ctl = FrequencyControl(
            freq_step=cfg.exp_ctrl.save_freq_steps)
        self._ckpt_ctl = FrequencyControl(
            freq_step=cfg.exp_ctrl.ckpt_freq_steps,
            freq_sec=cfg.exp_ctrl.ckpt_freq_secs)
        self._stats_history: List[Dict[str, float]] = []

    # ---------------- setup ----------------

    def setup(self) -> None:
        # Lifecycle endpoint: a launcher or an operator can pause, resume,
        # exit or query this worker between training steps, and ask for a
        # recover checkpoint out of cadence ("checkpoint", served between
        # steps, so no MFC is in flight when it runs).
        self.ctrl = WorkerControl(self.cfg.experiment, self.cfg.trial,
                                  "master")
        self.ctrl.on_command("checkpoint", self._on_demand_ckpt)
        # The aggregator must exist before any worker's pusher looks for
        # it, and before the master's own telemetry is configured.
        self._aggregator: Optional[telemetry.TelemetryAggregator] = None
        self._sentinel = None
        if self.cfg.telemetry.enabled:
            self._setup_aggregator()
        self.stream = MasterRequestStream(
            self.cfg.experiment, self.cfg.trial, [self.cfg.trainer_handler])
        self._model_info = self.stream.call(
            self.cfg.trainer_handler, "model_info", None)
        self._peak_flops = monitor.device_peak_flops(
            self._model_info.get("device_kind", ""))
        self._flops = monitor.FlopsCounter()
        self._writer = monitor.MetricWriter(
            tensorboard_path=self.cfg.tensorboard_path,
            wandb_mode=self.cfg.wandb_mode)
        if self._aggregator is not None:
            # per-worker telemetry scalars into the same tensorboard stream
            self._aggregator.set_metric_writer(self._writer)
        if self.cfg.recover and self.cfg.recover_dir:
            self._try_recover()

    def _setup_aggregator(self) -> None:
        cfg = self.cfg
        # telemetry.jsonl defaults next to the tensorboard stream.
        jsonl = cfg.telemetry.jsonl_path or os.path.join(
            os.path.dirname(cfg.tensorboard_path) if cfg.tensorboard_path
            else cfg.save_dir, "telemetry.jsonl")
        log_dir = os.path.dirname(jsonl) or "."
        if cfg.sentinel.enabled:
            from areal_tpu_torch.system.sentinel import (
                Sentinel,
                rules_from_config,
            )

            self._sentinel = Sentinel(
                cfg.sentinel, cfg.experiment, cfg.trial,
                # each pack only with the series it reads: on a run without
                # the spool an absence rule on its acks would false-fire
                rules=rules_from_config(
                    cfg.sentinel,
                    durability_enabled=cfg.durability.enabled,
                    compile_watch_enabled=cfg.compile_watch.enabled),
                alerts_path=(cfg.sentinel.alerts_path
                             or os.path.join(log_dir, "alerts.jsonl")),
                evidence_dir=(cfg.sentinel.evidence_dir
                              or os.path.join(log_dir, "evidence")))
        fleet_goodput = None
        if cfg.goodput.enabled:
            from areal_tpu_torch.system.goodput import FleetGoodput

            fleet_goodput = FleetGoodput()
        self._aggregator = telemetry.TelemetryAggregator(
            cfg.experiment, cfg.trial, jsonl_path=jsonl,
            http_port=cfg.telemetry.http_port,
            traces_path=cfg.telemetry.traces_path,
            stitch_grace_secs=cfg.telemetry.stitch_grace_secs,
            sentinel=self._sentinel, goodput=fleet_goodput)
        telemetry.configure(cfg.experiment, cfg.trial, "master", 0,
                            cfg.telemetry)

    def _try_recover(self) -> None:
        """Resume from the latest recover checkpoint (reference
        master_worker.py:585 dump / recover.discover_ckpt)."""
        info = recover.load(self.cfg.recover_dir)
        ckpt = recover.discover_ckpt(self.cfg.recover_dir)
        if info is None or ckpt is None:
            logger.info("recover requested but no checkpoint found; "
                        "starting fresh")
            return
        self.step = info.last_step_info.global_step
        self.epoch = info.last_step_info.epoch
        if info.save_ctl_states.get("save"):
            self._save_ctl.load_state_dict(info.save_ctl_states["save"])
        if info.ckpt_ctl_states.get("ckpt"):
            self._ckpt_ctl.load_state_dict(info.ckpt_ctl_states["ckpt"])
        # The roles the graph publishes are published again from the
        # restored weights, so that a relaunched generation fleet serves
        # the checkpoint's policy, not its initial weights, until the first
        # step after the resume.
        published = sorted({h.role for n in self.dfg.nodes.values()
                            for h in n.post_hooks
                            if isinstance(h, WeightUpdateHook)})
        reply = self.stream.call(self.cfg.trainer_handler, "restore",
                                 {"dir": ckpt, "publish": published})
        logger.info(f"recovered at step {self.step} epoch {self.epoch} from "
                    f"{ckpt} (model versions: {reply.get('versions')})")

    def _on_demand_ckpt(self, payload=None) -> Dict[str, Any]:
        if not self.cfg.recover_dir:
            return {"saved": False, "reason": "no recover_dir configured"}
        ckpt_dir = self._do_ckpt()
        return {"saved": True, "dir": ckpt_dir, "step": self.step,
                "epoch": self.epoch}

    def _do_ckpt(self) -> Optional[str]:
        if not self.cfg.recover_dir:
            return None
        name = recover.ckpt_dirname(self.epoch, self.step, self.step)
        ckpt_dir = f"{self.cfg.recover_dir}/{name}"
        self.stream.call(self.cfg.trainer_handler, "ckpt", {"dir": ckpt_dir})
        # The completeness marker goes in after the trainer acknowledged the
        # save: a crash mid-save leaves a directory discover_ckpt skips.
        recover.mark_ckpt_complete(ckpt_dir)
        si = recover.StepInfo(self.epoch, self.step, self.step)
        recover.dump(self.cfg.recover_dir, recover.RecoverInfo(
            recover_start=si, last_step_info=si,
            save_ctl_states={"save": self._save_ctl.state_dict()},
            ckpt_ctl_states={"ckpt": self._ckpt_ctl.state_dict()}))
        # Keep the newest keep_recover_ckpts (params + optimizer state each).
        entries = []
        for n in os.listdir(self.cfg.recover_dir):
            st = recover.parse_ckpt_dirname(n)
            if st is not None:
                entries.append((st.global_step, n))
        for _, n in sorted(entries)[: -self.cfg.keep_recover_ckpts]:
            shutil.rmtree(f"{self.cfg.recover_dir}/{n}", ignore_errors=True)
        return ckpt_dir

    def _count_mfc_flops(self, node: MFCDef,
                         metas: List[SequenceSample]) -> None:
        """Analytic FLOPs of one MFC from its input metadata (lengths)."""
        info = self._model_info.get("roles", {}).get(node.model_name)
        if info is None or not metas:
            return
        # The main token key (SequenceSample.total_lens): seqlens also holds
        # scalar keys (rewards: [[1]] per sample), and a sample's seqlens
        # come in the order of its key set, which varies by process. The
        # reference takes the first key (master_worker.py:311) and so
        # undercounts by the sequence length whenever a scalar key leads.
        lens = [int(m.total_lens()[0]) for m in metas]
        n_tokens = float(sum(lens))
        avg = n_tokens / max(len(lens), 1)
        moe = info.get("moe")
        cfg = SimpleNamespace(
            **{k: info[k] for k in ("n_layers", "hidden_dim", "q_dim",
                                    "kv_dim", "intermediate_dim",
                                    "vocab_size", "is_critic")},
            moe=None if moe is None else SimpleNamespace(**moe))
        if node.interface_type == MFCInterfaceType.TRAIN_STEP:
            self._flops.add_train(cfg, n_tokens, avg,
                                  remat=info.get("remat", False))
        else:
            self._flops.add_inf(cfg, n_tokens, avg)

    # ---------------- per-step DFG traversal ----------------

    async def _load_data(self) -> None:
        """Fill one step's batch from the trainer's dataset or stream. A
        fetch may return fewer samples than asked (or none; in stream mode,
        whatever the rollout workers pushed): keep fetching until
        ``train_batch_size`` samples are in the buffer."""
        got = 0
        while got < self.cfg.train_batch_size:
            reply = await asyncio.to_thread(
                self.stream.call, self.cfg.trainer_handler, "fetch",
                self.cfg.train_batch_size - got)
            self.epoch = reply["epoch"]
            self._dataset_size = reply["dataset_size"]
            meta: Optional[SequenceSample] = reply["meta"]
            if meta is None or meta.bs == 0:
                await asyncio.sleep(0.2)
                continue
            await self.buffer.put_batch([meta.select_idx([i])
                                         for i in range(meta.bs)])
            got += meta.bs

    def _hook_dicts(self, node: MFCDef, post: bool) -> List[Dict]:
        out = []
        for h in node.post_hooks if post else node.pre_hooks:
            if isinstance(h, WeightUpdateHook):
                out.append({"kind": "weight_update", "role": h.role})
            elif isinstance(h, ParamReallocHook):
                out.append({"kind": "param_realloc", "source": h.source,
                            "target": h.target, "eta": h.eta})
        return out

    async def _run_mfc(self, node: MFCDef) -> None:
        with telemetry.span("master/mfc_gate", mfc=node.name):
            metas = await self.buffer.get_batch_for_rpc(
                node.name, set(node.input_keys), node.n_seqs)
        t_mfc = time.monotonic()
        self._count_mfc_flops(node, metas)
        ids = [m.ids[0] for m in metas]
        payload = Payload(
            handler=self.cfg.trainer_handler,
            handle_name="mfc",
            data={
                "mfc": node.name,
                "ids": ids,
                "method": node.interface_type.value,
                "input_keys": list(node.input_keys),
                "input_remap": node.input_key_remap,
                "output_remap": node.output_key_remap,
            },
            mb_spec=node.mb_spec,
            pre_hooks=self._hook_dicts(node, post=False),
            post_hooks=self._hook_dicts(node, post=True),
        )
        rid = self.stream.post(payload)
        with telemetry.span("master/mfc_exec", mfc=node.name,
                            n_seqs=len(ids)):
            reply = (await asyncio.to_thread(self.stream.gather, [rid]))[0]
        out = reply.output
        if node.interface_type == MFCInterfaceType.TRAIN_STEP:
            if out["stats"]:
                self.stats.scalar(**{f"{node.name}/{k}": v
                                     for k, v in out["stats"].items()})
        elif node.interface_type == MFCInterfaceType.GENERATE:
            # Trajectories replace the prompt slots (flattened groups).
            new_meta: SequenceSample = out["meta"]
            await self.buffer.drop_ids(ids)
            singles = [new_meta.select_idx([i]) for i in range(new_meta.bs)]
            await self.buffer.put_batch(singles)
            await self.buffer.mark_read([s.ids[0] for s in singles],
                                        node.name)
        elif out["meta"] is not None:
            await self.buffer.amend_batch(out["meta"])
        self.stats.scalar(**{f"timeperf/{node.name}":
                             time.monotonic() - t_mfc})

    async def _execute_step(self) -> None:
        tasks = [self._load_data()]
        tasks += [self._run_mfc(n) for n in self.dfg.nodes.values()]
        await asyncio.gather(*tasks)

    # ---------------- main loop ----------------

    def should_stop(self) -> bool:
        ctrl = self.cfg.exp_ctrl
        if (ctrl.benchmark_steps is not None
                and self.step >= ctrl.benchmark_steps):
            return True
        return self.epoch >= ctrl.total_train_epochs

    def run(self) -> Dict[str, Any]:
        # One event loop for the whole experiment: the buffer's asyncio
        # primitives bind to the loop that first touches them.
        return asyncio.run(self._run_async())

    async def _run_async(self) -> Dict[str, Any]:
        self.setup()
        t_start = time.monotonic()
        while not self.should_stop():
            # Serve the control channel between steps; pause blocks here.
            await asyncio.to_thread(
                self.ctrl.step,
                lambda: {"step": self.step, "epoch": self.epoch})
            if self.ctrl.should_exit:
                logger.info("master: exit requested via control channel")
                break
            t0 = time.monotonic()
            with telemetry.span("master/step", step=self.step):
                await self._execute_step()
            self.step += 1
            step_stats = self.stats.export(reset=True)
            dt = time.monotonic() - t0
            step_stats["timeperf/e2e"] = dt
            # Analytic TFLOP/s per card and MFU (reference
            # master_worker.py:497).
            n_cards = max(self._model_info.get("n_devices", 1), 1)
            flops = self._flops.pop()
            if flops > 0:
                per_card = flops / dt / n_cards
                step_stats["timeperf/tflops_per_chip"] = per_card / 1e12
                if self._peak_flops:
                    step_stats["timeperf/mfu"] = per_card / self._peak_flops
            self._stats_history.append(step_stats)
            self._writer.write(step_stats, self.step)
            # Step wall time on the scrape, and a direct sentinel feed
            # (no flush latency) under the identity the flushed copy
            # arrives with. Feed only: rules are evaluated on the
            # aggregator's thread.
            telemetry.set_gauge("master/step_secs", dt)
            if self._sentinel is not None:
                self._sentinel.feed("master:0", {
                    "master/step_secs": dt, "master/step": float(self.step)})
            logger.info(
                f"step {self.step} epoch {self.epoch} ({dt:.2f}s): "
                + " ".join(f"{k}={v:.4g}" for k, v in sorted(step_stats.items())
                           if "/" in k))
            if self._save_ctl.check(epochs=self.epoch, steps=self.step):
                await asyncio.to_thread(self._request_save)
            if self._ckpt_ctl.check(epochs=self.epoch, steps=self.step):
                await asyncio.to_thread(self._do_ckpt)
            # Tell the trainer which samples every MFC consumed, so that its
            # store can drop them.
            freed = await self.buffer.pop_freed()
            await asyncio.to_thread(self.stream.call,
                                    self.cfg.trainer_handler, "clear", freed)
        total = time.monotonic() - t_start
        logger.info(f"experiment complete: {self.step} steps in {total:.1f}s")
        # Published before the trainer is told to exit: a supervisor that
        # sees the trainer go reads this marker and does not count it as a
        # death.
        name_resolve.add(
            names.experiment_status(self.cfg.experiment, self.cfg.trial),
            json.dumps({"status": "finishing", "ts": time.time()}),
            replace=True, delete_on_exit=False)
        await asyncio.to_thread(self.stream.call, self.cfg.trainer_handler,
                                "exit")
        self.stream.close()
        if self._aggregator is not None:
            telemetry.shutdown()  # the master's final flush into it
            self._aggregator.close()
        self._writer.close()
        self.ctrl.close()
        return {"steps": self.step, "stats": self._stats_history}

    def _request_save(self) -> None:
        rids = [
            self.stream.post(Payload(
                handler=self.cfg.trainer_handler, handle_name="mfc",
                data={"mfc": node.name, "ids": [], "method": "noop"},
                post_hooks=[{
                    "kind": "save", "role": node.model_name,
                    "path": f"{self.cfg.save_dir}/{node.model_name}/"
                            f"step{self.step}",
                }],
            ))
            for node in self._train_nodes
        ]
        self.stream.gather(rids)
