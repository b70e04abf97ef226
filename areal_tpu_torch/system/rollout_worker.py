"""Rollout worker: the asyncio loop that runs agents against the generation
fleet.

The port of ``areal_tpu/system/rollout_worker.py`` (reference
``realhf/system/rollout_worker.py:43``). It owns a shard of the dataset;
for each prompt it asks the manager for quota (``/allocate_rollout``, the
staleness gate, in sample units), runs ``agent.collect_trajectory`` with
its queues bridged to the chunked generation client, grades through the
agent's environment (in this process, or on the reward fleet when
``reward_service.enabled``: then no code grade runs here), pushes the
accepted trajectories to
the trainer's stream and reports ``/finish_rollout`` on every path. A push
that finds the trainer gone does not end the worker (in the reference the
zmq socket drops it): the rollout reports what went out as accepted and
its prompt stays unconsumed.

The allocation is atomic under cancellation: a task cancelled after the
manager booked its quota sends the compensating ``/finish_rollout``. Every
quota call names the worker and its incarnation, so that a respawned
worker's first allocation returns the quota a killed predecessor held.
Consumed prompt ids go to an fsynced log (:class:`ConsumedLog`) that a
restarted worker skips.

With telemetry on, each admitted prompt originates a trace (the
``rollout/rollout`` span, with ``rollout/gate`` for the time the gate held
it) carried through the quota calls, every ``/generate`` chunk and the
push to the trainer; the worker exports the denial and backpressure
counters, the allocation latency and staleness histograms and its
progress gauges, and a goodput ledger in accrual mode (concurrent
rollouts export task-seconds, not a wall partition).

With ``durability.enabled`` (``system/sample_spool.py``) each accepted
trajectory is fsynced into the worker's spool under
``{recover_dir}/spool_{index}`` (off the event loop) before its prompt is
marked consumed, and the spool's sender thread owns the pushes: it reads
the trainer's acks on the worker's own channel and replays at startup what
a dead incarnation left unacked. A durable worker without a
``recover_dir`` refuses to start.

This process never initialises CUDA: generation runs on the servers.
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import time
from typing import Any, Dict, Optional

import numpy as np

import areal_tpu_torch.agents  # noqa: F401 — registers the agents and envs
from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.api.model import (
    GenerationHyperparameters,
    make_agent,
    make_env,
)
from areal_tpu_torch.api.train_config import (
    DurabilityConfig,
    GoodputConfig,
    RewardServiceConfig,
    TelemetryConfig,
)
from areal_tpu_torch.base import logging, name_resolve, names, telemetry
from areal_tpu_torch.base.retry import (
    DEFAULT_GENERATION_RETRY,
    FaultInjector,
    RetryPolicy,
)
from areal_tpu_torch.datasets.jsonl import (
    RL_TASKS,
    load_jsonl,
    load_shuffle_split,
)
from areal_tpu_torch.rewards import client as reward_client
from areal_tpu_torch.system import goodput as goodput_mod
from areal_tpu_torch.system.http import AsyncHttp
from areal_tpu_torch.system.partial_rollout import (
    GenerationAbandonedError,
    PartialRolloutClient,
    trajectory_from_gen,
)
from areal_tpu_torch.system.sample_spool import (
    SampleSpool,
    SpoolSender,
    ack_channel_name,
)
from areal_tpu_torch.system.streams import TrajectoryPuller, TrajectoryPusher

logger = logging.getLogger("system.rollout")

# How long an exiting worker waits for the grades its cancelled rollouts
# left on the reward fleet (well inside the supervisor's exit window).
GRADE_SETTLE_SECS = 10.0


@dataclasses.dataclass
class RolloutWorkerConfig:
    experiment: str = "exp"
    trial: str = "trial"
    worker_index: int = 0
    n_workers: int = 1
    dataset_path: str = ""
    trainer_handler: str = "trainer"  # puller name to push to
    agent: str = "math_single_step"
    agent_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # The reward environment: math and code by task kind by default.
    env: str = "math_code_single_step"
    env_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    gconfig: GenerationHyperparameters = dataclasses.field(
        default_factory=GenerationHyperparameters)
    group_size: int = 1
    chunk_tokens: int = 128
    max_concurrent: int = 8
    eos_token_id: int = 1
    seed: int = 1
    tokenizer: Any = None
    max_rollouts: Optional[int] = None  # stop after N (tests); None: forever
    # Consumed prompt ids go to {recover_dir}/rollout_consumed_{index}.log;
    # a restarted worker skips them.
    recover_dir: str = ""
    # Chunk failover: after max_attempts consecutive failures a rollout is
    # abandoned (a clean /finish_rollout; the worker stays up).
    retry: RetryPolicy = dataclasses.field(
        default_factory=lambda: DEFAULT_GENERATION_RETRY)
    telemetry: TelemetryConfig = dataclasses.field(
        default_factory=TelemetryConfig)
    goodput: GoodputConfig = dataclasses.field(default_factory=GoodputConfig)
    # The sandbox reward fleet: enabled, the agents' reward callbacks grade
    # over HTTP on the reward workers instead of in this process.
    reward_service: RewardServiceConfig = dataclasses.field(
        default_factory=RewardServiceConfig)
    # The durable spool: off, trajectories are pushed directly.
    durability: DurabilityConfig = dataclasses.field(
        default_factory=DurabilityConfig)


class ConsumedLog:
    """Append-only consumed-uid log, one file per rollout worker. Every
    append is flushed and fsynced before ``add`` returns; a torn last line
    (a crash mid-append) is dropped and truncated away."""

    def __init__(self, recover_dir: str, worker_index: int):
        self.path = (
            os.path.join(recover_dir, f"rollout_consumed_{worker_index}.log")
            if recover_dir else None)
        self.seen = set()
        self._fh = None
        if self.path and os.path.exists(self.path):
            with open(self.path, "rb") as f:
                raw = f.read()
            data = raw.decode(errors="replace")
            lines = data.split("\n")
            if data and not data.endswith("\n"):
                torn = lines.pop()
                logger.warning(f"consumed log {self.path}: dropping torn tail "
                               f"{torn[:64]!r}; the prompt will be re-trained")
                with open(self.path, "rb+") as f:
                    f.truncate(raw.rfind(b"\n") + 1)
            self.seen = {ln.strip() for ln in lines if ln.strip()}

    def __contains__(self, uid: str) -> bool:
        return uid in self.seen

    def add(self, uid: str) -> None:
        if uid in self.seen:
            return
        self.seen.add(uid)
        if self.path:
            if self._fh is None:
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                self._fh = open(self.path, "a")
            self._fh.write(uid + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class RolloutWorker:
    def __init__(self, cfg: RolloutWorkerConfig,
                 fault_injector: Optional[FaultInjector] = None):
        self.cfg = cfg
        self.faults = fault_injector
        self.records = load_shuffle_split(load_jsonl(cfg.dataset_path),
                                          cfg.seed, cfg.worker_index,
                                          cfg.n_workers)
        self.id2info = {str(d["query_id"]): d for d in self.records}
        self.agent = make_agent(cfg.agent, tokenizer=cfg.tokenizer,
                                **cfg.agent_args)
        self.env = make_env(cfg.env, self.id2info, **cfg.env_args)
        # This process's grading mode (rewards/client.py).
        reward_client.configure_service(cfg.reward_service, cfg.experiment,
                                        cfg.trial)
        self.consumed = ConsumedLog(cfg.recover_dir, cfg.worker_index)
        self.client: Optional[PartialRolloutClient] = None
        self._mgr_url0 = ""
        self._done = 0
        self._pushed = 0
        self._abandoned = 0
        # allocation denials by reason
        self.denials: Dict[str, int] = {}
        # Named in every quota call: a respawned incarnation's first
        # allocation returns what this one still holds if it is killed.
        from areal_tpu_torch.system.worker_base import env_incarnation

        self._who = {"worker": f"rollout{cfg.worker_index}",
                     "incarnation": env_incarnation()}
        self._ledger = goodput_mod.NULL_LEDGER  # armed by run_async
        self._sender: Optional[SpoolSender] = None  # armed by run_async

    def _prompt_sample(self, rec, uid: str) -> SequenceSample:
        ids = self.cfg.tokenizer.encode(rec["prompt"])
        return SequenceSample.from_default(
            ids=[uid],
            data={"packed_prompts": np.asarray(ids, np.int32)},
            seqlens=[len(ids)],
            metadata={"task": [rec.get("task", "math")]})

    @staticmethod
    async def _post_json(session: AsyncHttp, url: str, payload: Dict,
                         timeout_secs: float = 15.0) -> Dict:
        # Bounded: quota calls run inside cancellation shields, and a hung
        # manager must not pin the worker's shutdown. The sample's trace
        # rides the quota calls ({} when off: the request is unchanged).
        status, d = await session.post(url, payload, timeout=timeout_secs,
                                       headers=telemetry.inject_headers())
        if status != 200:
            raise RuntimeError(f"{url}: status {status} {d}")
        return d

    @property
    def _mgr_url(self) -> str:
        """The manager's endpoint, owned by the client once it exists."""
        return (self.client.manager_url if self.client is not None
                else self._mgr_url0)

    async def _rollout_one(self, rec, uid, client, pusher, session):
        cfg = self.cfg
        # The allocation must be atomic under cancellation: shield the
        # call, and if this task is cancelled after quota was booked, let
        # the call finish and return the booking.
        t_alloc = time.monotonic()
        alloc_fut = asyncio.ensure_future(self._post_json(
            session, f"{self._mgr_url}/allocate_rollout",
            {"n_samples": cfg.group_size, **self._who}))
        try:
            alloc = await asyncio.shield(alloc_fut)
        except asyncio.CancelledError:
            try:
                alloc = await alloc_fut
            except Exception:  # noqa: BLE001 — the call failed: no booking
                alloc = None
            if alloc is not None and alloc.get("allowed"):
                try:
                    await self._post_json(
                        session, f"{self._mgr_url}/finish_rollout",
                        {"accepted": False, "n_samples": cfg.group_size,
                         "n_accepted": 0, **self._who})
                except Exception as e2:  # noqa: BLE001 — manager hung/dead
                    logger.warning(f"compensating finish_rollout failed "
                                   f"({e2}); {cfg.group_size} samples of "
                                   "quota may leak until the manager "
                                   "restarts")
            raise
        except Exception as e:  # noqa: BLE001 — a manager blip: no booking
            logger.warning(f"allocate_rollout failed ({e}); retrying")
            if self.client is not None:
                self.client._refresh_manager_url()
            await asyncio.sleep(1.0)
            return "retry"
        if not alloc.get("allowed"):
            reason = alloc.get("reason", "unknown")
            self.denials[reason] = self.denials.get(reason, 0) + 1
            telemetry.inc("rollout/alloc_denied")
            telemetry.inc(f"rollout/alloc_denied_{reason}")
            # With a Retry-After hint (overload backpressure) slow down to
            # its cadence instead of re-polling every 0.5 s.
            retry_secs = 0.5
            if alloc.get("retry_after") is not None:
                try:
                    retry_secs = max(float(alloc["retry_after"]), 0.05)
                except (TypeError, ValueError):
                    pass
                else:
                    telemetry.inc("rollout/backpressure_throttled")
            await asyncio.sleep(retry_secs)
            return "retry"
        telemetry.observe("rollout/alloc_rpc_secs",
                          time.monotonic() - t_alloc)
        accepted = 0
        abandoned = undelivered = False
        task = None
        try:
            prompt = self._prompt_sample(rec, uid)
            obs_q: asyncio.Queue = asyncio.Queue()
            act_q: asyncio.Queue = asyncio.Queue()
            task = asyncio.create_task(
                self.agent.collect_trajectory(prompt, self.env, obs_q, act_q))
            rec_task = rec.get("task", "math")
            # Serve the agent's obs -> act exchanges until it returns (one
            # round for single-step agents).
            turn = 0
            while True:
                get_obs = asyncio.create_task(obs_q.get())
                done, _ = await asyncio.wait(
                    {task, get_obs}, return_when=asyncio.FIRST_COMPLETED)
                if get_obs not in done:
                    get_obs.cancel()
                    break
                qid, prompt_ids, gconfig = get_obs.result()
                gconfig = gconfig or cfg.gconfig
                t_gen = time.monotonic()
                results = await client.generate_group(
                    list(map(int, prompt_ids)), gconfig,
                    gconfig.n if gconfig is not cfg.gconfig
                    else cfg.group_size,
                    eos_token_id=cfg.eos_token_id)
                # generation-wait: blocked on the fleet
                self._ledger.add("comm", time.monotonic() - t_gen)
                trajs = [
                    trajectory_from_gen(
                        f"{qid}@t{turn}" if turn else qid, j,
                        np.asarray(prompt_ids, np.int32), res,
                        task=rec_task, task_id=RL_TASKS.index(rec_task),
                        eos_token_id=cfg.eos_token_id)
                    for j, res in enumerate(results)
                ]
                turn += 1
                await act_q.put(trajs)
            t_grade = time.monotonic()
            final = await task
            # grading and finalisation after the last chunk
            self._ledger.add("compute", time.monotonic() - t_grade)
            for t in final:
                if self._sender is not None:
                    # durable: fsynced into the spool (off the event loop:
                    # the append waits on the disk, and on backpressure)
                    # before one() marks the prompt consumed; the sender
                    # thread pushes
                    await asyncio.to_thread(self._sender.submit,
                                            t.as_json_compatible())
                else:
                    pusher.push(t.as_json_compatible())
                accepted += 1
                # Weight versions that passed while the trajectory
                # generated: the off-policyness the gate bounds.
                lag = float(np.asarray(t.data["version_end"])[0]
                            - np.asarray(t.data["version_start"])[0])
                telemetry.observe("rollout/staleness_lag", lag,
                                  buckets=(0.0, 1.0, 2.0, 4.0, 8.0, 16.0))
                telemetry.set_gauge("rollout/staleness_current", lag)
            telemetry.inc("rollout/trajectories_pushed", accepted)
        except GenerationAbandonedError as e:
            # The fleet stayed dead through the failover budget: abandon
            # this rollout (the finally reports it) and keep the worker up.
            self._abandoned += 1
            abandoned = True
            logger.warning(f"rollout {uid} abandoned: {e}")
        except ConnectionError as e:
            # The trainer's end is gone (its run ended, or it died): what did
            # not go out is lost, reported as not accepted, and the prompt
            # stays unconsumed.
            undelivered = True
            logger.error(f"rollout {uid}: push failed after {accepted} of "
                         f"its trajectories ({e})")
        finally:
            # Return exactly the allocation (group_size samples), shielded
            # like the allocation: a cancellation during cleanup must not
            # skip the report.
            async def _cleanup():
                if task is not None and not task.done():
                    task.cancel()
                    await asyncio.gather(task, return_exceptions=True)
                try:
                    await self._post_json(
                        session, f"{self._mgr_url}/finish_rollout",
                        {"accepted": accepted > 0,
                         "n_samples": cfg.group_size,
                         "n_accepted": accepted, **self._who})
                except Exception as e:  # noqa: BLE001 — manager hung/dead
                    logger.warning(f"finish_rollout failed ({e}); "
                                   f"{cfg.group_size} samples of quota may "
                                   "leak until the manager restarts")

            cleanup = asyncio.ensure_future(_cleanup())
            try:
                await asyncio.shield(cleanup)
            except asyncio.CancelledError:
                await cleanup
                raise
        self._done += 1
        self._pushed += accepted
        # An abandoned or undelivered prompt counts toward done but is not
        # consumed: a transient outage must not delete prompts from training.
        if abandoned:
            return "abandoned"
        return "undelivered" if undelivered else "ok"

    async def run_async(self) -> None:
        from areal_tpu_torch.system.worker_base import WorkerControl

        cfg = self.cfg
        if cfg.durability.enabled and not cfg.recover_dir:
            raise ValueError(
                "durability.enabled=true needs a recover_dir: the spool must "
                "land next to the consumed-prompt log so that a respawned "
                "worker can replay it")
        if cfg.telemetry.enabled:
            telemetry.configure(cfg.experiment, cfg.trial, "rollout",
                                cfg.worker_index, cfg.telemetry)
            # accrual-only: concurrent rollouts are not a wall partition
            self._ledger = goodput_mod.make_ledger(
                cfg.goodput, telemetry.get(), initial_state=None)
        ctrl = WorkerControl(cfg.experiment, cfg.trial,
                             f"rollout{cfg.worker_index}")
        mgr_key = names.gen_server_manager(cfg.experiment, cfg.trial)
        self._mgr_url0 = await asyncio.to_thread(name_resolve.wait, mgr_key,
                                                 300)
        pusher = await asyncio.to_thread(
            TrajectoryPusher, cfg.experiment, cfg.trial, cfg.trainer_handler,
            block_secs=cfg.durability.push_block_secs)
        ack_puller = None
        if cfg.durability.enabled:
            ack_puller = self._arm_spool(pusher, ctrl)
        # Threads enough for every generation in flight (each holds one for
        # its chunk) plus the quota calls.
        session = AsyncHttp(max_workers=cfg.max_concurrent * cfg.group_size
                            + 16)
        # Reward fanout rides this worker's pool (owned here, never closed
        # by the client).
        svc = reward_client.service_client()
        if svc is not None:
            svc.use_session(session)
        client = PartialRolloutClient(
            self._mgr_url, session, chunk_tokens=cfg.chunk_tokens,
            retry=cfg.retry, fault_injector=self.faults,
            manager_resolver=lambda: name_resolve.get(mgr_key))
        self.client = client
        sem = asyncio.Semaphore(cfg.max_concurrent)
        pos = 0

        async def one(rec, uid):
            async with sem:
                # The trace's origin: one per admitted prompt, carried (in
                # the task's context) through the quota calls, every chunk
                # and the push, and closed by the trainer's train span.
                with telemetry.start_trace() as tctx, \
                        telemetry.span("rollout/rollout", uid=uid) as attrs:
                    if tctx is not None:
                        attrs["trace_id"] = tctx.trace_id
                    t0, t0_wall = time.monotonic(), time.time()
                    # A denied allocation does not drop the prompt: retry
                    # until the gate opens.
                    while True:
                        t_attempt = time.monotonic()
                        status = await self._rollout_one(rec, uid, client,
                                                         pusher, session)
                        if status != "retry":
                            break
                    # held by the gate (and manager blips) before the
                    # attempt that went through
                    telemetry.observe("rollout/alloc_wait_secs",
                                      t_attempt - t0)
                    self._ledger.add("data_wait", t_attempt - t0)
                    if tctx is not None:
                        telemetry.add_span("rollout/gate", t0_wall,
                                           t_attempt - t0, trace=tctx,
                                           uid=uid)
                    attrs["status"] = status
            if status == "ok":
                self.consumed.add(uid)

        pending = set()
        try:
            while cfg.max_rollouts is None or self._done < cfg.max_rollouts:
                # The control channel between scheduling rounds: pause stops
                # new rollouts; exit leaves the loop.
                await asyncio.to_thread(
                    ctrl.step,
                    lambda: {"done": self._done, "pushed": self._pushed,
                             "abandoned": self._abandoned,
                             "failovers": client.n_failovers})
                if ctrl.should_exit:
                    break
                telemetry.set_gauge("rollout/inflight", len(pending))
                telemetry.set_gauge("rollout/done", self._done)
                telemetry.set_gauge("rollout/failovers", client.n_failovers)
                self._ledger.poll()
                while len(pending) < cfg.max_concurrent:
                    rec = self.records[pos % len(self.records)]
                    # An epoch over a small dataset revisits a query id: tag
                    # the pass so trajectory ids stay unique.
                    epoch = pos // len(self.records)
                    qid = str(rec["query_id"])
                    uid = qid if epoch == 0 else f"{qid}@r{epoch}"
                    pos += 1
                    if uid in self.consumed:  # a recovered run pushed it
                        continue
                    pending.add(asyncio.create_task(one(rec, uid)))
                # bounded, so that the control channel is served while
                # every rollout waits at a closed gate
                done, pending = await asyncio.wait(
                    pending, timeout=1.0,
                    return_when=asyncio.FIRST_COMPLETED)
                for d in done:
                    d.result()  # surface exceptions
        finally:
            # Cancel what is in flight while the session is open, so their
            # finally blocks report /finish_rollout and no quota leaks.
            for t in pending:
                t.cancel()
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
            if svc is not None:
                # grades those rollouts left on the fleet: counted if they
                # come back within a short grace, so the client's counts
                # are final when the worker reports them
                await svc.settle(GRADE_SETTLE_SECS)
            session.close()
            if self._sender is not None:
                # a clean exit: in-flight acks get a bounded window, so the
                # spool drains; what stays unacked replays next incarnation
                await asyncio.to_thread(self._sender.close,
                                        cfg.durability.drain_timeout_secs)
                ack_puller.close()
            pusher.close()
            ctrl.close()
            self.consumed.close()
            if cfg.telemetry.enabled:
                self._ledger.flush()
                telemetry.shutdown()  # the final flush to the aggregator
        logger.info(f"rollout worker done: {self._pushed} trajectories "
                    f"pushed ({self._abandoned} abandoned, "
                    f"{client.n_failovers} chunk failovers)")

    def _arm_spool(self, pusher, ctrl) -> TrajectoryPuller:
        """Open the spool, bind the ack channel (leased on the control
        heartbeat like every advertisement) and start the sender."""
        cfg = self.cfg
        dur = cfg.durability
        spool = SampleSpool(
            os.path.join(cfg.recover_dir, f"spool_{cfg.worker_index}"),
            segment_bytes=dur.spool_segment_bytes,
            max_bytes=dur.spool_max_bytes)
        ack_puller = TrajectoryPuller(cfg.experiment, cfg.trial,
                                      ack_channel_name(cfg.worker_index))
        ctrl.lease(ack_puller._key, ack_puller._addr)
        self._sender = SpoolSender(
            spool, pusher, ack_puller, cfg.worker_index,
            resend_timeout_secs=dur.resend_timeout_secs)
        self._sender.start()
        return ack_puller

    def run(self) -> None:
        asyncio.run(self.run_async())
