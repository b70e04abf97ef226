"""Reward evaluation: the reward-service fleet, a fixed host, or local.

The port of ``areal_tpu/rewards/client.py`` (reference
``functioncall/base/call.py:81-235`` and the dispatch of
``math_rw_interface.py:127``). Three grading modes, in this order:

 1. **The reward-service fleet** (:func:`configure_service` with an
    enabled ``RewardServiceConfig``): tasks fan out over the reward
    workers found through name_resolve (``system/reward_worker.py``) with
    bounded concurrency, a retry on a different live replica (the fleet is
    re-resolved between attempts, so a respawned worker's URL is picked up
    mid-batch), a per-task timeout, and per-task degradation to local
    grading (or 0.0) when a task's retries run out.
 2. **A fixed host** (``FUNCTIONCALL_SERVICE_DOMAIN``): one service, the
    same retries, local grading when they run out.
 3. **Local** (the default): grading in this process, bit for bit what it
    was before the service existed.

Entry points: :func:`abatch_reward` (what the agents await, so grading
never blocks the rollout loop) and :func:`batch_reward` (the trainer's
rw_inf and offline use; it raises on a running event loop). Both remote
modes speak HTTP through ``system/http.py AsyncHttp`` (the standard
library on a thread pool), not aiohttp.

``verdict_counts`` counts the verdicts of every local grade in this
process; a client's ``counts`` holds its remote grades, retries, local
fallbacks, empty-fleet attempts and rejected tasks (the reference counts
both only in its telemetry registry, where the port counts them too).
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures as cf
import dataclasses
import os
import threading
from typing import Any, Callable, Dict, List, Optional

from areal_tpu_torch.base import logging, telemetry
from areal_tpu_torch.base.retry import RetryPolicy, aretry
from areal_tpu_torch.rewards.service import grade_task, task_budget_secs

logger = logging.getLogger("rewards.client")

SERVICE_ENV = "FUNCTIONCALL_SERVICE_DOMAIN"

# The fixed-host path's backoff (base/retry.py's vocabulary).
_REMOTE_RETRY = RetryPolicy(base_delay_secs=0.5, max_delay_secs=5.0)

verdict_counts: "collections.Counter[str]" = collections.Counter()
_counts_lock = threading.Lock()


def task_from_record(record: Dict[str, Any], generated: str) -> Dict[str, Any]:
    """The grading task of a dataset record and a generated text: per-task
    fields (``input_output``, ``language``) travel with code tasks,
    ``solutions`` with the others."""
    kind = record.get("task", "math")
    task: Dict[str, Any] = {"task": kind, "generated": generated}
    if kind == "code":
        task["input_output"] = record.get("input_output", "{}")
        if "language" in record:
            task["language"] = record["language"]
    else:
        task["solutions"] = record.get("solutions", [])
    return task


def _grade_local(task: Dict[str, Any],
                 languages: Optional[List[str]] = None) -> float:
    """Grade one task in this process, through the service's dispatch (so a
    fallback's answer is the fleet's). ``languages`` carries the service's
    language policy into the fallback (None: no policy)."""
    if task.get("task", "math") == "code":
        # Code run in the calling process is what the service exists to
        # remove: counted, so that a service run can assert zero.
        telemetry.inc("reward_client/local_graded{task=code}")
    out = grade_task(task, languages=languages)
    with _counts_lock:
        verdict_counts[out["verdict"]] += 1
    return float(out["score"])


class RewardServiceClient:
    """Fanout client of the sandbox reward fleet.

    Discovery is lazy and refreshed on failure: a task whose POST fails
    marks that URL tried and retries on a different live replica. With the
    retry budget spent (or no replica reachable at all) the task degrades
    to local grading when ``local_fallback`` allows, else scores 0.0: one
    dead worker never fails a whole batch."""

    COLD_START_WAIT_SECS = 10.0

    def __init__(self, cfg, experiment: str = "", trial: str = "",
                 urls: Optional[List[str]] = None,
                 resolver: Optional[Callable[[], List[str]]] = None):
        self.cfg = cfg  # RewardServiceConfig
        self.experiment = experiment
        self.trial = trial
        self._urls: List[str] = list(urls or [])
        self._rr = 0  # round-robin cursor
        if resolver is not None:
            self._resolver = resolver
        elif experiment:
            from areal_tpu_torch.system.reward_worker import resolve_fleet

            self._resolver = lambda: resolve_fleet(experiment, trial)
        else:
            self._resolver = lambda: []
        self.policy = RetryPolicy(
            max_attempts=max(int(cfg.max_retries) + 1, 1),
            base_delay_secs=cfg.retry_base_delay_secs,
            max_delay_secs=cfg.retry_max_delay_secs)
        # An owner-attached HTTP pool (use_session): the rollout worker's,
        # reused across batches; never closed by this client.
        self._ext_session = None
        # One shared in-flight resolve: when a replica dies with 64 grades
        # in flight, one name-resolve walk serves them all.
        self._refresh_task: Optional[asyncio.Future] = None
        # Cold start: the first resolve gets bounded patience (the fleet
        # may still be registering at launch).
        self._fleet_seen = bool(urls)
        self.counts: "collections.Counter[str]" = collections.Counter()
        # Calls whose callers were cancelled, still out (see _post).
        self._unsettled: set = set()

    def _count(self, what: str) -> None:
        self.counts[what] += 1
        telemetry.inc(f"reward_client/{what}")

    async def _await_fleet(self) -> None:
        """Bounded wait for the first registration: before any worker was
        ever seen, degrading to local code execution because the fleet is
        half a second late would defeat the sandbox. Once a fleet was seen
        (or the window spent), a dead fleet is the retry budget's."""
        if self._fleet_seen:
            return
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.COLD_START_WAIT_SECS
        while not self._urls:
            await self.arefresh()
            if self._urls:
                break
            self._count("fleet_empty")
            if loop.time() >= deadline:
                break
            await asyncio.sleep(0.25)
        self._fleet_seen = True

    def use_session(self, session) -> None:
        """Attach an owner's ``AsyncHttp`` (closed by its owner only)."""
        self._ext_session = session

    def refresh(self) -> List[str]:
        """Re-resolve the fleet (blocking name_resolve I/O; async callers
        use :meth:`arefresh`)."""
        fresh = self._resolver()
        if fresh:
            self._urls = list(fresh)
        return self._urls

    async def arefresh(self) -> List[str]:
        """Re-resolve off the loop, one walk shared by concurrent callers
        (shielded: a cancelled awaiter must not kill the others' walk)."""
        loop = asyncio.get_running_loop()
        t = self._refresh_task
        if t is None or t.done() or t.get_loop() is not loop:
            t = self._refresh_task = asyncio.ensure_future(
                asyncio.to_thread(self.refresh))
        return await asyncio.shield(t)

    def _pick(self, exclude=()) -> Optional[str]:
        """The next replica round-robin, skipping tried URLs; with every
        replica tried, any (a blip may have passed)."""
        pool = [u for u in self._urls if u not in exclude] or self._urls
        if not pool:
            return None
        self._rr += 1
        return pool[self._rr % len(pool)]

    @staticmethod
    def _endpoint(task: Dict[str, Any]) -> str:
        return ("math_verify" if task.get("task", "math") in ("math", "stem")
                else "code_verify")

    async def grade_one(self, session, task: Dict[str, Any],
                        sem: asyncio.Semaphore) -> float:
        async with sem:
            await self._await_fleet()  # the cold start only
            # The client never abandons a grade the server may still run
            # legally: the server's per-task budget plus headroom for queue
            # wait and the network (its base takes grade_timeout_secs too,
            # so a raised server budget raises the client's patience).
            http_total = task_budget_secs(task, max(
                float(self.cfg.request_timeout_secs),
                float(self.cfg.grade_timeout_secs))) + 15.0
            tried: set = set()
            for attempt in range(1, self.policy.max_attempts + 1):
                if not self._urls:
                    await self.arefresh()
                url = self._pick(exclude=tried)
                if url is None:
                    # Not resolvable yet (workers may still register): spend
                    # an attempt with backoff rather than run the code here.
                    self._count("fleet_empty")
                    if attempt < self.policy.max_attempts:
                        await asyncio.sleep(self.policy.delay(attempt))
                    continue
                try:
                    status, out = await self._post(
                        session, f"{url}/{self._endpoint(task)}", task,
                        http_total)
                    if 400 <= status < 500 and status not in (408, 429):
                        # A deterministic rejection (a malformed task): no
                        # replica accepts it; degrade now.
                        self._count("bad_request")
                        logger.warning(f"reward worker {url} rejected a task "
                                       f"(http {status}); not retrying")
                        break
                    if status != 200:
                        raise RuntimeError(f"http {status}")
                    self._count("remote")
                    self._fleet_seen = True
                    return float(out.get("score", 0.0))
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — the replica failed
                    # A worker died mid-batch: the next attempt lands on a
                    # survivor, and a re-resolve picks up a respawn's URL.
                    tried.add(url)
                    self._count("retries")
                    logger.warning(f"reward worker {url} failed ({e}); "
                                   f"attempt {attempt}/"
                                   f"{self.policy.max_attempts}")
                    await self.arefresh()
                    if attempt < self.policy.max_attempts:
                        await asyncio.sleep(self.policy.delay(attempt))
            # Only the tasks whose budget ran out leave the fleet.
            self._count("local_fallback")
            if not self.cfg.local_fallback:
                logger.warning("reward fleet unreachable and "
                               "local_fallback=false; scoring 0.0")
                return 0.0
            return await asyncio.to_thread(_grade_local, task,
                                           list(self.cfg.languages))

    async def _post(self, session, url: str, task, timeout: float):
        """``session.post``. A cancelled caller returns at once, but its
        request may already be on the wire and a worker may still grade
        it: the call runs on, is counted as ``remote`` if it comes back
        graded, and :meth:`settle` waits for such calls (bounded)."""
        call = asyncio.ensure_future(session.post(url, task, timeout=timeout))
        try:
            return await asyncio.shield(call)
        except asyncio.CancelledError:
            self._unsettled.add(call)
            call.add_done_callback(self._settled)
            raise

    def _settled(self, call: asyncio.Future) -> None:
        self._unsettled.discard(call)
        if (not call.cancelled() and call.exception() is None
                and call.result()[0] == 200):
            self._count("remote")

    async def settle(self, grace_secs: float) -> int:
        """Wait up to ``grace_secs`` for the calls whose callers were
        cancelled, so that the counts match the fleet's when the owner
        exits with grades in flight. Returns how many are still out."""
        if self._unsettled:
            await asyncio.wait(set(self._unsettled), timeout=grace_secs)
        return len(self._unsettled)

    async def abatch(self, tasks: List[Dict[str, Any]]) -> List[float]:
        from areal_tpu_torch.system.http import AsyncHttp

        sem = asyncio.Semaphore(max(int(self.cfg.max_concurrency), 1))
        session = self._ext_session
        if session is not None and not session.closed:
            return list(await asyncio.gather(
                *[self.grade_one(session, t, sem) for t in tasks]))
        # No owner's pool (the trainer's per-batch asyncio.run, tools): one
        # for this call.
        session = AsyncHttp(max_workers=max(int(self.cfg.max_concurrency), 1))
        try:
            return list(await asyncio.gather(
                *[self.grade_one(session, t, sem) for t in tasks]))
        finally:
            session.close()


# The process's service mode: configured once per worker process (the
# rollout worker's and the trainer's setup), read by every call site.
_SERVICE_CLIENT: Optional[RewardServiceClient] = None


def configure_service(cfg, experiment: str = "", trial: str = "",
                      urls: Optional[List[str]] = None,
                      resolver=None) -> Optional[RewardServiceClient]:
    """Install (or clear) the process-wide reward-service client. A None or
    disabled config clears it: grading returns to the local path."""
    global _SERVICE_CLIENT
    if cfg is None or not getattr(cfg, "enabled", False):
        _SERVICE_CLIENT = None
        return None
    _SERVICE_CLIENT = RewardServiceClient(cfg, experiment, trial, urls=urls,
                                          resolver=resolver)
    logger.info(f"reward grading in service mode ({cfg.n_workers} workers, "
                f"concurrency {cfg.max_concurrency}, retries "
                f"{cfg.max_retries})")
    return _SERVICE_CLIENT


def service_client() -> Optional[RewardServiceClient]:
    return _SERVICE_CLIENT


async def abatch_reward(
    tasks: List[Dict[str, Any]],
    max_workers: int = 8,
    max_retries: int = 2,
) -> List[float]:
    """Grade a batch without blocking the event loop: on the fleet in
    service mode, on ``FUNCTIONCALL_SERVICE_DOMAIN``'s host when it is set,
    else locally, each task on a worker thread, at most ``max_workers`` at
    a time."""
    if not tasks:
        return []
    if _SERVICE_CLIENT is not None:
        return await _SERVICE_CLIENT.abatch(tasks)
    domain = os.getenv(SERVICE_ENV, "")
    if domain:
        return await _abatch_domain(tasks, domain, max_retries)
    sem = asyncio.Semaphore(max(int(max_workers), 1))

    async def one(t):
        async with sem:
            return await asyncio.to_thread(_grade_local, t)

    return list(await asyncio.gather(*[one(t) for t in tasks]))


def batch_reward(
    tasks: List[Dict[str, Any]],
    max_workers: int = 8,
    max_retries: int = 2,
) -> List[float]:
    """Synchronous grading (the trainer's rw_inf, offline use). Raises on a
    running event loop: await :func:`abatch_reward` there instead."""
    if not tasks:
        return []
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        pass
    else:
        raise RuntimeError(
            "batch_reward called on a running event loop; await "
            "abatch_reward(tasks) instead: the sync form would block every "
            "in-flight rollout until the batch completes")
    if _SERVICE_CLIENT is not None or os.getenv(SERVICE_ENV, ""):
        return asyncio.run(abatch_reward(tasks, max_workers, max_retries))
    # The local path, as before the service.
    if len(tasks) == 1:
        return [_grade_local(tasks[0])]
    with cf.ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(_grade_local, tasks))


async def _abatch_domain(tasks, domain: str, max_retries: int) -> List[float]:
    """The fixed-host path (``FUNCTIONCALL_SERVICE_DOMAIN``): each task
    posted with retries, graded locally when they run out."""
    from areal_tpu_torch.system.http import AsyncHttp

    policy = dataclasses.replace(_REMOTE_RETRY, max_attempts=max_retries + 1)
    base = domain if domain.startswith("http") else f"http://{domain}"

    async def call_one(session, task, sem):
        url = f"{base}/{RewardServiceClient._endpoint(task)}"

        async def post_once():
            status, out = await session.post(url, task, timeout=120)
            if status >= 500:
                raise RuntimeError(f"http {status}")
            return float(out.get("score", 0.0))

        async with sem:
            try:
                return await aretry(post_once, policy)
            except Exception as e:  # noqa: BLE001 — retries exhausted
                logger.warning(f"remote reward failed ({e}); local fallback")
                return await asyncio.to_thread(_grade_local, task)

    sem = asyncio.Semaphore(64)
    session = AsyncHttp(max_workers=64)
    try:
        return list(await asyncio.gather(
            *[call_one(session, t, sem) for t in tasks]))
    finally:
        session.close()
