"""Reward evaluation: the local path.

The port's copy of ``areal_tpu/rewards/client.py:52-82, 374-402``:
``task_from_record`` (the one dataset-record → grading-task builder),
``_grade_local`` and the local paths of ``batch_reward`` and of
``abatch_reward`` (``:345``, the rollout agents' entry point). The
reference can also fan tasks out to a reward-service fleet or to the fixed
host named by ``FUNCTIONCALL_SERVICE_DOMAIN``; neither is ported yet
(ROADMAP.md Queue 1 item 3, left for later). Until then both entry points
raise when that variable is set, rather than grade locally what their
caller meant to send away.

``verdict_counts`` counts the verdicts of every local grade in this
process (the reference counts them in its telemetry registry).
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures as cf
import os
import threading
from typing import Any, Dict, List, Optional

from areal_tpu_torch.rewards.service import grade_task

SERVICE_ENV = "FUNCTIONCALL_SERVICE_DOMAIN"

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
    """Grade one task in this process, through the service's dispatch."""
    out = grade_task(task, languages=languages)
    with _counts_lock:
        verdict_counts[out["verdict"]] += 1
    return float(out["score"])


def _refuse_remote() -> None:
    if os.getenv(SERVICE_ENV, ""):
        raise NotImplementedError(
            f"{SERVICE_ENV} is set, but remote grading (the reward-service "
            "fleet and the fixed-host path) is not ported yet: ROADMAP.md "
            "Queue 1 item 3, left for later. Unset it to grade locally.")


async def abatch_reward(
    tasks: List[Dict[str, Any]],
    max_workers: int = 8,
) -> List[float]:
    """Grade a batch of tasks locally without blocking the event loop: each
    task on a worker thread, at most ``max_workers`` at a time."""
    if not tasks:
        return []
    _refuse_remote()
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
    """Grade a batch of tasks locally, on a thread pool. Raises on a
    running event loop (as the reference does) and when
    ``FUNCTIONCALL_SERVICE_DOMAIN`` is set (the remote path is not ported
    yet)."""
    if not tasks:
        return []
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        pass
    else:
        raise RuntimeError(
            "batch_reward called on a running event loop; await "
            "abatch_reward instead")
    _refuse_remote()
    if len(tasks) == 1:
        return [_grade_local(tasks[0])]
    with cf.ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(_grade_local, tasks))
