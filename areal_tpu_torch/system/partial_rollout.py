"""Chunked interruptible generation client with per-token version tracking.

The port of ``areal_tpu/system/partial_rollout.py`` (reference
``realhf/system/partial_rollout.py:29``): each generation is split into
``/generate`` chunks of at most ``chunk_tokens``, so a weight update only
ever interrupts a chunk; accumulated tokens and logprobs carry across
chunks; the route stays sticky while the version is unchanged and its
lease renews; each sample records ``version_start`` / ``version_end``.

Failure recovery: every ``/generate`` call carries the whole accumulated
prefix, so a dead server costs at most one chunk — the client releases the
route, re-``/schedule_request``s with capped exponential backoff, and the
new server re-prefills prompt + accumulated tokens. After
``retry.max_attempts`` consecutive failures the generation is abandoned
with :class:`GenerationAbandonedError`. An empty fleet (503) and admission
backpressure (429) wait on their own budget (``no_server_wait_secs``).

HTTP goes through ``system/http.py``'s ``AsyncHttp`` (each call on a
thread, off the event loop) instead of an ``aiohttp`` session; the wire
contract is the reference's. With telemetry on, every generation is a
``rollout/generate`` span whose trace rides each ``/generate`` call in
the ``X-Areal-Trace`` header, with the reference's chunk-latency
histogram and its backoff, failover and abandonment counters and events.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import time
import uuid
from typing import Dict, List, Optional

import numpy as np

from areal_tpu_torch.api.model import GenerationHyperparameters
from areal_tpu_torch.base import logging, telemetry
from areal_tpu_torch.base.retry import (
    DEFAULT_GENERATION_RETRY,
    FaultInjector,
    RetryPolicy,
)
from areal_tpu_torch.system.http import AsyncHttp

logger = logging.getLogger("system.partial_rollout")


class GenerationAbandonedError(RuntimeError):
    """A chunked generation exhausted its failover retry budget."""


class NoHealthyServersError(RuntimeError):
    """The manager has no routable server (503) or cannot be reached:
    transient, waited out on the client's own (longer) budget."""


@dataclasses.dataclass
class GenResult:
    output_ids: List[int]
    output_logprobs: List[float]
    version_start: int
    version_end: int
    n_chunks: int


class PartialRolloutClient:
    """One ``generate_one`` = N chunked HTTP calls routed through the
    manager."""

    def __init__(self, manager_url: str, session: AsyncHttp,
                 chunk_tokens: int = 128,
                 retry: Optional[RetryPolicy] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 no_server_wait_secs: float = 180.0,
                 request_class: str = "rollout",
                 manager_resolver=None):
        self.manager_url = manager_url
        self.session = session
        self.chunk_tokens = chunk_tokens
        self.retry = retry or DEFAULT_GENERATION_RETRY
        # () -> url re-resolving the manager's current endpoint (a
        # respawned manager binds a fresh port).
        self._manager_resolver = manager_resolver
        self.request_class = request_class
        # Whole-fleet-empty budget: outlasts an eviction + re-admission.
        self.no_server_wait_secs = no_server_wait_secs
        self.faults = fault_injector
        self.n_failovers = 0
        self.n_abandoned = 0

    def _refresh_manager_url(self) -> None:
        if self._manager_resolver is None:
            return
        try:
            url = self._manager_resolver()
        except Exception:  # noqa: BLE001 — key cleared mid-respawn
            return
        if url and url != self.manager_url:
            logger.warning(f"manager endpoint moved "
                           f"{self.manager_url} -> {url}; re-routing")
            self.manager_url = url

    async def _schedule(self) -> Dict:
        if self.faults is not None:
            self.faults.maybe_fail("schedule")
        post = asyncio.ensure_future(self.session.post(
            f"{self.manager_url}/schedule_request",
            {"class": self.request_class}, timeout=30.0))
        try:
            _, d = await asyncio.shield(post)
        except asyncio.CancelledError:
            # The call runs on in its thread and the manager may grant the
            # lease after this task's cancel: return it, or it pins the
            # server's inflight count until it expires.
            with contextlib.suppress(Exception):
                _, late = await post
                if late.get("url"):
                    await self._release_quiet(late)
            raise
        except Exception as e:  # noqa: BLE001 — the manager itself is down
            # An unreachable manager is an empty fleet to this client: the
            # long wait budget, and the re-registered endpoint next time.
            self._refresh_manager_url()
            raise NoHealthyServersError(f"manager unreachable: {e}") from None
        if not d.get("url"):
            raise NoHealthyServersError(d.get("reason", "unknown"))
        return d

    async def _release(self, route: Dict) -> None:
        await self.session.post(
            f"{self.manager_url}/release",
            {"lease_id": route.get("lease_id"), "url": route["url"]},
            timeout=30.0)

    async def _release_quiet(self, route: Optional[Dict]) -> None:
        """Best-effort release of a possibly dead route; lease expiry at
        the manager is the backstop."""
        if route is None:
            return
        try:
            await self._release(route)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001
            pass

    async def _renew(self, route: Dict) -> bool:
        """Renew the sticky route's lease; False drops stickiness (the lease
        expired or its server was evicted)."""
        lid = route.get("lease_id")
        if lid is None:
            return True
        _, d = await self.session.post(f"{self.manager_url}/renew",
                                       {"lease_id": lid}, timeout=30.0)
        return bool(d.get("ok"))

    async def generate_one(
        self,
        prompt_ids: List[int],
        gconfig: GenerationHyperparameters,
        eos_token_id: int = 1,
    ) -> GenResult:
        with telemetry.span("rollout/generate") as span_attrs:
            res = await self._generate_one(prompt_ids, gconfig, eos_token_id)
            span_attrs["n_chunks"] = res.n_chunks
            span_attrs["n_tokens"] = len(res.output_ids)
            span_attrs["versions"] = [res.version_start, res.version_end]
        return res

    async def _generate_one(
        self,
        prompt_ids: List[int],
        gconfig: GenerationHyperparameters,
        eos_token_id: int = 1,
    ) -> GenResult:
        acc_ids: List[int] = []
        acc_lps: List[float] = []
        version_start: Optional[int] = None
        version_end = 0
        n_chunks = 0
        # The lease is held for the whole sticky lifetime, renewed each
        # chunk, released when the route drops or the generation ends.
        route: Optional[Dict] = None
        rid = uuid.uuid4().hex  # keys the server's retained decode state
        failures = 0  # consecutive chunk failures; a success resets
        fleet_waited = 0.0  # time spent waiting out an empty fleet
        throttled = 0.0  # time spent backing off admission 429s
        try:
            while len(acc_ids) < gconfig.max_new_tokens:
                left = gconfig.max_new_tokens - len(acc_ids)
                try:
                    if route is None:
                        route = await self._schedule()
                    url = route["url"]
                    body = {
                        "rid": rid,
                        "class": self.request_class,
                        "tokens_done": len(acc_ids),
                        "prompt_ids": list(prompt_ids) + acc_ids,
                        "gconfig": {
                            **dataclasses.asdict(gconfig),
                            "max_new_tokens": min(self.chunk_tokens, left),
                            "n": 1,
                        },
                        "max_tokens": min(self.chunk_tokens, left),
                        # the whole remaining budget, for admission
                        "budget_total": left,
                    }
                    if self.faults is not None:
                        self.faults.maybe_fail("generate", url=url,
                                               tokens_done=len(acc_ids))
                    t_chunk = time.monotonic()
                    # The server adopts this trace for its spans; {} (off,
                    # or no trace) leaves the request as it was.
                    status, out = await self.session.post(
                        f"{url}/generate", body, timeout=300.0,
                        headers=telemetry.inject_headers())
                    if status == 429:
                        # Admission backpressure: honour the hint on its own
                        # budget; a throttle is not a failure.
                        ra = float(out.get("retry_after", 0.2))
                        telemetry.inc("rollout/admission_backoff")
                        telemetry.event("rollout/backoff_429", url=url,
                                        retry_after=ra,
                                        tokens_done=len(acc_ids))
                        await self._release_quiet(route)
                        route = None
                        if throttled >= self.no_server_wait_secs:
                            self.n_abandoned += 1
                            telemetry.inc("rollout/abandoned")
                            raise GenerationAbandonedError(
                                f"admission-rejected for {throttled:.0f}s "
                                f"({len(acc_ids)} tokens accumulated)")
                        wait = min(max(ra, 0.05),
                                   max(self.no_server_wait_secs - throttled,
                                       0.05))
                        throttled += wait
                        await asyncio.sleep(wait)
                        continue
                    if status == 413:
                        # permanent: the prefix can never fit the KV capacity
                        self.n_abandoned += 1
                        telemetry.inc("rollout/abandoned")
                        raise GenerationAbandonedError(
                            f"prompt too long for the serving engine's KV "
                            f"capacity ({len(prompt_ids) + len(acc_ids)} "
                            "tokens)")
                    if status != 200:
                        raise RuntimeError(f"/generate status {status}")
                    telemetry.observe("rollout/chunk_secs",
                                      time.monotonic() - t_chunk)
                except asyncio.CancelledError:
                    raise
                except GenerationAbandonedError:
                    raise  # terminal (429 budget / 413): not a failover
                except NoHealthyServersError as e:
                    # Empty-fleet 503s come back in milliseconds: wait them
                    # out on the longer budget, not the failover attempts.
                    await self._release_quiet(route)
                    route = None
                    telemetry.inc("rollout/no_server_503")
                    if fleet_waited >= self.no_server_wait_secs:
                        self.n_abandoned += 1
                        telemetry.inc("rollout/abandoned")
                        raise GenerationAbandonedError(
                            f"no routable generation server for "
                            f"{fleet_waited:.0f}s ({len(acc_ids)} tokens "
                            "accumulated)") from e
                    fleet_waited += self.retry.max_delay_secs
                    await asyncio.sleep(self.retry.max_delay_secs)
                    continue
                except Exception as e:  # noqa: BLE001 — failover path
                    failures += 1
                    await self._release_quiet(route)
                    route = None
                    if failures >= self.retry.max_attempts:
                        self.n_abandoned += 1
                        telemetry.inc("rollout/abandoned")
                        raise GenerationAbandonedError(
                            f"generation abandoned after {failures} "
                            f"consecutive chunk failures ({len(acc_ids)} "
                            f"tokens accumulated): {e}") from e
                    self.n_failovers += 1
                    telemetry.inc("rollout/chunk_failovers")
                    # the trace (and the flight ring) shows when the chunk
                    # died and how many tokens the replay re-prefills
                    telemetry.event("rollout/failover", attempt=failures,
                                    tokens_done=len(acc_ids),
                                    error=str(e)[:200])
                    logger.warning(
                        f"chunk failed ({e}); re-scheduling (attempt "
                        f"{failures}/{self.retry.max_attempts}, "
                        f"{len(acc_ids)} tokens resume)")
                    await asyncio.sleep(self.retry.delay(failures))
                    continue
                failures = 0
                fleet_waited = 0.0
                throttled = 0.0
                n_chunks += 1
                acc_ids += list(out["output_ids"])
                acc_lps += list(out["output_logprobs"])
                v = int(out["version"])
                if version_start is None:
                    version_start = v
                version_end = v
                if out["finished"] or not out["output_ids"]:
                    break
                sticky = False
                if v == route.get("version", v):
                    try:
                        sticky = await self._renew(route)
                    except asyncio.CancelledError:
                        raise
                    except Exception:  # noqa: BLE001 — manager blip
                        sticky = False
                if not sticky:
                    # The version moved, the lease was refused (an evicted
                    # server may be alive but stale) or the manager
                    # blipped: back through the scheduler.
                    await self._release_quiet(route)
                    route = None
        finally:
            await self._release_quiet(route)
        return GenResult(
            output_ids=acc_ids,
            output_logprobs=acc_lps,
            version_start=version_start or 0,
            version_end=version_end,
            n_chunks=n_chunks,
        )

    async def generate_group(
        self,
        prompt_ids: List[int],
        gconfig: GenerationHyperparameters,
        group_size: int,
        eos_token_id: int = 1,
    ) -> List[GenResult]:
        # return_exceptions: every sibling runs to its end (releasing its
        # route) before an abandonment surfaces.
        results = await asyncio.gather(*[
            self.generate_one(prompt_ids, gconfig, eos_token_id)
            for _ in range(group_size)
        ], return_exceptions=True)
        for r in results:
            if isinstance(r, BaseException):
                raise r
        return list(results)


def trajectory_from_gen(
    qid: str,
    j: int,
    prompt_ids: np.ndarray,
    res: GenResult,
    task: str = "math",
    task_id: int = 0,
    eos_token_id: int = 1,
):
    """One flattened trajectory SequenceSample from a chunked generation
    (the key layout of ``algorithms.ppo.trajectories_from_gen_output``)."""
    from areal_tpu_torch.api.data import SequenceSample

    gl = max(len(res.output_ids), 1)
    toks = np.concatenate([
        prompt_ids, np.asarray(res.output_ids[:gl], np.int32)
    ]) if res.output_ids else np.concatenate([prompt_ids, [eos_token_id]])
    P = len(prompt_ids)
    gl = len(toks) - P
    lps = np.concatenate([
        np.zeros(P, np.float32),
        np.asarray((res.output_logprobs + [0.0])[:gl], np.float32),
    ])
    no_eos = float(eos_token_id not in toks[P:])
    return SequenceSample.from_default(
        ids=[f"{qid}@{j}"],
        data={
            "packed_input_ids": toks.astype(np.int32),
            "prompt_mask": np.concatenate([
                np.ones(P, np.int32), np.zeros(gl, np.int32)
            ]),
            "packed_logprobs": lps,
            "seq_no_eos_mask": np.asarray([no_eos], np.float32),
            "task_ids": np.asarray([task_id], np.int32),
            "version_start": np.asarray([res.version_start], np.int32),
            "version_end": np.asarray([res.version_end], np.int32),
            "birth_time": np.asarray([time.time()], np.float64),
        },
        seqlens=[len(toks)],
        metadata={"group": [qid], "task": [task]},
    )
