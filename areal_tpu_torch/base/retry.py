"""Retry/backoff policy and fault injection for the fleet's network hops.

The port's copy of ``areal_tpu/base/retry.py``: one ``RetryPolicy`` serves
the partial rollout client's chunk failover (``aretry``, asyncio) and the
manager's weight fanout (``retry``, its blocking twin for the manager's
threads); ``FaultInjector`` is the test seam (``maybe_fail(point)`` at each
failure boundary, ``arm`` / ``arm_delay`` in tests).
"""

from __future__ import annotations

import asyncio
import dataclasses
import random
import time
from typing import Awaitable, Callable, Dict, Optional, Tuple, Type


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff: delay(n) = min(base * mult^(n-1), max)."""

    max_attempts: int = 4
    base_delay_secs: float = 0.1
    max_delay_secs: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.0  # +/- fraction of the delay, de-synchronizes herds

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based failure count)."""
        d = self.base_delay_secs * self.multiplier ** max(attempt - 1, 0)
        d = min(d, self.max_delay_secs)
        if self.jitter:
            d *= 1.0 + random.uniform(-self.jitter, self.jitter)
        return max(d, 0.0)


async def aretry(
    fn: Callable[[], Awaitable],
    policy: RetryPolicy,
    *,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    timeout: Optional[float] = None,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
):
    """Run ``fn`` up to ``policy.max_attempts`` times with backoff between
    failures. ``timeout`` bounds EACH attempt (asyncio.wait_for), so the
    worst case is max_attempts * (timeout + delay) — a budget the caller can
    compute. The last failure is re-raised unchanged."""
    attempt = 0
    while True:
        attempt += 1
        try:
            if timeout is not None:
                return await asyncio.wait_for(fn(), timeout)
            return await fn()
        except retry_on as e:
            if attempt >= policy.max_attempts:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            await asyncio.sleep(policy.delay(attempt))


def retry(
    fn: Callable[[], object],
    policy: RetryPolicy,
    *,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
):
    """``aretry`` for blocking callers: ``fn`` bounds each attempt itself
    (a socket timeout), so the worst case is max_attempts * (its timeout +
    delay). The last failure is re-raised unchanged."""
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except retry_on as e:
            if attempt >= policy.max_attempts:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(policy.delay(attempt))


# Fleet-wide default for generation chunk failover — referenced by both
# PartialRolloutClient and RolloutWorkerConfig so the two cannot drift.
DEFAULT_GENERATION_RETRY = RetryPolicy(
    max_attempts=6, base_delay_secs=0.05, max_delay_secs=2.0
)


class FaultInjected(RuntimeError):
    """Raised by FaultInjector at an armed fault point."""


class FaultInjector:
    """Deterministic failure injection for chaos tests.

    Production code threads an (optional) injector through and calls
    ``maybe_fail(point, **ctx)`` at each failure boundary; with no injector
    armed this is a dict lookup — effectively free. Tests arm points::

        inj = FaultInjector()
        inj.arm("generate", times=2)            # next 2 calls raise
        inj.arm("fanout", times=-1,             # every call, selectively
                when=lambda ctx: "dead" in ctx.get("url", ""))

    ``times=-1`` means unlimited until :meth:`disarm`. ``fired`` counts
    triggers per point so tests can assert the failure path actually ran.

    Latency injection (straggler / slow-network simulation)::

        inj = FaultInjector(sleeper=fake_sleep)   # default: asyncio.sleep
        inj.arm_delay("decode", 0.8, times=-1,
                      when=lambda ctx: ctx.get("server_id") == "gen1")
        ...
        await inj.maybe_delay("decode", server_id=sid)  # awaits sleeper(0.8)

    ``delay_for`` returns the armed delay without sleeping, for call sites
    that fold it into their own timing (fake servers reporting synthetic
    decode latency). Delay points are independent of failure points: one
    name may be armed for both, in which case ``maybe_delay`` sleeps and
    ``maybe_fail`` raises.
    """

    def __init__(self, sleeper: Optional[Callable] = None):
        self._armed: Dict[str, dict] = {}
        self._delays: Dict[str, dict] = {}
        self.fired: Dict[str, int] = {}
        # Injectable so fake-clock tests advance virtual time instead of
        # blocking the loop; must be an async callable taking seconds.
        self.sleeper = sleeper if sleeper is not None else asyncio.sleep

    def arm(
        self,
        point: str,
        times: int = 1,
        exc: Optional[Callable[[], BaseException]] = None,
        when: Optional[Callable[[dict], bool]] = None,
    ) -> None:
        self._armed[point] = {"times": times, "exc": exc, "when": when}

    def arm_delay(
        self,
        point: str,
        delay_secs: float,
        times: int = 1,
        when: Optional[Callable[[dict], bool]] = None,
    ) -> None:
        self._delays[point] = {
            "delay": float(delay_secs), "times": times, "when": when,
        }

    def disarm(self, point: str) -> None:
        self._armed.pop(point, None)
        self._delays.pop(point, None)

    def delay_for(self, point: str, **ctx) -> float:
        """The armed delay for this call (0.0 when unarmed / filtered /
        exhausted). Consumes one ``times`` charge and counts in ``fired``
        like a failure trigger does."""
        spec = self._delays.get(point)
        if spec is None or spec["times"] == 0:
            return 0.0
        if spec["when"] is not None and not spec["when"](ctx):
            return 0.0
        if spec["times"] > 0:
            spec["times"] -= 1
        self.fired[point] = self.fired.get(point, 0) + 1
        return spec["delay"]

    async def maybe_delay(self, point: str, **ctx) -> float:
        """Await the armed delay through ``self.sleeper`` (deterministic
        under fake clocks); returns the seconds slept (0.0 = unarmed)."""
        d = self.delay_for(point, **ctx)
        if d > 0.0:
            await self.sleeper(d)
        return d

    def maybe_fail(self, point: str, **ctx) -> None:
        spec = self._armed.get(point)
        if spec is None or spec["times"] == 0:
            return
        if spec["when"] is not None and not spec["when"](ctx):
            return
        if spec["times"] > 0:
            spec["times"] -= 1
        self.fired[point] = self.fired.get(point, 0) + 1
        exc = spec["exc"]
        raise exc() if exc is not None else FaultInjected(point)
