"""Scoped statistics tracker.

The port's copy of ``areal_tpu/base/stats_tracker.py`` (reference
``realhf/base/stats_tracker.py:20``, DistributedStatsTracker): scoped keys,
denominator-based reductions (AVG over a bool mask), SUM/MIN/MAX, moving
averages and scalar stats, computed on host numpy.
"""

from __future__ import annotations

import enum
import threading
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "ReduceType",
    "StatsTracker",
    "DEFAULT_TRACKER",
    "scope",
    "denominator",
    "stat",
    "scalar",
    "moving_avg",
    "export",
]


class ReduceType(enum.Enum):
    AVG = "avg"
    SUM = "sum"
    MIN = "min"
    MAX = "max"
    SCALAR = "scalar"
    MOVING_AVG = "moving_avg"


class StatsTracker:
    """Workers record from async loops AND health-check/flush threads
    concurrently (e.g. a telemetry flush exporting while the serve loop
    appends), so every mutation — scope push/pop included — and the
    export-with-reset run under one re-entrant lock. Scopes are
    per-THREAD (a thread-local stack): a background thread's recording
    must not inherit, or tear, the serve loop's scope nesting."""

    def __init__(self):
        self._local = threading.local()
        self._lock = threading.RLock()
        self._denoms: Dict[str, np.ndarray] = {}
        # key -> (reduce_type, list of (values, denom_key|None))
        self._stats: Dict[str, tuple] = {}
        self._moving: Dict[str, float] = {}

    @property
    def _scopes(self) -> List[str]:
        if not hasattr(self._local, "scopes"):
            self._local.scopes = []
        return self._local.scopes

    # ---- scoping ----
    @contextmanager
    def scope(self, name: str):
        self._scopes.append(name)
        try:
            yield self
        finally:
            self._scopes.pop()

    def _key(self, name: str) -> str:
        return "/".join(self._scopes + [name])

    # ---- recording ----
    def denominator(self, **kwargs) -> None:
        """Register boolean masks usable as denominators for AVG stats."""
        for name, mask in kwargs.items():
            m = np.asarray(mask)
            if m.dtype != np.bool_:
                m = m.astype(bool)
            with self._lock:
                self._denoms[self._key(name)] = m

    def stat(
        self, denominator: str, reduce_type: ReduceType = ReduceType.AVG, **kwargs
    ) -> None:
        """Record vector stats reduced over the elements selected by the named
        denominator mask."""
        with self._lock:
            dkey = self._key(denominator)
            if dkey not in self._denoms:
                raise ValueError(f"unknown denominator {dkey}")
            mask = self._denoms[dkey]
            for name, value in kwargs.items():
                v = np.asarray(value, dtype=np.float64)
                key = self._key(name)
                prev = self._stats.get(key)
                if prev is not None and prev[0] != reduce_type:
                    raise ValueError(f"conflicting reduce types for {key}")
                entries = prev[1] if prev else []
                entries.append((v, mask))
                self._stats[key] = (reduce_type, entries)

    def scalar(self, **kwargs) -> None:
        with self._lock:
            for name, value in kwargs.items():
                key = self._key(name)
                prev = self._stats.get(key)
                entries = prev[1] if prev else []
                entries.append((float(value), None))
                self._stats[key] = (ReduceType.SCALAR, entries)

    def moving_avg(self, decay: float = 0.99, **kwargs) -> None:
        with self._lock:
            for name, value in kwargs.items():
                key = self._key(name)
                old = self._moving.get(key, float(value))
                self._moving[key] = decay * old + (1 - decay) * float(value)

    # ---- export ----
    def export(self, reset: bool = True) -> Dict[str, float]:
        with self._lock:
            return self._export_locked(reset)

    def _export_locked(self, reset: bool) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for key, (rtype, entries) in self._stats.items():
            if rtype == ReduceType.SCALAR:
                vals = [e[0] for e in entries]
                out[key] = float(np.mean(vals))
                continue
            num = 0.0
            den = 0.0
            mn, mx = np.inf, -np.inf
            for v, mask in entries:
                if v.shape != mask.shape:
                    raise ValueError(
                        f"stat {key} shape {v.shape} != denominator shape {mask.shape}"
                    )
                sel = v[mask]
                num += float(sel.sum()) if sel.size else 0.0
                den += float(mask.sum())
                if sel.size:
                    mn = min(mn, float(sel.min()))
                    mx = max(mx, float(sel.max()))
            if rtype == ReduceType.AVG:
                out[key] = num / max(den, 1e-8)
            elif rtype == ReduceType.SUM:
                out[key] = num
            elif rtype == ReduceType.MIN:
                out[key] = mn if np.isfinite(mn) else 0.0
            elif rtype == ReduceType.MAX:
                out[key] = mx if np.isfinite(mx) else 0.0
        for dkey, mask in self._denoms.items():
            out.setdefault(f"{dkey}/count", float(np.asarray(mask).sum()))
        out.update({k: v for k, v in self._moving.items()})
        if reset:
            self._stats.clear()
            self._denoms.clear()
        return out


DEFAULT_TRACKER = StatsTracker()


def scope(name: str):
    return DEFAULT_TRACKER.scope(name)


def denominator(**kwargs):
    return DEFAULT_TRACKER.denominator(**kwargs)


def stat(denominator: str, reduce_type: ReduceType = ReduceType.AVG, **kwargs):
    return DEFAULT_TRACKER.stat(denominator, reduce_type, **kwargs)


def scalar(**kwargs):
    return DEFAULT_TRACKER.scalar(**kwargs)


def moving_avg(decay: float = 0.99, **kwargs):
    return DEFAULT_TRACKER.moving_avg(decay, **kwargs)


def export(reset: bool = True):
    return DEFAULT_TRACKER.export(reset)
