"""Serving bookkeeping of the generation server, as the default
configuration uses it.

Counterpart of the parts of ``areal_tpu/system/serving.py`` that run with
``serving.enabled=false``: the bucket arithmetic, the pass-through shape
policy (KV capacity rounds up to ``kv_bucket``; chunks and rows pass
through) and the retained-state store with LRU and a byte budget.
Request classes, admission control, the prefix trie and SLO metrics wait
for a later slice. Plain Python, no device work.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple


def round_up(n: int, bucket: int) -> int:
    """Round ``n`` up to a multiple of ``bucket``: the one copy of the bucket
    arithmetic that prefill padding and the capacity math share."""
    return ((n + bucket - 1) // bucket) * bucket


class ShapeBucketPolicy:
    """The pass-through shape policy: KV capacities round up to multiples of
    ``quantum``; chunks and rows pass through. Every shape the engine runs
    is recorded."""

    def __init__(self, quantum: int):
        self.quantum = max(int(quantum), 1)
        self._shapes: set = set()

    def round_capacity(self, n: int) -> int:
        return round_up(n, self.quantum)

    def round_chunk(self, n: int) -> int:
        return n

    def round_rows(self, n: int) -> int:
        return n

    def observe(self, kind: str, *dims: int) -> None:
        self._shapes.add((kind,) + tuple(int(d) for d in dims))

    def shapes(self) -> List[Tuple]:
        return sorted(self._shapes)


class ReqState:
    """Server-resident decode state of one in-flight chunked request."""

    __slots__ = ("state", "cur_len", "version", "last_used", "nbytes")

    def __init__(self, state, cur_len: int, version: int):
        self.state = state  # single-row decode state (models/generate.py)
        self.cur_len = cur_len
        self.version = version
        self.last_used = time.monotonic()
        self.nbytes = sum(state[k].numel() * state[k].element_size()
                          for k in ("kv_k", "kv_v"))


class KVStateStore:
    """Retained per-request decode states with LRU + KV-bytes eviction.

    Thread-safe: the decode thread mutates the store while request handlers
    may read it; every method holds one lock."""

    def __init__(self, slots: int, bytes_budget: int):
        self.slots = slots
        self.bytes_budget = bytes_budget
        self._states: Dict[str, ReqState] = {}
        self._lock = threading.RLock()

    def get(self, rid: str) -> Optional[ReqState]:
        with self._lock:
            return self._states.get(rid)

    def put(self, rid: str, st: ReqState) -> None:
        with self._lock:
            self._states[rid] = st

    def pop(self, rid: str) -> Optional[ReqState]:
        with self._lock:
            return self._states.pop(rid, None)

    def clear(self) -> None:
        """Drop every retained state (a weight swap makes them stale)."""
        with self._lock:
            self._states.clear()

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._states)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return sum(s.nbytes for s in self._states.values())

    def evict(self) -> int:
        """LRU-evict down to the slot and byte budgets; returns the number
        of evicted states."""
        with self._lock:
            if self.slots <= 0:
                n = len(self._states)
                self._states.clear()
                return n
            n_evicted = 0
            total = self.nbytes
            while len(self._states) > self.slots or (
                    total > self.bytes_budget and self._states):
                rid = min(self._states, key=lambda r: self._states[r].last_used)
                total -= self._states.pop(rid).nbytes
                n_evicted += 1
            return n_evicted
