"""The generation fleet's serving engine: request classes with bounded
admission, priority batch formation, cross-request prefix-reuse KV and a
bounded set of batch shapes.

The port of ``areal_tpu/system/serving.py``; the generation server
(system/generation_server.py) delegates these decisions to it:

 - **Request classes** — ``interactive`` > ``eval`` > ``rollout``
   (:data:`REQUEST_CLASSES`); an unknown class is served as ``rollout``.
   Each class has a bounded queue; a full one raises
   :class:`AdmissionReject` (HTTP 429 with a retry-after hint), and a
   prompt that can never fit the largest KV capacity raises
   :class:`PromptTooLong` (HTTP 413).
 - **Priority batches** — :class:`ServingQueue` drains interactive before
   eval before rollout, FIFO within a class, keeping ``min_rollout_share``
   of each batch for waiting rollouts.
 - **Prefix reuse** — :class:`KVStateStore` indexes the retained decode
   states by a token :class:`PrefixTrie`; a request whose prompt shares a
   prefix with a retained state clones the donor's KV up to the shared
   length and prefills only the suffix. A pinned donor is never evicted.
 - **Bounded shapes** — :class:`ShapeBucketPolicy` rounds capacities,
   prompt widths, chunk lengths and batch rows to configured buckets and
   records every shape it sees, so the distinct-shapes gauge is bounded.

With ``serving.enabled=false`` (the default) the queue is one unbounded
FIFO, capacities round to ``kv_bucket`` multiples and nothing is reused:
the rollout-only server.

Differences from the reference: its queue lives on one asyncio loop, so
admission and enqueue are atomic by construction; here request handlers
run on threads of their own, so :class:`ServingQueue` holds its limit
check, its append and its drain under one lock, with a condition the
runner thread blocks on, and a :meth:`ServingQueue.close` that passes
both the limits and the priority order. Plain Python, no device work.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from areal_tpu_torch.api.train_config import ServingConfig
from areal_tpu_torch.base import telemetry as telemetry_mod

# Priority order: interactive has the tightest latency objective, eval is
# an operator waiting, rollout is bulk work paced by the staleness gate.
REQUEST_CLASSES = ("interactive", "eval", "rollout")


def normalize_class(cls: Any) -> str:
    """An unknown or absent class is served as rollout (a typo must not
    reject the bulk class)."""
    return cls if cls in REQUEST_CLASSES else "rollout"


def round_up(n: int, bucket: int) -> int:
    """Round ``n`` up to a multiple of ``bucket``: the one copy of the bucket
    arithmetic that admission, prefill padding and the capacity math
    share."""
    return ((n + bucket - 1) // bucket) * bucket


class AdmissionReject(Exception):
    """The queue of ``cls`` is at its limit; retry after a while (429)."""

    def __init__(self, cls: str, depth: int, limit: int, retry_after: float):
        super().__init__(f"{cls} queue full ({depth}/{limit}); retry after "
                         f"{retry_after:g}s")
        self.cls = cls
        self.depth = depth
        self.limit = limit
        self.retry_after = retry_after


class PromptTooLong(Exception):
    """The prompt (and a decode chunk) exceeds the largest KV capacity:
    permanent for this request (413)."""

    def __init__(self, needed: int, cap: int):
        super().__init__(f"prompt needs {needed} KV slots > max capacity {cap}")
        self.needed = needed
        self.cap = cap


# ---------------------------------------------------------------------------
# bounded shapes
# ---------------------------------------------------------------------------

# The generation server's shape-policy inputs; GenerationServerConfig's
# defaults are these, and experiment_policy_kwargs maps an experiment onto
# them for both the servers it spawns and validate_config.
GEN_KV_BUCKET_DEFAULT = 256
GEN_CHUNK_TOKENS_DEFAULT = 128
GEN_MAX_BATCH_SIZE_DEFAULT = 64
GEN_PROMPT_BUCKET_DEFAULT = 128


def experiment_policy_kwargs(cfg: Any) -> Dict[str, int]:
    """The ``policy_from_config`` inputs of the generation servers spawned
    for the experiment ``cfg`` (the server defaults where it has no such
    knob)."""
    return dict(
        kv_bucket=GEN_KV_BUCKET_DEFAULT,
        chunk_tokens=int(getattr(cfg, "new_tokens_per_chunk",
                                 GEN_CHUNK_TOKENS_DEFAULT)),
        max_batch_size=int(getattr(cfg, "gen_max_batch_size",
                                   GEN_MAX_BATCH_SIZE_DEFAULT)),
        prompt_bucket=int(getattr(cfg, "gen_prompt_bucket",
                                  GEN_PROMPT_BUCKET_DEFAULT)),
    )


class ShapeBucketPolicy:
    """Owns the decode engine's set of batch shapes.

    ``capacity_buckets=None`` is the pass-through policy of the default
    server: capacities round to ``quantum`` multiples, widths, chunks and
    rows pass through. With bucket lists every dimension rounds up to a
    bucket, and the constructor refuses lists whose worst case over the
    three shape kinds (decode: rows x capacities x chunks; prefill: rows x
    widths x chunks; extend: widths x capacities) exceeds ``max_shapes``.
    """

    def __init__(self, quantum: int,
                 capacity_buckets: Optional[Sequence[int]] = None,
                 chunk_buckets: Optional[Sequence[int]] = None,
                 row_buckets: Optional[Sequence[int]] = None,
                 width_buckets: Optional[Sequence[int]] = None,
                 max_shapes: int = 0):
        def norm(b):
            return sorted({int(x) for x in b}) if b else None

        self.quantum = max(int(quantum), 1)
        self.capacity_buckets = norm(capacity_buckets)
        self.chunk_buckets = norm(chunk_buckets)
        self.row_buckets = norm(row_buckets)
        self.width_buckets = norm(width_buckets)
        self.max_shapes = int(max_shapes)
        self._shapes: set = set()
        if self.max_shapes > 0 and self.capacity_buckets is not None:
            n_caps = len(self.capacity_buckets)
            n_chunks = len(self.chunk_buckets or [1])
            n_rows = len(self.row_buckets or [1])
            worst = n_caps * n_chunks * n_rows  # decode
            if self.width_buckets is not None:
                n_widths = len(self.width_buckets)
                worst += n_rows * n_widths * n_chunks  # prefill
                worst += n_widths * n_caps  # extend
            if worst > self.max_shapes:
                raise ValueError(
                    f"shape-bucket config allows {worst} compiled shapes "
                    f"worst-case (decode + prefill + extend) > "
                    f"max_compiled_shapes={self.max_shapes}; coarsen the "
                    f"bucket lists or raise the cap (serving.* in "
                    f"api/train_config.py)")

    @staticmethod
    def _round_up(n: int, buckets: List[int]) -> int:
        for b in buckets:
            if n <= b:
                return b
        raise PromptTooLong(n, buckets[-1])

    def round_capacity(self, n: int) -> int:
        if self.capacity_buckets is None:
            return round_up(n, self.quantum)
        return self._round_up(n, self.capacity_buckets)

    def round_width(self, n: int) -> int:
        """The prefill/extend token width of ``n`` (pass-through when
        unbounded)."""
        if self.width_buckets is None:
            return n
        return self._round_up(n, self.width_buckets)

    def round_chunk(self, n: int) -> int:
        if self.chunk_buckets is None:
            return n
        # Beyond the largest bucket: clamp (each row stops at its own
        # allowance, so a shorter chunk costs latency, not correctness).
        if n >= self.chunk_buckets[-1]:
            return self.chunk_buckets[-1]
        return self._round_up(n, self.chunk_buckets)

    def round_chunk_down(self, n: int) -> int:
        """The largest chunk bucket <= n (n itself when none fits): a chunk
        clamped under the capacity ceiling stays a bucketed shape."""
        if self.chunk_buckets is None:
            return n
        for b in reversed(self.chunk_buckets):
            if b <= n:
                return b
        return n

    def round_rows(self, n: int) -> int:
        if self.row_buckets is None:
            return n
        if n >= self.row_buckets[-1]:
            return self.row_buckets[-1]
        return self._round_up(n, self.row_buckets)

    def fits(self, n_slots: int) -> bool:
        """Can a sequence of ``n_slots`` ever sit in a capacity bucket?"""
        return (self.capacity_buckets is None
                or n_slots <= self.capacity_buckets[-1])

    def observe(self, kind: str, *dims: int) -> None:
        self._shapes.add((kind,) + tuple(int(d) for d in dims))

    @property
    def distinct_shapes(self) -> int:
        return len(self._shapes)

    def shapes(self) -> List[Tuple]:
        return sorted(self._shapes)


def policy_from_config(cfg: ServingConfig, *, kv_bucket: int,
                       chunk_tokens: int, max_batch_size: int,
                       prompt_bucket: int) -> ShapeBucketPolicy:
    """The server's shape policy: pass-through when serving is off, bounded
    buckets (with derived defaults) when on."""
    if not cfg.enabled:
        return ShapeBucketPolicy(quantum=kv_bucket)
    caps = []
    c = max(kv_bucket, 1)
    while c < cfg.max_kv_capacity:
        caps.append(c)
        c *= 2
    caps.append(cfg.max_kv_capacity)
    chunks = list(cfg.chunk_buckets)
    if not chunks:
        # a factor-4 ladder down from chunk_tokens: a small budget (an
        # interactive first chunk) decodes a small chunk
        c = chunk_tokens
        while c > 16:
            chunks.append(c)
            c //= 4
        chunks.append(max(c, 1))
    rows = list(cfg.row_buckets)
    if not rows:
        r = 1
        while r < max_batch_size:
            rows.append(r)
            r *= 2
        rows.append(max_batch_size)
    elif max(rows) < max_batch_size:
        # round_rows would clamp a larger drain down and the batch would
        # run at its raw size: one shape per batch size
        raise ValueError(
            f"serving.row_buckets max ({max(rows)}) < max_batch_size "
            f"({max_batch_size}): batches above the largest bucket would "
            f"compile per exact size; add {max_batch_size} to row_buckets "
            f"or lower max_batch_size")
    # Widths: doubling from prompt_bucket, the last at the widest prefill
    # that leaves one minimum chunk under the capacity ceiling.
    top = cfg.max_kv_capacity - min(chunks)
    if top < max(prompt_bucket, 1):
        raise ValueError(
            f"serving.max_kv_capacity ({cfg.max_kv_capacity}) minus the "
            f"minimum chunk bucket ({min(chunks)}) leaves {top} KV slots "
            f"for prompts — less than one {prompt_bucket}-wide prompt "
            f"bucket, so every request would be rejected at admission; "
            f"raise max_kv_capacity or shrink chunk_buckets")
    widths = []
    w = max(prompt_bucket, 1)
    while w < top:
        widths.append(w)
        w *= 2
    widths.append(max(top, 1))
    return ShapeBucketPolicy(
        quantum=kv_bucket, capacity_buckets=caps, chunk_buckets=chunks,
        row_buckets=rows, width_buckets=widths,
        max_shapes=cfg.max_compiled_shapes)


# ---------------------------------------------------------------------------
# token trie over retained prefixes
# ---------------------------------------------------------------------------


class _TrieNode:
    __slots__ = ("children", "rids")

    def __init__(self):
        self.children: Dict[int, _TrieNode] = {}
        self.rids: set = set()


class PrefixTrie:
    """Token trie over the token sequences of the retained KV states.
    ``longest(tokens)`` returns the deepest node on ``tokens``'s path that
    a retained sequence passes through, with a donor rid whose KV covers it
    (slot j of a state holds token j, so any prefix of a donor's sequence
    can be cloned). One node per token."""

    def __init__(self):
        self._root = _TrieNode()
        # rid -> deepest node of its path: a chunk's retained sequence
        # extends the previous one, so put() grows the path by the chunk
        self._tails: Dict[str, _TrieNode] = {}

    def insert(self, rid: str, tokens: np.ndarray) -> None:
        node = self._root
        node.rids.add(rid)
        for t in tokens:
            node = node.children.setdefault(int(t), _TrieNode())
            node.rids.add(rid)
        self._tails[rid] = node

    def extend(self, rid: str, suffix: np.ndarray) -> bool:
        """Grow ``rid``'s path by ``suffix`` from its tail; False (a no-op)
        when ``rid`` has no tail."""
        node = self._tails.get(rid)
        if node is None:
            return False
        for t in suffix:
            node = node.children.setdefault(int(t), _TrieNode())
            node.rids.add(rid)
        self._tails[rid] = node
        return True

    def remove(self, rid: str, tokens: np.ndarray) -> None:
        self._tails.pop(rid, None)
        node = self._root
        node.rids.discard(rid)
        path = []
        for t in tokens:
            child = node.children.get(int(t))
            if child is None:
                return  # never inserted this far
            path.append((node, int(t), child))
            child.rids.discard(rid)
            node = child
        # prune the empty branches: the trie's size follows the live states
        for parent, tok, child in reversed(path):
            if not child.rids and not child.children:
                del parent.children[tok]

    def longest(self, tokens: Sequence[int]) -> Tuple[Optional[str], int]:
        node = self._root
        best: Tuple[Optional[str], int] = (None, 0)
        depth = 0
        for t in tokens:
            node = node.children.get(int(t))
            if node is None or not node.rids:
                break
            depth += 1
            best = (next(iter(node.rids)), depth)
        return best


# ---------------------------------------------------------------------------
# retained decode states: LRU, a byte budget and pins
# ---------------------------------------------------------------------------


class ReqState:
    """The retained decode state of one chunked request. ``tokens`` is the
    token sequence its KV covers (prompt + generated; the trie's key);
    ``pins`` counts the requests cloning from it, and eviction skips a
    pinned state."""

    __slots__ = ("state", "cur_len", "version", "last_used", "nbytes",
                 "tokens", "pins")

    def __init__(self, state, cur_len: int, version: int,
                 tokens: Optional[np.ndarray] = None):
        self.state = state  # single-row decode state (models/generate.py)
        self.cur_len = cur_len
        self.version = version
        self.last_used = time.monotonic()
        self.nbytes = state["kv_k"].nbytes + state["kv_v"].nbytes
        self.tokens = tokens
        self.pins = 0


class KVStateStore:
    """Retained decode states with LRU and KV-byte eviction, indexed by a
    prefix trie for cross-request seeding.

    Thread-safe: the runner thread puts, pops, evicts and walks the trie
    while ``/update_weights`` clears the store from a handler thread; every
    method holds one lock. A state's tensors are never written once stored
    (every derived state is a copy), so a clone taken before a clear stays
    valid."""

    def __init__(self, slots: int, bytes_budget: int,
                 prefix_reuse: bool = False):
        self.slots = slots
        self.bytes_budget = bytes_budget
        self.prefix_reuse = prefix_reuse
        self._states: Dict[str, ReqState] = {}
        self._trie = PrefixTrie()
        self._lock = threading.RLock()

    def get(self, rid: str) -> Optional[ReqState]:
        with self._lock:
            return self._states.get(rid)

    def put(self, rid: str, st: ReqState) -> None:
        with self._lock:
            old = self._states.get(rid)
            if (self.prefix_reuse and st.tokens is not None
                    and old is not None and old.tokens is not None
                    and len(old.tokens) <= len(st.tokens)
                    # a chunk's sequence extends the last one: grow the
                    # path by the new tokens instead of re-walking it
                    and np.array_equal(st.tokens[:len(old.tokens)],
                                       old.tokens)
                    and self._trie.extend(rid, st.tokens[len(old.tokens):])):
                self._states[rid] = st
                return
            self.pop(rid)  # the old path must not outlive its state
            self._states[rid] = st
            if self.prefix_reuse and st.tokens is not None:
                self._trie.insert(rid, st.tokens)

    def pop(self, rid: str) -> Optional[ReqState]:
        with self._lock:
            st = self._states.pop(rid, None)
            if st is not None and self.prefix_reuse \
                    and st.tokens is not None:
                self._trie.remove(rid, st.tokens)
            return st

    def clear(self) -> None:
        """Drop every retained state and the trie (a weight swap makes
        them stale)."""
        with self._lock:
            self._states.clear()
            self._trie = PrefixTrie()

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._states)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return sum(s.nbytes for s in self._states.values())

    def acquire_prefix(self, tokens: Sequence[int], version: int,
                       min_len: int = 1) -> Optional[Tuple[str, int]]:
        """The longest retained prefix of ``tokens`` at weight ``version``:
        ``(rid, shared_len)`` with the donor pinned (the caller must
        :meth:`release` it). The shared length is clamped to
        ``len(tokens) - 1`` unless the donor's state ends exactly at
        ``len(tokens)``: a full match carries the logits the prompt needs,
        a partial one must recompute them from >= 1 suffix token."""
        if not self.prefix_reuse:
            return None
        with self._lock:
            rid, depth = self._trie.longest(tokens)
            if rid is None:
                return None
            st = self._states.get(rid)
            if st is None or st.version != version:
                return None
            shared = min(depth, st.cur_len, len(tokens))
            if shared == len(tokens) and st.cur_len != shared:
                shared -= 1
            if shared < max(min_len, 1):
                return None
            st.pins += 1
            st.last_used = time.monotonic()
            return rid, shared

    def release(self, rid: str) -> None:
        with self._lock:
            st = self._states.get(rid)
            if st is not None and st.pins > 0:
                st.pins -= 1

    def evict(self) -> int:
        """LRU-evict down to the slot and byte budgets, never a pinned
        state (a clone in flight reads it). Returns the number evicted."""
        with self._lock:
            if self.slots <= 0:
                n = self.count
                self.clear()
                return n
            n_evicted = 0
            total = self.nbytes
            while len(self._states) > self.slots or (
                    total > self.bytes_budget and self._states):
                victims = [(st.last_used, rid)
                           for rid, st in self._states.items() if st.pins == 0]
                if not victims:
                    break  # everything pinned: the budgets yield
                _, rid = min(victims)
                total -= self._states[rid].nbytes
                self.pop(rid)
                n_evicted += 1
            return n_evicted


# ---------------------------------------------------------------------------
# admission and priority batches
# ---------------------------------------------------------------------------


class ServingQueue:
    """Per-class bounded queues with a priority drain, for handler threads
    and one runner thread.

    Disabled, it is one unbounded FIFO across classes (the default
    server's queue). Enabled, it admits per class up to the class's limit
    (else :class:`AdmissionReject`) and pops in :data:`REQUEST_CLASSES`
    order, FIFO within a class. The limit check, the append and the drain
    hold one lock; :meth:`get` blocks on its condition until a request
    arrives or the queue is closed."""

    def __init__(self, cfg: ServingConfig):
        self.cfg = cfg
        self._queues: Dict[str, deque] = {c: deque() for c in REQUEST_CLASSES}
        self._fifo: deque = deque()  # disabled: arrival order
        self._cond = threading.Condition(threading.Lock())
        self._closed = False

    def _limit(self, cls: str) -> int:
        return int(getattr(self.cfg, f"queue_limit_{cls}", 0))

    def _size(self) -> int:
        if not self.cfg.enabled:
            return len(self._fifo)
        return sum(len(q) for q in self._queues.values())

    def depth(self, cls: str) -> int:
        with self._cond:
            return (len(self._queues[cls]) if self.cfg.enabled
                    else len(self._fifo))

    def qsize(self) -> int:
        with self._cond:
            return self._size()

    def empty(self) -> bool:
        return self.qsize() == 0

    def put(self, pending, cls: str = "rollout") -> None:
        """Admit or raise, atomically. After :meth:`close` it raises
        RuntimeError."""
        with self._cond:
            if self._closed:
                raise RuntimeError("serving queue closed")
            if not self.cfg.enabled:
                self._fifo.append(pending)
            else:
                limit = self._limit(cls)
                q = self._queues[cls]
                if limit > 0 and len(q) >= limit:
                    raise AdmissionReject(cls, len(q), limit,
                                          self.cfg.retry_after_secs)
                q.append(pending)
            self._cond.notify()

    def close(self) -> None:
        """Stop admitting and wake the runner: :meth:`get` returns the
        requests still queued, then None. Not subject to any limit or to
        the priority order."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def _pop(self):
        if not self.cfg.enabled:
            return self._fifo.popleft() if self._fifo else None
        for cls in REQUEST_CLASSES:
            if self._queues[cls]:
                return self._queues[cls].popleft()
        return None

    def get(self):
        """The next request in priority order, blocking until one arrives;
        None once the queue is closed and empty."""
        with self._cond:
            self._cond.wait_for(lambda: self._size() or self._closed)
            return self._pop()

    def get_nowait(self):
        with self._cond:
            p = self._pop()
        if p is None:
            raise IndexError("serving queue empty")
        return p

    def drain(self, max_n: int) -> list:
        """Up to ``max_n`` more requests in priority order, without
        blocking. While rollouts wait, ``min_rollout_share`` of the batch is
        theirs: strict priority alone lets sustained interactive load starve
        them while every latency objective looks healthy."""
        with self._cond:
            out = []
            reserve = 0
            if self.cfg.enabled and max_n > 0:
                share = min(max(float(self.cfg.min_rollout_share), 0.0), 1.0)
                if share > 0 and self._queues["rollout"]:
                    reserve = min(len(self._queues["rollout"]),
                                  max(1, int(max_n * share)))
            while len(out) < max_n - reserve:
                p = self._pop()
                if p is None:
                    break
                out.append(p)
            # the priority loop may have drained rollout already
            while reserve > 0 and self._queues["rollout"]:
                out.append(self._queues["rollout"].popleft())
                reserve -= 1
            return out


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class ServingEngine:
    """The (queue, KV store, shape policy, latency metrics) bundle the
    generation server delegates its scheduling to."""

    def __init__(self, cfg: ServingConfig, *, kv_slots: int,
                 kv_bytes_budget: int, kv_bucket: int, chunk_tokens: int,
                 max_batch_size: int, prompt_bucket: int = 1,
                 telemetry=None):
        self.cfg = cfg
        self.prompt_bucket = max(int(prompt_bucket), 1)
        self.telemetry = (telemetry if telemetry is not None
                          else telemetry_mod.NULL)
        self.queue = ServingQueue(cfg)
        self.kv = KVStateStore(kv_slots, kv_bytes_budget,
                               prefix_reuse=cfg.enabled and cfg.prefix_reuse)
        self.shapes = policy_from_config(
            cfg, kv_bucket=kv_bucket, chunk_tokens=chunk_tokens,
            max_batch_size=max_batch_size, prompt_bucket=self.prompt_bucket)

    def admit(self, pending, cls: str, prompt_len: int,
              planned_len: Optional[int] = None) -> None:
        """Admit one request or raise: capacity first (413, permanent), then
        the class's queue bound (429, backpressure), then enqueue.
        ``planned_len`` (prompt + the client's whole remaining budget)
        rejects a generation that could never finish up front instead of
        at the capacity ceiling mid-flight."""
        if self.cfg.enabled:
            try:
                # the widest admission a chunked generation reaches is its
                # last chunk's: planned - 1 without EOS; judged on the
                # bucketed width the prefill will pad to
                check_len = max(prompt_len, (planned_len or 0) - 1)
                w = self.shapes.round_width(
                    round_up(check_len, self.prompt_bucket))
                # derived width buckets top out at capacity - min chunk;
                # a policy built without them is checked here
                if self.shapes.width_buckets is None \
                        and not self.shapes.fits(w + 1):
                    raise PromptTooLong(w + 1,
                                        self.shapes.capacity_buckets[-1])
            except PromptTooLong:
                self.telemetry.inc(f"serving/{cls}/too_long")
                raise
        try:
            self.queue.put(pending, cls)
        except AdmissionReject:
            self.telemetry.inc(f"serving/{cls}/rejected")
            raise
        self.telemetry.inc(f"serving/{cls}/admitted")

    def record_queue_wait(self, cls: str, secs: float, trace=None,
                          t_start_wall: float = 0.0) -> None:
        self.telemetry.observe(f"serving/{cls}/queue_wait_secs", secs)
        if trace is not None:
            # the request's queue stage, under the caller's trace
            self.telemetry.add_span("genserver/queue_wait", t_start_wall,
                                    secs, trace=trace, cls=cls)

    def record_first_chunk(self, cls: str, secs: float) -> None:
        self.telemetry.observe(f"serving/{cls}/ttfc_secs", secs)

    def record_token_latency(self, cls: str, secs: float) -> None:
        self.telemetry.observe(
            f"serving/{cls}/token_secs", secs,
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5))

    def export_gauges(self) -> None:
        t = self.telemetry
        t.set_gauge("serving/compiled_shapes", self.shapes.distinct_shapes)
        t.set_gauge("genserver/kv_states", self.kv.count)
        t.set_gauge("genserver/kv_bytes", self.kv.nbytes)
        if self.cfg.enabled:
            for cls in REQUEST_CLASSES:
                t.set_gauge(f"serving/{cls}/queue_depth",
                            self.queue.depth(cls))
