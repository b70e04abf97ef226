"""Ring attention: context parallelism over the mesh's ``sp`` axis.

The port's counterpart of ``areal_tpu/parallel/ring.py``. The sequence of
a packed row is cut into ``n`` shards, one per ring rank; each rank keeps
its queries and passes its key/value block around the ring, so after
``n`` steps every query has seen every block. Two schedules, as in the
reference:

 - ``zigzag`` (the default): the row splits into ``2n`` chunks of ``c =
   T/2n`` and rank ``r`` holds chunks ``r`` (early) and ``2n-1-r`` (late),
   so the causal work balances across the ring. Step 0 is **one causal
   K1 call** on the local shard: the local layout keeps global order, so
   K1's causal-by-index rule on local indices is the global causal mask.
   Every later step runs exactly two fully visible ``c × c`` tiles with
   ``causal=False`` under the segment mask alone: ``q_late × kv_early``
   always, and ``q_early × kv_early`` when the block came from a lower
   rank (``src < my``), else ``q_late × kv_late``. Executed area
   ``(n+1)/2n`` of the naive schedule's;
 - ``naive`` (the oracle): contiguous shards; the resident block through
   a causal K1 call, each block from a lower rank through a non-causal
   one. Blocks from a higher rank lie wholly in the causal future and are
   not launched (the reference computes them under a full mask).

**Block compute is the port's own kernels** (``ops/flash_attention.py``),
where the reference's blocks are XLA einsums: K1 with ``return_lse=True``
forward, the partial results merged on their logsumexp in float32; the
backward (:class:`_RingAttention`) runs K3 and K2 per tile, each call fed
the merged output's logsumexp and ``di = rowsum(dO * O)``. dq sums over
the tiles; dk/dv travel with their kv block and come back to the rank
that owns it. On CPU tensors K1-K3's plain versions run; on a CUDA tensor
the kernels launch, and the ring never falls back to plain attention.

**Communication.** One per-rank body (:func:`_fwd_rank`, :func:`_bwd_rank`)
runs over a small ring interface with two implementations:

 - :class:`_P2PRing`, over the ``sp`` process group
   (``dist.batch_isend_irecv``): rank ``r`` sends to ``r+1`` and receives
   from ``r-1``; the next block's rotation is started before the current
   block's compute, and the dk/dv accumulators make one more hop home;
 - :class:`_LocalRing`, one process holding all ``n`` shards on one
   device, rotating by re-indexing: the ranks' bodies run one after
   another. It is what runs on a single card, and a CPU cross-check of
   the multi-rank path.

A :class:`RingCtx` names which: ``group`` set means this process is one
rank and holds one local shard; ``group=None`` means one process holds
every shard, concatenated in zig-zag order along the sequence.

Masking: same nonzero segment id, and causal by index (packing keeps each
document contiguous, so index order is document order). Pad rows (segment
0) come out as zeros with logsumexp ``-inf`` and zero gradients.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch.ops import flash_attention as fa

SCHEDULES = ("zigzag", "naive")

# Structural counters, bumped where a block is handed to K1 (plain Python,
# so tests can prove the schedule's skip): ``block_calls`` counts K1 calls
# of the ring's forward, ``executed_area`` the q×kv cells handed to them,
# ``naive_area`` what the contiguous schedule would run (n · Tl² a rank).
# They count every rank this process runs (all n for a one-process ring);
# the reference's count the one rank body it traces. ``noncausal_calls``
# (the port's own) counts the K1 calls with ``causal=False``.
_COUNTERS: Dict[str, int] = {
    "block_calls": 0, "executed_area": 0, "naive_area": 0,
    "noncausal_calls": 0,
}


def reset_ring_counters() -> None:
    for k in _COUNTERS:
        _COUNTERS[k] = 0


def ring_counters() -> Dict[str, int]:
    return dict(_COUNTERS)


def ring_skip_ratio() -> float:
    """executed/naive attention area of every ring forward since the last
    reset: (n+1)/2n for zig-zag at ring size n (and for the port's naive
    schedule too, which launches no fully masked block)."""
    if not _COUNTERS["naive_area"]:
        return 1.0
    return _COUNTERS["executed_area"] / _COUNTERS["naive_area"]


def resolve_schedule(schedule: Optional[str], seq_len: int, n: int,
                     causal: bool = True) -> str:
    """The schedule actually run: explicit arg > ``AREAL_RING_SCHEDULE`` >
    "zigzag"; downgrades to "naive" when zig-zag can't apply (non-causal
    attention skips nothing; the layout needs ``T % 2n == 0``)."""
    if schedule is None:
        schedule = os.environ.get("AREAL_RING_SCHEDULE", "zigzag")
    if schedule not in SCHEDULES:
        raise ValueError(
            f"unknown ring schedule {schedule!r} (one of {SCHEDULES})"
        )
    if schedule == "zigzag" and (not causal or n < 2 or seq_len % (2 * n)):
        schedule = "naive"
    return schedule


def zigzag_permutation(seq_len: int, n: int) -> np.ndarray:
    """Gather indices mapping the natural sequence order to the zig-zag
    shard layout: position block ``r`` of the permuted sequence holds
    chunks ``(r, 2n-1-r)`` of the original. Invert with
    :func:`inverse_permutation`."""
    assert seq_len % (2 * n) == 0, (seq_len, n)
    c = seq_len // (2 * n)
    idx = [
        np.arange(r * c, (r + 1) * c)
        for rank in range(n)
        for r in (rank, 2 * n - 1 - rank)
    ]
    return np.concatenate(idx)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return inv


@dataclass(frozen=True)
class RingCtx:
    """Where a ring runs: ``n`` ranks, this process's rank ``my`` (unused
    when one process holds every shard), the schedule, and the ``sp``
    process group (None: a one-process ring over all ``n`` shards)."""
    n: int
    my: int = 0
    schedule: str = "zigzag"
    group: Any = None

    @property
    def one_process(self) -> bool:
        return self.group is None


def ring_eligible(mesh, cfg, batch: int, seq_len: int) -> bool:
    """Whether the shapes admit ring attention on this mesh (a
    ``DeviceMesh`` or a ``ParallelSpec``): a ring of two or more, no
    sliding window (not ring-expressible), a sequence that shards over the
    ring and heads that split over ``tp``. The port's data axes split
    micro-batches, not rows, so ``batch`` needs no divisor here."""
    n = mesh_axis(mesh, "sp")
    if n <= 1:
        return False
    tp = mesh_axis(mesh, "tp")
    return (
        cfg.sliding_window is None
        and batch > 0
        and seq_len % n == 0
        and cfg.n_q_heads % tp == 0
        and (cfg.n_kv_heads % tp == 0 or tp % cfg.n_kv_heads == 0)
    )


def mesh_axis(mesh, axis: str) -> int:
    """The degree of ``axis`` on a ``DeviceMesh``, a ``ParallelSpec`` or
    None (1)."""
    if mesh is None:
        return 1
    if hasattr(mesh, "mesh_dim_names"):
        from areal_tpu_torch.parallel.mesh import AXIS_ORDER

        return mesh.size(AXIS_ORDER.index(axis))
    return getattr(mesh, axis)


# ---------------- the sequence layout at the model boundary ----------------

def _layout(T: int, ctx: RingCtx, device) -> Optional[torch.Tensor]:
    """Gather indices of the ring's layout (None for the naive schedule's
    natural order)."""
    if ctx.schedule != "zigzag":
        return None
    return torch.from_numpy(zigzag_permutation(T, ctx.n)).to(device)


def shard_sequence(x: torch.Tensor, ctx: RingCtx) -> torch.Tensor:
    """``x [B, T, ...]`` in natural order → the ring's layout: this rank's
    shard ``[B, T/n, ...]`` (the zig-zag chunk pair, or the contiguous
    shard), or every shard concatenated for a one-process ring."""
    perm = _layout(x.shape[1], ctx, x.device)
    if perm is not None:
        x = x.index_select(1, perm)
    if ctx.one_process:
        return x
    Tl = x.shape[1] // ctx.n
    return x[:, ctx.my * Tl:(ctx.my + 1) * Tl]


def unshard_sequence(x: torch.Tensor, ctx: RingCtx) -> torch.Tensor:
    """The inverse of :func:`shard_sequence` for a one-process ring:
    every shard in the ring's layout → natural order."""
    assert ctx.one_process
    perm = _layout(x.shape[1], ctx, x.device)
    if perm is None:
        return x
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device=perm.device)
    return x.index_select(1, inv)


class _GatherSequence(torch.autograd.Function):
    """This rank's shard → the whole sequence in natural order on every
    rank of the ring (an all-gather over ``sp``). Every rank then computes
    the same function of the whole; the backward keeps this rank's slice
    of that (identical) gradient."""

    @staticmethod
    def forward(ctx, x, rctx):
        import torch.distributed as dist

        ctx.rctx = rctx
        parts = [torch.empty_like(x) for _ in range(rctx.n)]
        dist.all_gather(parts, x.contiguous(), group=rctx.group)
        whole = torch.cat(parts, dim=1)
        perm = _layout(whole.shape[1], rctx, whole.device)
        if perm is not None:
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(perm.numel(), device=perm.device)
            whole = whole.index_select(1, inv)
        return whole

    @staticmethod
    def backward(ctx, g):
        return shard_sequence(g, ctx.rctx).contiguous(), None


def gather_sequence(x: torch.Tensor, ctx: RingCtx) -> torch.Tensor:
    """A per-token result of this rank's shard (``[B, T/n, ...]``) → the
    whole row in natural order, differentiable (see
    :class:`_GatherSequence`); for a one-process ring, the layout undone."""
    if ctx.one_process:
        return unshard_sequence(x, ctx)
    return _GatherSequence.apply(x, ctx)


# ---------------- the ring interface ----------------

class _LocalRing:
    """All ``n`` shards in one process: the block visiting rank ``my`` at
    step ``i`` is shard ``(my - i) % n``, read by index; each rank's dk/dv
    contributions land in the owner's accumulator at once."""

    def __init__(self, kv_shards: List[tuple], my: int, store=None):
        self.kv = kv_shards
        self.n = len(kv_shards)
        self.my = my
        self.store = store  # owner -> [dk, dv] f32 accumulators

    def visits(self):
        for i in range(self.n):
            src = (self.my - i) % self.n
            yield i, src, self.kv[src]

    def deposit(self, src: int, grads) -> None:
        if grads is None:
            return
        acc = self.store[src]
        for a, g in zip(acc, grads):
            a.add_(g)


class _P2PRing:
    """One rank of the ring over the ``sp`` group: blocks rotate from rank
    ``r`` to ``r+1``. The rotation for step ``i+1`` is started before step
    ``i``'s block is handed out, so the transfer overlaps its compute. In
    the backward the dk/dv accumulators of the visiting block travel with
    it, one hop after each step: after the last step they reach their
    owner."""

    def __init__(self, ctx: RingCtx):
        import torch.distributed as dist

        ranks = dist.get_process_group_ranks(ctx.group)
        self.n, self.my, self.group = ctx.n, ctx.my, ctx.group
        self.next = ranks[(ctx.my + 1) % ctx.n]
        self.prev = ranks[(ctx.my - 1) % ctx.n]
        self.acc = None

    def _rotate(self, tensors):
        import torch.distributed as dist

        recv = [torch.empty_like(t) for t in tensors]
        ops = [dist.P2POp(dist.isend, t.contiguous(), self.next, self.group)
               for t in tensors]
        ops += [dist.P2POp(dist.irecv, r, self.prev, self.group)
                for r in recv]
        return dist.batch_isend_irecv(ops), recv

    @staticmethod
    def _wait(pending):
        reqs, recv = pending
        for r in reqs:
            r.wait()
        return recv

    def visits(self, block):
        cur = tuple(block)
        for i in range(self.n):
            pending = self._rotate(cur) if i + 1 < self.n else None
            yield i, (self.my - i) % self.n, cur
            if pending is not None:
                cur = tuple(self._wait(pending))

    def deposit(self, src: int, grads) -> None:
        """Add this step's dk/dv for the visiting block (None: none) to
        its travelling accumulators and pass them on."""
        if self.acc is None:
            raise RuntimeError("start_grads first")
        if grads is not None:
            for a, g in zip(self.acc, grads):
                a.add_(g)
        self.acc = self._wait(self._rotate(self.acc))

    def start_grads(self, like: tuple) -> None:
        self.acc = [torch.zeros(t.shape, dtype=torch.float32,
                                device=t.device) for t in like]

    def collect(self):
        """This rank's own block's dk/dv, home after the last hop."""
        return self.acc


# ---------------- the per-rank bodies ----------------

def _k1(q, k, v, sq, sk, causal: bool, scale: float):
    """One K1 block (the plain version on the CPU), counted."""
    _COUNTERS["block_calls"] += 1
    _COUNTERS["noncausal_calls"] += not causal
    _COUNTERS["executed_area"] += int(q.shape[1]) * int(k.shape[1])
    return fa.flash_attention(q, k, v, sq, sk, causal=causal, scale=scale,
                              return_lse=True)


def _merge(a, b):
    """Two partial results ``(out [B, T, H, D], lse [B, H, T])`` over
    disjoint key sets merged on their logsumexp in float32. A row that saw
    no key in either keeps out 0 and lse ``-inf``, with no NaN."""
    if a is None:
        return b[0].float(), b[1]
    (oa, la), (ob, lb) = a, b
    m = torch.maximum(la, lb)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    wa, wb = torch.exp(la - m), torch.exp(lb - m)
    s = wa + wb
    lse = torch.where(s > 0, m + torch.log(s), torch.full_like(s, -np.inf))
    inv = torch.where(s > 0, 1.0 / s, torch.zeros_like(s))
    ca = (wa * inv).transpose(1, 2)[..., None]
    cb = (wb * inv).transpose(1, 2)[..., None]
    return oa * ca + ob.float() * cb, lse


def _halves(x, c):
    return x[:, :c].contiguous(), x[:, c:].contiguous()


def _fwd_rank(q, seg, ring, n: int, my: int, schedule: str, causal: bool,
              scale: float, block=None):
    """One rank's forward over ``ring``: ``(out, lse)`` of its queries
    against every block. ``block`` is the rank's own ``(k, v, seg)`` (the
    P2P ring starts from it; the local ring reads every shard itself)."""
    B, Tl = q.shape[:2]
    _COUNTERS["naive_area"] += n * Tl * Tl
    visits = ring.visits(block) if block is not None else ring.visits()
    if schedule == "zigzag":
        c = Tl // 2
        q_e, q_l = _halves(q, c)
        s_e, s_l = _halves(seg, c)
        acc_e = acc_l = None
        for i, src, (kb, vb, sb) in visits:
            if i == 0:
                o, lse = _k1(q, kb, vb, seg, sb, True, scale)
                acc_e = (o[:, :c].float(), lse[..., :c])
                acc_l = (o[:, c:].float(), lse[..., c:])
                continue
            k_e, k_l = _halves(kb, c)
            v_e, v_l = _halves(vb, c)
            sb_e, sb_l = _halves(sb, c)
            acc_l = _merge(acc_l, _k1(q_l, k_e, v_e, s_l, sb_e, False, scale))
            if src < my:
                acc_e = _merge(acc_e, _k1(q_e, k_e, v_e, s_e, sb_e, False,
                                          scale))
            else:
                acc_l = _merge(acc_l, _k1(q_l, k_l, v_l, s_l, sb_l, False,
                                          scale))
        out = torch.cat([acc_e[0], acc_l[0]], dim=1)
        lse = torch.cat([acc_e[1], acc_l[1]], dim=-1)
        return out.to(q.dtype), lse.contiguous()
    acc = None
    for i, src, (kb, vb, sb) in visits:
        if i == 0:
            acc = _merge(None, _k1(q, kb, vb, seg, sb, causal, scale))
        elif src < my or not causal:
            acc = _merge(acc, _k1(q, kb, vb, seg, sb, False, scale))
    return acc[0].to(q.dtype), acc[1].contiguous()


def _tile_bwd(q, k, v, sq, sk, out, dout, lse, di, causal: bool,
              scale: float):
    """dq, dk, dv of one tile under the merged ``lse`` and ``di``: K3 and
    K2 on CUDA tensors, their plain version on the CPU."""
    if q.device.type == "cpu":
        return fa.flash_attention_bwd_plain(q, k, v, sq, sk, out, lse, dout,
                                            causal, scale)
    args = (q, k, v, sq, sk, dout, lse, di, causal, scale)
    return (fa.launch_bwd_dq(*args), *fa.launch_bwd_dkv(*args))


def _bwd_rank(q, seg, out, lse, dout, ring, n: int, my: int, schedule: str,
              causal: bool, scale: float, block=None):
    """One rank's backward over ``ring``: returns dq (float32); each
    block's dk/dv go to ``ring.deposit``. The tiles are the forward's."""
    di = fa.backward_di(out, dout)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    visits = ring.visits(block) if block is not None else ring.visits()
    if schedule == "zigzag":
        c = q.shape[1] // 2
        rows = {"e": slice(0, c), "l": slice(c, 2 * c)}
        part = {h: tuple(x[:, r].contiguous() for x in (q, seg, out, dout))
                + (lse[..., r].contiguous(), di[..., r].contiguous())
                for h, r in rows.items()}
        for i, src, (kb, vb, sb) in visits:
            if i == 0:
                dq_t, dk_t, dv_t = _tile_bwd(q, kb, vb, seg, sb, out, dout,
                                             lse, di, True, scale)
                dq += dq_t
                ring.deposit(src, (dk_t, dv_t))
                continue
            dk = torch.zeros(kb.shape, dtype=torch.float32, device=kb.device)
            dv = torch.zeros_like(dk)
            kv = {h: (kb[:, r].contiguous(), vb[:, r].contiguous(),
                      sb[:, r].contiguous()) for h, r in rows.items()}
            pairs = [("l", "e"), ("e", "e") if src < my else ("l", "l")]
            for qh, kh in pairs:
                qt, st, ot, dt, lt, it = part[qh]
                kt, vt, skt = kv[kh]
                dq_t, dk_t, dv_t = _tile_bwd(qt, kt, vt, st, skt, ot, dt, lt,
                                             it, False, scale)
                dq[:, rows[qh]] += dq_t
                dk[:, rows[kh]] += dk_t
                dv[:, rows[kh]] += dv_t
            ring.deposit(src, (dk, dv))
        return dq
    for i, src, (kb, vb, sb) in visits:
        if i == 0 or src < my or not causal:
            dq_t, dk_t, dv_t = _tile_bwd(q, kb, vb, seg, sb, out, dout, lse,
                                         di, causal and i == 0, scale)
            dq += dq_t
            ring.deposit(src, (dk_t, dv_t))
        else:
            ring.deposit(src, None)
    return dq


# ---------------- the differentiable ring ----------------

def _split(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    return [t.contiguous() for t in x.chunk(n, dim=1)]


def _ring_fwd(q, k, v, seg, ctx: RingCtx, causal: bool, scale: float):
    if not ctx.one_process:
        ring = _P2PRing(ctx)
        return _fwd_rank(q, seg, ring, ctx.n, ctx.my, ctx.schedule, causal,
                         scale, block=(k, v, seg))
    qs, segs = _split(q, ctx.n), _split(seg, ctx.n)
    kv = list(zip(_split(k, ctx.n), _split(v, ctx.n), segs))
    outs, lses = [], []
    for r in range(ctx.n):
        o, lse = _fwd_rank(qs[r], segs[r], _LocalRing(kv, r), ctx.n, r,
                           ctx.schedule, causal, scale)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=-1)


def _ring_bwd(q, k, v, seg, out, lse, dout, ctx: RingCtx, causal: bool,
              scale: float):
    if not ctx.one_process:
        ring = _P2PRing(ctx)
        ring.start_grads((k, v))
        dq = _bwd_rank(q, seg, out, lse, dout, ring, ctx.n, ctx.my,
                       ctx.schedule, causal, scale, block=(k, v, seg))
        dk, dv = ring.collect()
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    n = ctx.n
    qs, segs = _split(q, n), _split(seg, n)
    outs, douts = _split(out, n), _split(dout, n)
    lses = [t.contiguous() for t in lse.chunk(n, dim=-1)]
    ks, vs = _split(k, n), _split(v, n)
    kv = list(zip(ks, vs, segs))
    store = [[torch.zeros(t.shape, dtype=torch.float32, device=t.device)
              for t in (ks[r], vs[r])] for r in range(n)]
    dqs = [_bwd_rank(qs[r], segs[r], outs[r], lses[r], douts[r],
                     _LocalRing(kv, r, store), n, r, ctx.schedule, causal,
                     scale) for r in range(n)]
    return (torch.cat(dqs, dim=1).to(q.dtype),
            torch.cat([s[0] for s in store], dim=1).to(k.dtype),
            torch.cat([s[1] for s in store], dim=1).to(v.dtype))


class _RingAttention(torch.autograd.Function):
    """The ring as one differentiable op over the ring's layout: K1 blocks
    forward, K3/K2 tiles backward (:func:`_bwd_rank`). Saves q, k, v, the
    segment ids, the merged out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, seg, rctx, causal, scale):
        out, lse = _ring_fwd(q, k, v, seg, rctx, causal, scale)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.rctx, ctx.causal, ctx.scale = rctx, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, seg, out, lse, dout.contiguous(),
                               ctx.rctx, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def ring_attention_inline(q, k, v, segment_ids, ctx: RingCtx,
                          causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over tensors already in the ring's layout
    (:func:`shard_sequence`): this rank's shard ``[B, T/n, ...]``, or every
    shard along the sequence for a one-process ring. Differentiable."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    seg = segment_ids.to(torch.int32).contiguous()
    q, k, v = (x.contiguous() for x in (q, k, v))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _RingAttention.apply(q, k, v, seg, ctx, causal, scale)
    return _ring_fwd(q, k, v, seg, ctx, causal, scale)[0]


def ring_attention(
    q: torch.Tensor,  # [B, T, Hq, D], natural order
    k: torch.Tensor,  # [B, T, Hkv, D]
    v: torch.Tensor,
    segment_ids: torch.Tensor,  # [B, T]
    n: int,
    causal: bool = True,
    scale: Optional[float] = None,
    schedule: Optional[str] = None,  # None → AREAL_RING_SCHEDULE → "zigzag"
) -> torch.Tensor:
    """Context-parallel attention over a one-process ring of ``n`` ranks
    on whole rows: the layout applied at the boundary and undone on the
    way out, so callers see plain packed attention."""
    ctx = RingCtx(n=n, schedule=resolve_schedule(schedule, q.shape[1], n,
                                                 causal))
    q, k, v, seg = (shard_sequence(x, ctx) for x in (q, k, v, segment_ids))
    out = ring_attention_inline(q, k, v, seg, ctx, causal, scale)
    return unshard_sequence(out, ctx)
