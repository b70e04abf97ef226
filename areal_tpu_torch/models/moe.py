"""Mixture-of-Experts layer: top-k routing with a sort-based grouped
expert compute, and the one-hot einsum dispatch kept as its oracle.

Counterpart of ``areal_tpu/models/moe.py`` (``resolve_dispatch:58``,
``capacity:70``, ``_routing:95``, ``_capacity_keep:153``,
``_expert_ffn:166``, ``_dispatch_einsum:176``, ``_grouped_matmul:207``,
``_dispatch_grouped:230``, ``ep_eligible:75``, ``_dispatch_ep:281``,
``moe_mlp:370``). Both dispatches share the
router and its balancing statistics and apply the same Switch-style
capacity rule (priority is token order, then choice order), so their
outputs and gradients agree, drops and padding included.

The grouped dispatch stable-sorts the ``N·k`` (token, choice) entries by
expert id and runs the expert MLP as grouped GEMMs over the contiguous
per-expert segments. The reference's ``ragged_dot`` becomes
:func:`grouped_matmul`: one matmul per non-empty segment, after one host
read of the segment sizes per layer. The gathers are permutations, so
forward and backward are deterministic; rows past the last segment (the
padding entries, sorted to the tail) come out as exact zeros.

Layer weights, as the port's ``Block`` holds them: ``router [E, D]`` (an
``nn.Linear`` weight), ``e_gate``/``e_up [E, D, F]`` and ``e_down [E, F,
D]`` in the reference's ``[in, out]`` layout, and the optional shared expert
``s_gate``/``s_up [Fs, D]``, ``s_down [D, Fs]`` (``nn.Linear`` weights).

Expert parallelism (``_dispatch_ep:281``, GShard §3.2): :func:`moe_mlp`
given an :class:`ExpertCtx` runs :func:`dispatch_ep`. Each *source* routes
its own tokens into capacity buffers ``[E, C, D]`` with ``C =
capacity(N_source)`` (priority by token order, then choice order); an
exchange hands each block of ``E/ep`` experts to its owner, which runs the
batched expert MLP (``_expert_ffn:166``) on its ``[E/ep, Σ C, D]`` rows,
grouped by source; the inverse exchange returns the rows and each source
combines its own tokens. Two transports, as ``parallel/ring.py`` has: an
``ep`` process group (``all_to_all_single`` in an autograd function whose
backward is the inverse exchange; the per-source C are exchanged first, so
sources may differ in size), or one process holding every source, whose
exchange is a local re-indexing (what the card runs). Under tensor
parallelism the owner's ``e_down`` partial sums are summed over ``tp``
before the combine (``sharding.constrain``).

Sequence parallelism (a multi-rank ``parallel/ring.py RingCtx``): each
rank holds its zig-zag shard of every row, and the layer computes what the
reference computes on the whole row in natural order. The routing indices
(``N·k`` ints, not activations) are gathered over ``sp`` and the capacity
slots taken in natural order: one source per micro-batch without ``ep``,
the contiguous ``T/sp`` chunks with it (the reference's ``P(DATA_AXES,
"sp")`` sources); the balancing statistics and the drop counts are summed
over ``sp``. A one-process ring hands the layer every shard: it runs in
natural order and returns the ring's layout.

Router input jitter draws from the ``torch.Generator`` it is given, not from
the reference's PRNG key: the two agree in distribution (uniform in ``[1 -
eps, 1 + eps]``), not in their draws.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from areal_tpu_torch.models.config import MoEConfig
from areal_tpu_torch.parallel import ring as ring_mod
from areal_tpu_torch.parallel.sharding import constrain

DISPATCH_METHODS = ("grouped", "einsum")

Params = Dict[str, torch.Tensor]


def resolve_dispatch(method: Optional[str] = None) -> str:
    """The dispatch actually run: explicit argument > ``AREAL_MOE_DISPATCH``
    > "grouped". "einsum" is the GShard one-hot oracle."""
    if method is None:
        method = os.environ.get("AREAL_MOE_DISPATCH", "").strip() or "grouped"
    if method not in DISPATCH_METHODS:
        raise ValueError(
            f"unknown MoE dispatch {method!r} (one of {DISPATCH_METHODS})")
    return method


def capacity(n_tokens: int, moe: MoEConfig) -> int:
    """Slots per expert: ``ceil(top_k · n_tokens · capacity_factor / E)``,
    at least 1. ``n_tokens`` is the whole ``B·T`` grid, pads included."""
    c = math.ceil(moe.top_k * n_tokens * moe.capacity_factor / moe.num_experts)
    return max(int(c), 1)


def ep_eligible(mesh=None, moe: Optional[MoEConfig] = None, batch: int = 0,
                seq_len: int = 1) -> bool:
    """Whether the expert-parallel path can run (the reference's answers):
    an "ep" axis above 1 on ``mesh`` (a ``DeviceMesh`` or a
    ``ParallelSpec``), experts that divide over it, and a batch and a
    sequence that divide their axes (``dp·fsdp·ep`` rows, ``sp``
    columns), as the reference's sources are exact blocks."""
    from areal_tpu_torch.parallel.ring import mesh_axis

    if mesh is None or moe is None:
        return False
    ep = mesh_axis(mesh, "ep")
    if ep <= 1 or moe.num_experts % ep:
        return False
    rows = mesh_axis(mesh, "dp") * mesh_axis(mesh, "fsdp") * ep
    return batch % rows == 0 and seq_len % mesh_axis(mesh, "sp") == 0


@dataclass(frozen=True)
class ExpertCtx:
    """Where expert parallelism runs: ``ep`` owners of ``E/ep`` experts.

    ``group`` set: this process is one source (its tokens) and owner
    ``rank`` of the ``ep`` process group, holding experts ``[rank·E/ep,
    (rank+1)·E/ep)``. ``group=None``: one process holds every source and
    every owner; each micro-batch's rows split into ``ep`` sources, as the
    reference's ``shard_map`` splits them. A process of the group holds
    micro-batches of its own (the port's data ranks, ROADMAP.md's accepted
    differences): its balancing statistics and drop counts are its own
    tokens' (summed over the ``sp`` ring where one runs)."""
    ep: int
    rank: int = 0
    group: Any = None

    @property
    def one_process(self) -> bool:
        return self.group is None


class _SumOver(torch.autograd.Function):
    """A sum over a process group; the backward is the identity (each
    process's share of the summed statistic takes the gradient of the
    whole, so the gradients, summed over the group later, count it
    once)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumOver.apply(x, group)


# ---------------- router + balancing stats (both paths) ----------------

def _routing(xf: torch.Tensor, lp: Params, moe: MoEConfig,
             rng: Optional[torch.Generator], valid: torch.Tensor,
             group=None):
    """Returns (top_p [N, k] gates after the optional renorm, top_i [N, k],
    onehot [N, k, E] f32 with pad rows zeroed, aux without dropped_frac).
    ``group``: the ``sp`` ring holding the rest of the micro-batch's
    tokens; the statistics' sums run over it (:class:`_SumOver`)."""
    E, k = moe.num_experts, moe.top_k
    n_valid = _sum_over(valid.sum(), group).clamp_min(1.0)

    router_in = xf
    if moe.input_jitter_eps > 0 and rng is not None:
        # Training only: inference passes no generator and routes on the
        # clean input.
        eps = moe.input_jitter_eps
        noise = torch.empty_like(xf).uniform_(1 - eps, 1 + eps, generator=rng)
        router_in = xf * noise
    logits = F.linear(router_in, lp["router"]).float()  # [N, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    if moe.norm_topk_prob:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    onehot = F.one_hot(top_i, E).float() * valid[:, None, None]  # [N, k, E]
    # routed assignments per expert
    counts_e = _sum_over(onehot.sum(dim=(0, 1)), group)
    f = counts_e / n_valid * E / k
    pm = _sum_over((probs * valid[:, None]).sum(dim=0), group) / n_valid
    load_balance = (f * pm).sum()
    z = _sum_over(((torch.logsumexp(logits, dim=-1) ** 2) * valid).sum(),
                  group) / n_valid
    aux_total = moe.aux_loss_coeff * load_balance + moe.z_loss_coeff * z

    # Routing health, before drops: each expert's share of the assignments
    # (sums to 1) and its max/mean (1 balanced, E a collapse onto one).
    expert_load = counts_e / (n_valid * k).clamp_min(1.0)
    load_ratio = expert_load.max() / expert_load.mean().clamp_min(1e-9)
    aux = {"aux_total": aux_total, "load_balance_loss": load_balance,
           "z_loss": z, "expert_load": expert_load,
           "expert_load_ratio": load_ratio}
    return top_p, top_i, onehot, aux


def _capacity_keep(onehot: torch.Tensor, C: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (token, choice)'s slot in its expert's buffer, token order then
    choice order; pad rows take no slot. Returns (pos [N, k], keep [N, k])."""
    N, k, E = onehot.shape
    flat = onehot.reshape(N * k, E)
    pos = (torch.cumsum(flat, dim=0) - flat).reshape(N, k, E)
    pos = (pos * onehot).sum(dim=-1)
    keep = (pos < C) & (onehot.sum(dim=-1) > 0)
    return pos, keep


def _expert_ffn(xe: torch.Tensor, gate_w: torch.Tensor, up_w: torch.Tensor,
                down_w: torch.Tensor) -> torch.Tensor:
    """The silu-gated expert MLP over ``[E, rows, D]`` buffers."""
    h = F.silu(torch.bmm(xe, gate_w)) * torch.bmm(xe, up_w)
    return torch.bmm(h, down_w)


# ---------------- einsum dispatch (the GShard oracle) ----------------

def _dispatch_einsum(xf: torch.Tensor, top_p: torch.Tensor,
                     onehot: torch.Tensor, lp: Params, moe: MoEConfig,
                     n_valid: torch.Tensor):
    """The one-hot capacity-buffer dispatch: static-shape products whose
    cost grows with E × capacity. Returns (y [N, D], dropped_frac, keep)."""
    N, _ = xf.shape
    k = moe.top_k
    C = capacity(N, moe)
    pos, keep = _capacity_keep(onehot, C)
    gate = top_p * keep
    dropped_frac = 1.0 - keep.sum() / (n_valid * k).clamp_min(1.0)

    # A slot index past C one-hots to zeros (the reference's one_hot).
    slot_oh = (pos[..., None] == torch.arange(C, device=xf.device)).float()
    # combine [N, E, C]: for each (n, e) at most one choice k is nonzero, so
    # the product below sums one term, as the reference's three-way einsum.
    combine = torch.einsum("nke,nkc->nec", onehot * gate[..., None], slot_oh)
    dispatch = (combine > 0).to(xf.dtype)
    xe = torch.einsum("nec,nd->ecd", dispatch, constrain(xf, "column_in"))
    ye = constrain(_expert_ffn(xe, lp["e_gate"], lp["e_up"], lp["e_down"]),
                   "row_out")  # [E, C, D]
    y = torch.einsum("nec,ecd->nd", combine.to(ye.dtype), ye)
    return y, dropped_frac, keep


# ---------------- grouped dispatch (the default) ----------------

def grouped_matmul(xs: torch.Tensor, w: torch.Tensor,
                   group_sizes: List[int]) -> torch.Tensor:
    """Grouped GEMM over contiguous row segments: row m multiplies ``w[g]``
    where m falls in group g's segment (``group_sizes`` host ints, one per
    group). Rows past ``sum(group_sizes)`` come out as zeros, as
    ``ragged_dot`` gives them. One matmul per non-empty segment; the
    segments and the expert matrices are views (``split``, ``unbind``), so
    the backward stacks the weight gradients once."""
    M, F_out = xs.shape[0], w.shape[-1]
    used = sum(group_sizes)
    segs = xs.split(list(group_sizes) + [M - used])
    ws = w.unbind(0)
    out = [segs[g] @ ws[g] for g, n in enumerate(group_sizes) if n]
    if M > used:
        out.append(xs.new_zeros(M - used, F_out))
    return torch.cat(out) if out else xs.new_zeros(0, F_out)


def sort_entries(top_i: torch.Tensor, valid: torch.Tensor, E: int, C: int):
    """The grouped plan of the ``M = N·k`` (token, choice) entries: a stable
    argsort by expert id keeps token-major, then choice, order inside each
    expert's segment, so an entry's position in its segment is the
    oracle's capacity slot; pad entries get the sentinel id E and sort past
    every segment. Returns (order [M], its inverse [M], the E segment sizes
    as host ints: the one host read of the layer, keep [M] in sorted
    order: inside the capacity and not a pad)."""
    M = top_i.numel()
    eid = torch.where(valid[:, None] > 0, top_i,
                      torch.full_like(top_i, E)).reshape(M)
    order = torch.argsort(eid, stable=True)
    sorted_eid = eid[order]
    counts = torch.bincount(eid, minlength=E + 1)  # sentinel bin last
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(M, device=top_i.device) - starts[sorted_eid]
    keep = (pos < C) & (sorted_eid < E)
    return order, torch.argsort(order), counts[:E].tolist(), keep


def permute_entries(xf: torch.Tensor, order: torch.Tensor,
                    k: int) -> torch.Tensor:
    """Each token's row repeated k times, then put in ``order`` ([M, D]).
    Both gathers have unique indices, so their backward adds no two values
    into one slot."""
    N, D = xf.shape
    return xf[:, None, :].expand(N, k, D).reshape(N * k, D)[order]


def expert_mlp_grouped(xs: torch.Tensor, lp: Params,
                       sizes: List[int]) -> torch.Tensor:
    """The silu-gated expert MLP over sorted rows: three grouped GEMMs."""
    h = F.silu(grouped_matmul(xs, lp["e_gate"], sizes)) * grouped_matmul(
        xs, lp["e_up"], sizes)
    return grouped_matmul(h, lp["e_down"], sizes)


def combine_entries(ys: torch.Tensor, gate: torch.Tensor, inv: torch.Tensor,
                    k: int) -> torch.Tensor:
    """Gate-weighted expert rows back in token order, summed over the k
    choices (the inverse permutation, then a sum: deterministic). The gate
    is rounded to the compute dtype, then the weighting and the sum run in
    float32 and round once: the rounding points of the oracle's combine
    product, forward and backward (the reference also rounds each weighted
    row; in float32 the two are the same)."""
    y = ys.float() * gate.to(ys.dtype).float()[:, None]
    return y[inv].reshape(-1, k, ys.shape[-1]).sum(dim=1).to(ys.dtype)


def _dispatch_grouped(xf: torch.Tensor, top_p: torch.Tensor,
                      top_i: torch.Tensor, valid: torch.Tensor, lp: Params,
                      moe: MoEConfig, n_valid: torch.Tensor,
                      keep: Optional[torch.Tensor] = None):
    """Sort-based grouped expert compute (:func:`sort_entries`,
    :func:`permute_entries`, :func:`expert_mlp_grouped`,
    :func:`combine_entries`): entries past their expert's capacity keep a
    zero gate, pad entries come back as zeros. ``keep`` [N, k]: capacity
    slots assigned by the caller (over a whole row held in shards), in
    place of this call's. Returns (y [N, D], dropped_frac, keep [N, k])."""
    N = xf.shape[0]
    k = moe.top_k
    C = capacity(N, moe) if keep is None else N * k
    order, inv, sizes, kept = sort_entries(top_i, valid, moe.num_experts, C)
    if keep is not None:
        kept = keep.reshape(-1)[order]
    dropped_frac = 1.0 - kept.sum() / (n_valid * k).clamp_min(1.0)
    gate = top_p.reshape(-1)[order] * kept
    ys = expert_mlp_grouped(permute_entries(constrain(xf, "column_in"),
                                            order, k), lp, sizes)
    return (combine_entries(constrain(ys, "row_out"), gate, inv, k),
            dropped_frac, kept[inv].reshape(N, k))


# ---------------- expert-parallel dispatch (the exchange over "ep") -------

def source_slots(top_i: torch.Tensor, valid: torch.Tensor, E: int, C: int,
                 rows: int = 1, chunks: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity slots of a ``[B, T]`` micro-batch in natural order whose
    sources are ``rows`` row blocks times ``chunks`` column chunks, each a
    contiguous block (the reference's ``shard_map`` blocks): each (token,
    choice)'s slot in its expert's buffer of its source, token order then
    choice order, pads taking none. ``top_i`` [B, T, k], ``valid`` [B, T].
    Returns (pos [B, T, k] int64, keep [B, T, k] bool: inside ``C`` and not
    a pad)."""
    B, T, k = top_i.shape
    oh = F.one_hot(top_i, E).float() * valid[..., None, None]
    oh = oh.reshape(rows, B // rows, chunks, T // chunks, k, E).permute(
        0, 2, 1, 3, 4, 5).reshape(rows * chunks, -1, E)
    pos = ((torch.cumsum(oh, dim=1) - oh) * oh).sum(dim=-1)
    keep = (pos < C) & (oh.sum(dim=-1) > 0)

    def back(t):
        return t.reshape(rows, chunks, B // rows, T // chunks, k).permute(
            0, 2, 1, 3, 4).reshape(B, T, k)

    return back(pos).long(), back(keep)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over rows with uneven split sizes; the
    backward is the inverse exchange."""

    @staticmethod
    def forward(ctx, x, out_rows, in_rows, group):
        import torch.distributed as dist

        ctx.meta = (out_rows, in_rows, group)
        out = x.new_empty((sum(out_rows),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), list(out_rows),
                               list(in_rows), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        out_rows, in_rows, group = ctx.meta
        gi = g.new_empty((sum(in_rows),) + tuple(g.shape[1:]))
        dist.all_to_all_single(gi, g.contiguous(), list(in_rows),
                               list(out_rows), group=group)
        return gi, None, None, None


def source_capacities(c: int, ctx: ExpertCtx) -> List[int]:
    """Every source's buffer capacity over the ``ep`` group (each rank
    passes its own): sources may differ in size."""
    import torch.distributed as dist

    mine = torch.tensor([c], dtype=torch.int64)
    if dist.get_backend(ctx.group) == "nccl":
        mine = mine.cuda()
    allc = [torch.empty_like(mine) for _ in range(ctx.ep)]
    dist.all_gather(allc, mine, group=ctx.group)
    return [int(t) for t in allc]


def exchange(xe: torch.Tensor, ctx: ExpertCtx,
             caps: Optional[List[int]] = None) -> torch.Tensor:
    """Sources' buffers → owners' rows. One process: ``xe [S, E, C, D]``
    (every source) → ``[E, S·C, D]``, every owner's experts in order, rows
    grouped by source. Over the group: this source's ``[E, C, D]`` →
    ``[E/ep, Σ C_s, D]`` for this owner's experts (``caps`` every source's
    C, :func:`source_capacities`)."""
    if ctx.one_process:
        S, E, C, D = xe.shape
        return xe.transpose(0, 1).reshape(E, S * C, D)
    E, C, D = xe.shape
    El = E // ctx.ep
    got = _AllToAll.apply(xe.reshape(E * C, D), [El * c for c in caps],
                          [El * C] * ctx.ep, ctx.group)
    return torch.cat([b.reshape(El, c, D) for b, c in zip(
        got.split([El * c for c in caps]), caps)], dim=1)


def exchange_back(ye: torch.Tensor, ctx: ExpertCtx, S_or_C: int,
                  caps: Optional[List[int]] = None) -> torch.Tensor:
    """The inverse of :func:`exchange`: owners' rows → each source's
    ``[E, C, D]`` in global expert order (one process: ``[S, E, C, D]``;
    ``S_or_C`` is S there, this source's C over the group)."""
    if ctx.one_process:
        E, SC, D = ye.shape
        S = S_or_C
        return ye.reshape(E, S, SC // S, D).transpose(0, 1)
    El, _, D = ye.shape
    C = S_or_C
    back = torch.cat([b.reshape(El * c, D)
                      for b, c in zip(ye.split(caps, dim=1), caps)])
    got = _AllToAll.apply(back, [El * C] * ctx.ep, [El * c for c in caps],
                          ctx.group)
    return got.reshape(El * ctx.ep, C, D)


def dispatch_ep(xf: torch.Tensor, top_p: torch.Tensor, top_i: torch.Tensor,
                slot: torch.Tensor, keep: torch.Tensor, lp: Params,
                moe: MoEConfig, ctx: ExpertCtx, n_src: int, C: int
                ) -> torch.Tensor:
    """The expert-parallel dispatch (reference ``_dispatch_ep:281``) of the
    ``N·k`` entries of ``xf [N, D]``: each kept entry's row goes to slot
    ``slot`` of its expert's buffer of its source (``slot`` [N, k] counts
    from the start of the source's buffer block: ``source·E·C`` is added
    by the caller for a one-process ``ctx`` of ``n_src`` sources), the
    exchange takes the buffers to their owners, the owners run the batched
    expert MLP on their experts (its ``e_down`` partial sums summed over
    ``tp``), the inverse exchange brings the rows back and the gate-weighted
    rows of each token's choices are summed. Returns y [N, D]."""
    N, D = xf.shape
    E, k = moe.num_experts, moe.top_k
    rows = n_src * E * C
    # dropped entries write to, and read from, one spare zero row
    idx = torch.where(keep, top_i * C + slot, rows).reshape(N * k)
    xrep = constrain(xf, "column_in")[:, None, :].expand(N, k, D).reshape(
        N * k, D)
    xe = xf.new_zeros(rows + 1, D).index_put((idx,), xrep)[:rows]
    if ctx.one_process:
        xin = exchange(xe.reshape(n_src, E, C, D), ctx)
        caps = None
    else:
        caps = source_capacities(C, ctx)
        xin = exchange(xe.reshape(E, C, D), ctx, caps)
    ye = constrain(_expert_ffn(xin, lp["e_gate"], lp["e_up"], lp["e_down"]),
                   "row_out")
    ye = exchange_back(ye, ctx, n_src if ctx.one_process else C, caps)
    ye = torch.cat([ye.reshape(rows, D), ye.new_zeros(1, D)])
    gate = top_p * keep
    y = ye[idx].float() * gate.reshape(N * k).to(ye.dtype).float()[:, None]
    return y.reshape(N, k, D).sum(dim=1).to(ye.dtype)


# ---------------- the layer ----------------

def moe_mlp(x: torch.Tensor, lp: Params, moe: MoEConfig,
            rng: Optional[torch.Generator] = None,
            mask: Optional[torch.Tensor] = None,
            dispatch: Optional[str] = None,
            return_keep: bool = False,
            ep: Optional[ExpertCtx] = None,
            ring: Optional["ring_mod.RingCtx"] = None):
    """Returns (y [B, T, D] in x's dtype, aux) with aux's six entries:
    ``aux_total``, ``load_balance_loss``, ``z_loss``, ``dropped_frac``,
    ``expert_load`` ([E]) and ``expert_load_ratio`` (f32). ``mask`` [B, T]
    (True for real tokens) keeps grid padding out of routing: pads take no
    slot and no part in the statistics. ``rng`` draws the router jitter
    (training only). With ``return_keep`` also the [B·T, k] bool keep mask
    of the (token, choice) entries.

    ``ep``: the expert-parallel dispatch (:func:`dispatch_ep`) over the
    given owners; under a multi-rank ``ep`` the expert stacks in ``lp`` are
    this owner's ``E/ep`` experts. ``ring``: ``x`` and ``mask`` are in the
    ring's layout (this rank's shard, or every shard for a one-process
    ring); the layer's slots and statistics are those of the whole rows in
    natural order, and ``y`` comes back in the ring's layout."""
    if ring is not None and ring.n > 1 and ring.one_process:
        # every shard here: run in natural order, return the ring's layout
        y, aux, keep = _moe_layer(
            ring_mod.unshard_sequence(x, ring), lp, moe, rng,
            None if mask is None else ring_mod.unshard_sequence(mask, ring),
            dispatch, ep, None, ring.n)
        B, T, _ = x.shape
        y = ring_mod.shard_sequence(y, ring)
        keep = ring_mod.shard_sequence(keep.reshape(B, T, -1), ring
                                       ).reshape(B * T, -1)
    else:
        multi = ring is not None and ring.n > 1
        y, aux, keep = _moe_layer(x, lp, moe, rng, mask, dispatch, ep,
                                  ring if multi else None,
                                  ring.n if multi else 1)
    return (y, aux, keep) if return_keep else (y, aux)


def _moe_layer(x, lp, moe, rng, mask, dispatch, ep, ring, n_sp):
    """:func:`moe_mlp` on tokens in natural order (``ring`` None; ``n_sp``
    the sequence shards of a one-process ring, the reference's source
    chunks under ``ep``) or on this rank's shard of a multi-rank ring."""
    B, T, D = x.shape
    N = B * T
    E, k = moe.num_experts, moe.top_k
    xf = x.reshape(N, D)
    valid = (torch.ones(N, dtype=torch.float32, device=x.device)
             if mask is None else mask.reshape(N).float())
    group = ring.group if ring is not None else None
    n_valid = _sum_over(valid.sum(), group).clamp_min(1.0)

    top_p, top_i, onehot, aux = _routing(xf, lp, moe, rng, valid, group)
    if ep is None and ring is None:
        if resolve_dispatch(dispatch) == "einsum":
            y, dropped_frac, keep = _dispatch_einsum(xf, top_p, onehot, lp,
                                                     moe, n_valid)
        else:
            y, dropped_frac, keep = _dispatch_grouped(
                xf, top_p, top_i, valid, lp, moe, n_valid)
    else:
        # capacity slots over the whole rows, in natural order: one source
        # per micro-batch, or the reference's blocks under ep (rows split
        # over a one-process ep, columns over sp)
        rows = ep.ep if ep is not None and ep.one_process else 1
        chunks = n_sp if ep is not None else 1
        T_nat = T * (ring.n if ring is not None else 1)
        C = capacity((B // rows) * (T_nat // chunks), moe)
        ti, va = top_i.reshape(B, T, k), valid.reshape(B, T)
        with torch.no_grad():
            if ring is not None:  # gather the indices, not the activations
                ti, va = (ring_mod.gather_sequence(t, ring) for t in (ti, va))
            pos, keep = source_slots(ti, va, E, C, rows, chunks)
            if ring is not None:
                pos, keep = (ring_mod.shard_sequence(t, ring)
                             for t in (pos, keep))
        keep = keep.reshape(N, k)
        kept = _sum_over(keep.float().sum(), group)
        dropped_frac = 1.0 - kept / (n_valid * k).clamp_min(1.0)
        if ep is None:
            y, _, keep = _dispatch_grouped(xf, top_p, top_i, valid, lp, moe,
                                           n_valid, keep=keep)
        else:
            pos = pos.reshape(N, k)
            if ep.one_process:  # each source's block of the buffers
                src = torch.arange(B, device=x.device)[:, None] // (
                    B // rows) * chunks + torch.arange(
                    T, device=x.device)[None, :] // (T // chunks)
                slot = pos + (src.reshape(N, 1) * (E * C))
                y = dispatch_ep(xf, top_p, top_i, slot, keep, lp, moe, ep,
                                rows * chunks, C)
            else:
                # a zig-zag shard holds two chunks of T/2sp, each inside one
                # of the reference's sources: one C of slots for each
                halves = 2 if (ring is not None and chunks > 1 and
                               ring.schedule == "zigzag") else 1
                half = torch.arange(T, device=x.device) // (T // halves)
                slot = pos + (half.repeat(B)[:, None] * C)
                y = dispatch_ep(xf, top_p, top_i, slot, keep, lp, moe, ep,
                                1, C * halves)
    if "s_gate" in lp:  # the always-on shared expert
        xs = constrain(xf, "column_in")
        y = y + constrain(F.linear(F.silu(F.linear(xs, lp["s_gate"]))
                                   * F.linear(xs, lp["s_up"]), lp["s_down"]),
                          "row_out")
    aux = dict(aux, dropped_frac=dropped_frac)
    return y.reshape(B, T, D).to(x.dtype), aux, keep


def reduce_layer_aux(per_layer: List[Dict[str, torch.Tensor]]
                     ) -> Dict[str, torch.Tensor]:
    """Per-layer aux dicts → the forward's aux (reference ``forward:484``):
    ``aux_total`` summed over the layers (the optimized total), every other
    stat a layer mean (``expert_load`` over the layer axis only)."""
    if not per_layer:
        return {}
    out = {}
    for key in per_layer[0]:
        stacked = torch.stack([a[key] for a in per_layer])
        out[key] = stacked.sum() if key == "aux_total" else stacked.mean(dim=0)
    return out
