"""Mixture-of-Experts layer: top-k routing with a sort-based grouped
expert compute, and the one-hot einsum dispatch kept as its oracle.

Counterpart of ``areal_tpu/models/moe.py`` (``resolve_dispatch:58``,
``capacity:70``, ``_routing:95``, ``_capacity_keep:153``,
``_expert_ffn:166``, ``_dispatch_einsum:176``, ``_grouped_matmul:207``,
``_dispatch_grouped:230``, ``moe_mlp:370``). Both dispatches share the
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

Not ported: the expert-parallel all-to-all dispatch (``_dispatch_ep:281``)
and its gate ``ep_eligible:75``, which need a device mesh; the port runs on
one device (:func:`ep_eligible` is always False).

Router input jitter draws from the ``torch.Generator`` it is given, not from
the reference's PRNG key: the two agree in distribution (uniform in ``[1 -
eps, 1 + eps]``), not in their draws.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from areal_tpu_torch.models.config import MoEConfig

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
    """Whether the expert-parallel all-to-all path can run: never here. The
    port runs on one device with no mesh, and the reference's path needs an
    "ep" mesh axis (multi-device work that has not been ported yet)."""
    return False


# ---------------- router + balancing stats (both paths) ----------------

def _routing(xf: torch.Tensor, lp: Params, moe: MoEConfig,
             rng: Optional[torch.Generator], valid: torch.Tensor):
    """Returns (top_p [N, k] gates after the optional renorm, top_i [N, k],
    onehot [N, k, E] f32 with pad rows zeroed, aux without dropped_frac)."""
    E, k = moe.num_experts, moe.top_k
    n_valid = valid.sum().clamp_min(1.0)

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
    counts_e = onehot.sum(dim=(0, 1))  # routed assignments per expert
    f = counts_e / n_valid * E / k
    pm = (probs * valid[:, None]).sum(dim=0) / n_valid
    load_balance = (f * pm).sum()
    z = ((torch.logsumexp(logits, dim=-1) ** 2) * valid).sum() / n_valid
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
    xe = torch.einsum("nec,nd->ecd", dispatch, xf)  # [E, C, D]
    ye = _expert_ffn(xe, lp["e_gate"], lp["e_up"], lp["e_down"])
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
                      moe: MoEConfig, n_valid: torch.Tensor):
    """Sort-based grouped expert compute (:func:`sort_entries`,
    :func:`permute_entries`, :func:`expert_mlp_grouped`,
    :func:`combine_entries`): entries past their expert's capacity keep a
    zero gate, pad entries come back as zeros. Returns (y [N, D],
    dropped_frac, keep [N, k])."""
    N = xf.shape[0]
    k = moe.top_k
    order, inv, sizes, keep = sort_entries(top_i, valid, moe.num_experts,
                                           capacity(N, moe))
    dropped_frac = 1.0 - keep.sum() / (n_valid * k).clamp_min(1.0)
    gate = top_p.reshape(-1)[order] * keep
    ys = expert_mlp_grouped(permute_entries(xf, order, k), lp, sizes)
    return (combine_entries(ys, gate, inv, k), dropped_frac,
            keep[inv].reshape(N, k))


# ---------------- the layer ----------------

def moe_mlp(x: torch.Tensor, lp: Params, moe: MoEConfig,
            rng: Optional[torch.Generator] = None,
            mask: Optional[torch.Tensor] = None,
            dispatch: Optional[str] = None,
            return_keep: bool = False):
    """Returns (y [B, T, D] in x's dtype, aux) with aux's six entries:
    ``aux_total``, ``load_balance_loss``, ``z_loss``, ``dropped_frac``,
    ``expert_load`` ([E]) and ``expert_load_ratio`` (f32). ``mask`` [B, T]
    (True for real tokens) keeps grid padding out of routing: pads take no
    slot and no part in the statistics. ``rng`` draws the router jitter
    (training only). With ``return_keep`` also the [B·T, k] bool keep mask
    of the (token, choice) entries."""
    B, T, D = x.shape
    N = B * T
    xf = x.reshape(N, D)
    valid = (torch.ones(N, dtype=torch.float32, device=x.device)
             if mask is None else mask.reshape(N).float())
    n_valid = valid.sum().clamp_min(1.0)

    top_p, top_i, onehot, aux = _routing(xf, lp, moe, rng, valid)
    if resolve_dispatch(dispatch) == "einsum":
        y, dropped_frac, keep = _dispatch_einsum(xf, top_p, onehot, lp, moe,
                                                 n_valid)
    else:
        y, dropped_frac, keep = _dispatch_grouped(xf, top_p, top_i, valid, lp,
                                                  moe, n_valid)
    if "s_gate" in lp:  # the always-on shared expert
        y = y + F.linear(F.silu(F.linear(xf, lp["s_gate"]))
                         * F.linear(xf, lp["s_up"]), lp["s_down"])
    aux = dict(aux, dropped_frac=dropped_frac)
    y = y.reshape(B, T, D).to(x.dtype)
    return (y, aux, keep) if return_keep else (y, aux)


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
