"""PPO math on the packed ``[B, L]`` grid: log-prob gathering, masks,
normalization, GAE, the decoupled actor loss, the clipped value loss and
the KL controllers.

Counterpart of ``areal_tpu/algorithms/ppo_functional.py`` on torch tensors
(:func:`action_token_mask` and :func:`shift_right_in_doc` also take numpy
arrays, as there). Everything
operates on the ``[B, L]`` grid with a boolean ``mask`` (True = a real token
position that contributes). :func:`gae_packed_np` is kept as the numpy
oracle of :func:`gae_grid`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch.ops.xent import gather_logprobs


def _shift_right(x):
    """[B, L] → [B, L]: column t holds column t-1 of x, column 0 holds 0."""
    if isinstance(x, np.ndarray):
        return np.concatenate([np.zeros_like(x[:, :1]), x[:, :-1]], axis=1)
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def next_token_labels(tokens: torch.Tensor) -> torch.Tensor:
    """labels[t] = tokens[t+1] (last column wraps — masked out later)."""
    return torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)


def shift_mask_scores(
    s: torch.Tensor,  # [B, L]: s[t] = log p(token_{t+1} | logits at t)
    segment_ids: torch.Tensor,  # [B, L], 0 = pad
) -> torch.Tensor:
    """Shift-right + same-doc masking: position t ends up holding
    log p(token_t | prefix), 0 at doc starts and padding."""
    valid = (segment_ids > 0) & (_shift_right(segment_ids) == segment_ids)
    return _shift_right(s) * valid


def token_logprobs_from_logits(
    logits: torch.Tensor,  # [B, L, V]
    tokens: torch.Tensor,  # [B, L]
    segment_ids: torch.Tensor,  # [B, L], 0 = pad
) -> torch.Tensor:
    """[B, L] where position t holds log p(token_t | prefix), i.e. the
    model's score of token t from the logits at t−1 within the same doc;
    0 at each doc's first token and on padding."""
    s = gather_logprobs(logits, next_token_labels(tokens))
    return shift_mask_scores(s, segment_ids)


def action_token_mask(segment_ids, prompt_mask):
    """Generated-token positions with a valid (non-doc-first) logprob — THE
    loss mask shared by the actor loss and host-side token counting.
    Accepts numpy arrays or torch tensors; returns a bool array of the same
    kind."""
    prev_seg = _shift_right(segment_ids)
    return (segment_ids > 0) & (prev_seg == segment_ids) & (prompt_mask == 0)


def shift_right_in_doc(x, segment_ids):
    """[B, L] → [B, L] with x shifted right by one inside each document:
    out[t] = x[t−1] when t−1 is in the same doc, else 0 — the value
    alignment of the PPO baseline (the critic value at slot t−1 is the state
    before token t was emitted). Accepts numpy arrays or torch tensors."""
    keep = (_shift_right(segment_ids) == segment_ids) & (segment_ids > 0)
    return _shift_right(x) * keep


def masked_normalization(
    x: torch.Tensor,
    mask: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Whiten x over masked entries in float32 (reference functional.py
    masked_normalization; the reference's float64 option needs 64-bit
    types switched on, which its trainer never does)."""
    x32 = x.float()
    m = mask.float()
    cnt = m.sum()
    mean = (x32 * m).sum() / cnt.clamp_min(1.0)
    var = (((x32 - mean) ** 2) * m).sum() / cnt.clamp_min(1.0)
    return ((x32 - mean) * torch.rsqrt(var + eps) * m).to(x.dtype)


# ---------------- GAE ----------------

def gae_grid(
    rewards: torch.Tensor,  # [B, L] per-token rewards
    values: torch.Tensor,  # [B, L] V(s_t) under the same layout
    segment_ids: torch.Tensor,  # [B, L] int, 0 = pad — document boundaries
    bootstrap: Optional[torch.Tensor] = None,  # [B, L] V(s_{t+1}) at seq ends
    gamma: float = 1.0,
    lam: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment-aware GAE on the fixed grid; returns (advantages, returns).

    δ_t = r_t + γ·V_{t+1} − V_t with V beyond the document end = 0 (or
    ``bootstrap`` at the last token of a truncated sequence);
    adv_t = δ_t + γλ·adv_{t+1}, reset across document boundaries.

    The linear recurrence is associative, so it runs as a log-depth scan
    over the time-reversed columns: ⌈log2 L⌉ doubling steps of the combine
    ``(a1·a2, b2 + a2·b1)``, a few launches each, instead of one step per
    column."""
    f32 = torch.float32
    mask = segment_ids > 0
    r = rewards.to(f32)
    v = values.to(f32) * mask
    # "continues": position t+1 exists and belongs to the same document.
    nxt_seg = torch.cat([segment_ids[:, 1:], torch.zeros_like(segment_ids[:, :1])], dim=1)
    continues = (nxt_seg == segment_ids) & mask
    v_next = torch.cat([v[:, 1:], torch.zeros_like(v[:, :1])], dim=1)
    v_next = torch.where(continues, v_next, 0.0)
    if bootstrap is not None:
        last = mask & ~continues
        v_next = torch.where(last, bootstrap.to(f32), v_next)
    delta = (r + gamma * v_next - v) * mask

    # adv_t = δ_t + a_t · adv_{t+1},  a_t = γλ where t+1 continues the doc.
    a = (gamma * lam) * continues.to(f32)
    # Inclusive scan of the reversed sequence: after the step with offset d,
    # element t holds the combine of elements t-2d+1 .. t (Hillis–Steele).
    a_s, b_s = a.flip(1), delta.flip(1)
    L = a_s.shape[1]
    d = 1
    while d < L:
        b_s = torch.cat([b_s[:, :d], b_s[:, d:] + a_s[:, d:] * b_s[:, :-d]], dim=1)
        a_s = torch.cat([a_s[:, :d], a_s[:, d:] * a_s[:, :-d]], dim=1)
        d *= 2
    adv = b_s.flip(1) * mask
    return adv, adv + v


def gae_packed_np(
    rewards: np.ndarray,  # 1-D packed over sequences
    values: np.ndarray,  # 1-D packed, same layout
    seqlens,  # per-sequence lengths
    bootstrap: Optional[np.ndarray] = None,  # [n_seqs] V at truncation, 0 if done
    gamma: float = 1.0,
    lam: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy oracle for 1-D packed GAE — parity with the reference's
    ``pygae1d_nolp_misalign`` (ppo_functional.py:292)."""
    adv = np.zeros_like(values, dtype=np.float64)
    ret = np.zeros_like(values, dtype=np.float64)
    off = 0
    for i, n in enumerate(seqlens):
        n = int(n)
        acc = 0.0
        vnext = float(bootstrap[i]) if bootstrap is not None else 0.0
        for t in range(n - 1, -1, -1):
            delta = rewards[off + t] + gamma * vnext - values[off + t]
            acc = delta + gamma * lam * acc
            adv[off + t] = acc
            ret[off + t] = acc + values[off + t]
            vnext = values[off + t]
        off += n
    return adv.astype(np.float32), ret.astype(np.float32)


# ---------------- losses ----------------

def actor_loss(
    logprobs: torch.Tensor,  # [B, L] π_θ logprobs of taken actions
    old_logprobs: torch.Tensor,  # [B, L] behaviour policy (sampler) logprobs
    advantages: torch.Tensor,  # [B, L]
    mask: torch.Tensor,  # [B, L] bool
    eps_clip: float = 0.2,
    c_clip: Optional[float] = None,  # dual clip (> 1.0) for negative adv
    proximal_logprobs: Optional[torch.Tensor] = None,  # decoupled clip center
    behav_imp_weight_cap: Optional[float] = None,
    loss_scale: Optional[torch.Tensor] = None,  # denominator; default masked count
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decoupled PPO actor loss (reference ppo_functional.py:51-158).

    With ``proximal_logprobs`` (π_prox, recomputed at train time), the clip
    ratio is centered on π_prox and the whole term is multiplied by the
    behaviour importance weight exp(π_prox − π_behav) (optionally capped).
    Without it, this reduces to standard PPO.
    """
    mask = mask.to(torch.bool)
    denom = torch.clamp_min(
        torch.as_tensor(loss_scale, dtype=torch.float32, device=mask.device)
        if loss_scale is not None else mask.sum().float(), 1.0
    )
    center = proximal_logprobs if proximal_logprobs is not None else old_logprobs
    ratio = torch.exp(torch.where(mask, logprobs - center, 0.0))
    clipped = torch.clamp(ratio, 1.0 - eps_clip, 1.0 + eps_clip)
    l1 = -advantages * ratio
    l2 = -advantages * clipped
    loss_tok = torch.maximum(l1, l2)
    clip_mask = (l2 > l1) & mask
    if c_clip is not None:
        assert c_clip > 1.0
        l3 = -advantages * c_clip
        dual_mask = (advantages < 0) & mask
        dual = torch.minimum(loss_tok, l3)
        dual_clip_mask = (l3 < loss_tok) & dual_mask
        loss_tok = torch.where(dual_mask, dual, loss_tok)
    else:
        dual_clip_mask = torch.zeros_like(clip_mask)
    # Importance-weight tail: the mass of action tokens the behaviour cap
    # drops — off-policyness beyond what the decoupled loss corrects.
    behav_tail = torch.zeros((), dtype=torch.float32, device=mask.device)
    if proximal_logprobs is not None:
        behav_w = torch.exp(torch.where(mask, center - old_logprobs, 0.0))
        if behav_imp_weight_cap is not None:
            keep = behav_w <= behav_imp_weight_cap
            behav_tail = ((~keep) & mask).sum() / denom
            behav_w = torch.where(keep, behav_w, 0.0)
        loss_tok = loss_tok * behav_w
    loss = torch.where(mask, loss_tok, 0.0).sum() / denom
    stats = {
        "importance_weight": (ratio * mask).sum() / denom,
        "clip_ratio": clip_mask.sum() / denom,
        "dual_clip_ratio": dual_clip_mask.sum() / denom,
        # k1 approx-KL against the behaviour policy and the sampled-token
        # entropy estimate −E[log π(a_t)].
        "approx_kl": torch.where(mask, old_logprobs - logprobs, 0.0).sum() / denom,
        "entropy": -torch.where(mask, logprobs, 0.0).sum() / denom,
        "behav_tail": behav_tail,
    }
    return loss, stats


def critic_loss(
    value: torch.Tensor,  # [B, L] new value prediction
    old_value: torch.Tensor,  # [B, L] value at rollout time
    returns: torch.Tensor,  # [B, L] GAE returns (target)
    mask: torch.Tensor,
    value_eps_clip: float = 0.2,
    loss_fn: str = "huber",
    huber_delta: float = 10.0,
    loss_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped value loss (reference ppo_functional.py:277; the Huber delta
    defaults to the reference's 10.0)."""
    mask = mask.to(torch.bool)
    denom = torch.clamp_min(
        torch.as_tensor(loss_scale, dtype=torch.float32, device=mask.device)
        if loss_scale is not None else mask.sum().float(), 1.0
    )

    def base(x, y):
        if loss_fn != "huber":
            return 0.5 * (x - y) ** 2
        d = (x - y).abs()
        return torch.where(d < huber_delta, 0.5 * d * d,
                           huber_delta * (d - 0.5 * huber_delta))

    clipped = old_value + torch.clamp(value - old_value, -value_eps_clip,
                                      value_eps_clip)
    l1 = base(value, returns)
    l2 = base(clipped, returns)
    clip_mask = (l2 > l1) & mask
    loss = torch.where(mask, torch.maximum(l1, l2), 0.0).sum() / denom
    return loss, {"value_clip_ratio": clip_mask.sum() / denom}


# ---------------- KL controllers ----------------

@dataclasses.dataclass
class FixedKLController:
    """Reference ppo_functional.py:37-48."""

    kl_coef: float = 0.0

    @property
    def value(self) -> float:
        return self.kl_coef

    def update(self, current_kl: float, n_steps: int) -> None:
        pass


@dataclasses.dataclass
class AdaptiveKLController:
    """Reference ppo_functional.py:14-36 (Ziegler et al. adaptive KL)."""

    init_kl_coef: float
    target: float
    horizon: float
    _value: float = dataclasses.field(default=0.0, init=False)

    def __post_init__(self):
        self._value = self.init_kl_coef

    @property
    def value(self) -> float:
        return self._value

    def update(self, current_kl: float, n_steps: int) -> None:
        err = np.clip(current_kl / self.target - 1.0, -0.2, 0.2)
        self._value *= 1.0 + err * n_steps / self.horizon
