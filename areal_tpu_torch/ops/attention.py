"""Segment-aware attention for document-packed fixed-shape batches.

Counterpart of ``areal_tpu/ops/attention.py``. Sequences are packed into
``[B, L]`` rows with per-token segment ids (0 = padding) and attend
block-causally within their own segment. :func:`packed_attention`
dispatches between the hand-written flash kernels
(``ops/flash_attention.py``: K1 forward, and K1 with K2/K3 behind
``FlashAttention`` when a gradient is needed) for CUDA tensors and the
plain reference below for CPU tensors; :func:`decode_attention` is the
KV-cache attention of the decode path, plain PyTorch as in the reference.

Shapes: q ``[B, T, Hq, D]``; k, v ``[B, S, Hkv, D]`` with Hq = G * Hkv (GQA).
"""

from __future__ import annotations

from typing import Optional

import torch

from areal_tpu_torch.ops.flash_attention import FlashAttention, flash_attention

_NEG_INF = -1e30


def segment_mask(
    q_segment_ids: torch.Tensor,  # [B, T] int, 0 = padding
    kv_segment_ids: torch.Tensor,  # [B, S]
    q_positions: Optional[torch.Tensor] = None,  # [B, T] position in row
    kv_positions: Optional[torch.Tensor] = None,  # [B, S]
    causal: bool = True,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Boolean mask [B, 1, T, S]: attend iff same (non-zero) segment and,
    when causal, kv position <= q position (and within the sliding window
    when one is configured: q_pos - kv_pos < window)."""
    qs = q_segment_ids[:, :, None]
    same = (qs == kv_segment_ids[:, None, :]) & (qs > 0)
    if causal or sliding_window is not None:
        if q_positions is None:
            q_positions = torch.arange(
                q_segment_ids.shape[1], device=q_segment_ids.device
            ).expand_as(q_segment_ids)
        if kv_positions is None:
            kv_positions = torch.arange(
                kv_segment_ids.shape[1], device=kv_segment_ids.device
            ).expand_as(kv_segment_ids)
        rel = q_positions[:, :, None] - kv_positions[:, None, :]
        if causal:
            same = same & (rel >= 0)
        if sliding_window is not None:
            same = same & (rel < sliding_window)
    return same[:, None, :, :]


def attention_reference(
    q: torch.Tensor,  # [B, T, Hq, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,  # [B, S, Hkv, D]
    mask: torch.Tensor,  # [B, 1, T, S] bool
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked softmax attention in the input dtype. Rows with no valid key
    (padding queries) come out as zeros."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    qg = q.reshape(B, T, Hkv, G, D)
    scores = torch.einsum("btkgd,bskd->bkgts", qg * scale, k)  # [B,Hkv,G,T,S]
    m = mask[:, :, None, :, :]
    scores = scores.masked_fill(~m, _NEG_INF)
    # Safe softmax: fully masked rows produce zeros.
    smax = scores.amax(dim=-1, keepdim=True)
    unnorm = torch.exp(scores - smax) * m
    denom = unnorm.sum(dim=-1, keepdim=True)
    probs = unnorm / denom.clamp_min(1e-30)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(B, T, Hq, D)


def packed_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    sliding_window: Optional[int] = None,
    impl: str = "auto",
    scale: Optional[float] = None,
) -> torch.Tensor:
    """``impl``: "auto" (the flash kernels for CUDA tensors, the reference
    for CPU tensors), "flash" or "reference". Under "flash", a forward that
    needs a gradient goes through :class:`FlashAttention` (K1, then K2/K3 in
    the backward; their plain versions on the CPU). A sliding window always
    takes the reference; ``scale`` defaults to ``head_dim ** -0.5``."""
    if impl not in ("auto", "flash", "reference"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if sliding_window is not None:
        if impl == "flash":
            raise NotImplementedError(
                "flash attention does not support sliding_window; use "
                "impl='reference'"
            )
        impl = "reference"
    if impl == "auto":
        impl = "flash" if q.is_cuda else "reference"
    if impl == "flash":
        if torch.is_grad_enabled() and any(
                x.requires_grad for x in (q, k, v)):
            return FlashAttention.apply(q, k, v, q_segment_ids,
                                        kv_segment_ids, causal, scale)
        return flash_attention(q, k, v, q_segment_ids, kv_segment_ids,
                               causal=causal, scale=scale)
    mask = segment_mask(q_segment_ids, kv_segment_ids, q_positions,
                        kv_positions, causal, sliding_window=sliding_window)
    return attention_reference(q, k, v, mask, scale=scale)


def decode_attention(
    q: torch.Tensor,  # [B, T, Hq, D] — current step(s); T > 1 = extension
    k_cache: torch.Tensor,  # [B, S, Hkv, D]
    v_cache: torch.Tensor,  # [B, S, Hkv, D]
    kv_valid: torch.Tensor,  # [B, S] bool — or [B, T, S] per query token
) -> torch.Tensor:
    # [B, T, S] gives each of the T new tokens its own valid set (the causal
    # mask of a multi-token cache extension); [B, S] broadcasts one set over
    # every query token (single-step decode).
    if kv_valid.dim() == 3:
        mask = kv_valid[:, None, :, :]
    else:
        mask = kv_valid[:, None, None, :]
    return attention_reference(q, k_cache, v_cache, mask)
