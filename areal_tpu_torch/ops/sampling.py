"""Token sampling: temperature / top-k / top-p logits warping.

Counterpart of ``areal_tpu/ops/sampling.py``. The random draw is a Gumbel-max
over uniforms from an explicit ``torch.Generator`` (the same distribution as
a categorical draw; not the same numbers as the reference's generator).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from areal_tpu_torch.api.model import GenerationHyperparameters

_NEG_INF = -1e30


def apply_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    return logits / max(temperature, 1e-6)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, _NEG_INF)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # Keep tokens while cumulative prob (exclusive) < p: always keeps top-1.
    cutoff = ((cum - probs) < p).sum(dim=-1, keepdim=True)
    kth = torch.gather(sorted_logits, -1, cutoff - 1)
    return logits.masked_fill(logits < kth, _NEG_INF)


def warp_logits(logits: torch.Tensor, g: GenerationHyperparameters) -> torch.Tensor:
    logits = apply_temperature(logits, g.temperature)
    logits = apply_top_k(logits, g.top_k)
    return apply_top_p(logits, g.top_p)


def _categorical(warped: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    u = torch.rand(warped.shape, generator=generator, device=warped.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(warped.float() + gumbel, dim=-1)


def sample_token(
    logits: torch.Tensor,  # [B, V] raw logits
    generator: torch.Generator,
    g: GenerationHyperparameters,
):
    """Returns (tokens [B] int32, logprobs [B]) — the logprob of the sampled
    token under the *warped* distribution the behaviour policy sampled from."""
    warped = warp_logits(logits, g)
    logp = torch.log_softmax(warped, dim=-1)
    if g.greedy:
        tokens = torch.argmax(warped, dim=-1)
    else:
        tokens = _categorical(warped, generator)
    chosen = torch.gather(logp, -1, tokens[:, None])[:, 0]
    return tokens.to(torch.int32), chosen


# Per-row sampling: temperature/top-k/top-p/greedy as [B] tensors, so one
# decode loop serves a batch of requests with different hyperparameters.


def sampling_from_gconfigs(
    gconfigs: Sequence[GenerationHyperparameters], device=None
) -> Dict[str, torch.Tensor]:
    """Per-row sampling-parameter tensors from one gconfig per batch row."""
    def t(vals, dtype):
        return torch.tensor(vals, dtype=dtype, device=device)

    return {
        "temperature": t([g.temperature for g in gconfigs], torch.float32),
        "top_k": t([g.top_k for g in gconfigs], torch.int64),
        "top_p": t([g.top_p for g in gconfigs], torch.float32),
        "greedy": t([g.greedy for g in gconfigs], torch.bool),
        "min_new_tokens": t([g.min_new_tokens for g in gconfigs], torch.int32),
    }


def warp_logits_rows(
    logits: torch.Tensor,  # [B, V]
    temperature: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] int; <= 0 disables
    top_p: torch.Tensor,  # [B] float; >= 1 disables
) -> torch.Tensor:
    """Row-wise equivalent of apply_temperature → top_k → top_p. One sort
    serves both filters: top-k keeps the first k sorted slots; top-p
    renormalizes over those and keeps the nucleus prefix."""
    V = logits.shape[-1]
    logits = logits / temperature[:, None].clamp_min(1e-6)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    idx = torch.arange(V, device=logits.device)[None, :]
    keep_k = (top_k[:, None] <= 0) | (idx < top_k[:, None])
    probs = torch.softmax(sorted_desc.masked_fill(~keep_k, _NEG_INF), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # p >= 1 disables nucleus filtering outright (cum can round to exactly
    # 1.0 on near-zero tail probs, which would otherwise clip them).
    keep = (((cum - probs) < top_p[:, None]) | (top_p[:, None] >= 1.0)) & keep_k
    n_keep = keep.sum(dim=-1, keepdim=True).clamp_min(1)
    kth = torch.gather(sorted_desc, -1, n_keep - 1)
    return logits.masked_fill(logits < kth, _NEG_INF)


def sample_token_rows(
    logits: torch.Tensor,  # [B, V] raw logits
    generator: torch.Generator,
    sampling: Dict[str, torch.Tensor],  # per-row tensors (sampling_from_gconfigs)
):
    """Row-wise sample_token: each row uses its own sampling params."""
    warped = warp_logits_rows(
        logits, sampling["temperature"], sampling["top_k"], sampling["top_p"]
    )
    logp = torch.log_softmax(warped, dim=-1)
    sampled = _categorical(warped, generator)
    greedy_tok = torch.argmax(warped, dim=-1)
    tokens = torch.where(sampling["greedy"], greedy_tok, sampled)
    chosen = torch.gather(logp, -1, tokens[:, None])[:, 0]
    return tokens.to(torch.int32), chosen
