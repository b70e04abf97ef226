"""Memory-lean log-probabilities of labels under logits.

Counterpart of ``areal_tpu/ops/xent.py``. The reference's compiler fuses the
float32 cast into one logsumexp reduction, so no float32 copy of the
``[..., V]`` logits ever exists, forward or backward. Eager PyTorch cannot
fuse, so :class:`GatherLogprobs` walks the rows in chunks of at most
``_CHUNK_BYTES`` of float32 temporaries, in the forward and again in its
hand-written backward; what autograd keeps is the logits themselves (no
copy), the row max and the float32 log of the row sum.
"""

from __future__ import annotations

import torch

_CHUNK_BYTES = 64 << 20


def _chunks(n_rows: int, V: int):
    rows = max(1, _CHUNK_BYTES // (4 * V))
    for s in range(0, n_rows, rows):
        yield slice(s, s + rows)


class GatherLogprobs(torch.autograd.Function):
    """``log_softmax(logits)[label]`` with the reference's rounding points:
    the row max is subtracted in the logits' dtype and only the exponent is
    taken in float32. The backward writes ``g * (onehot - softmax)`` row
    chunk by row chunk into one tensor of the logits' dtype."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, labels: torch.Tensor):
        V = logits.shape[-1]
        flat = logits.reshape(-1, V)
        lab = labels.reshape(-1, 1).long()
        tok = flat.gather(-1, lab)[:, 0]
        m = flat.amax(dim=-1)  # the reference's stop-gradient max
        log_sum = torch.empty(flat.shape[0], dtype=torch.float32,
                              device=logits.device)
        for r in _chunks(flat.shape[0], V):
            shifted = (flat[r] - m[r, None]).float()
            log_sum[r] = torch.exp(shifted).sum(dim=-1).log()
        ctx.save_for_backward(logits, lab, m, log_sum)
        return (tok.float() - (log_sum + m.float())).reshape(labels.shape)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        logits, lab, m, log_sum = ctx.saved_tensors
        V = logits.shape[-1]
        flat = logits.reshape(-1, V)
        g = g.reshape(-1).float()
        grad = torch.empty_like(flat)
        for r in _chunks(flat.shape[0], V):
            probs = torch.exp((flat[r] - m[r, None]).float() - log_sum[r, None])
            grad[r] = (probs * -g[r, None]).to(grad.dtype)
        grad.scatter_add_(-1, lab, g[:, None].to(grad.dtype))
        return grad.reshape(logits.shape), None


def gather_logprobs(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """log p(labels) per position. logits [..., V], labels [...] → [...] f32.

    Logits stay in their compute dtype; under autograd the backward keeps no
    float32 copy of them (:class:`GatherLogprobs`)."""
    return GatherLogprobs.apply(logits, labels)
