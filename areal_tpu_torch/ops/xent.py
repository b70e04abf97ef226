"""Memory-lean log-probabilities of labels under logits.

Counterpart of ``areal_tpu/ops/xent.py``. Eager PyTorch cannot fuse the
float32 cast into the logsumexp reduction the way the reference's compiler
does, so the reduction walks the rows in chunks: at most ``_CHUNK_BYTES`` of
float32 temporaries exist at once, never a float32 copy of the whole
``[..., V]`` logits.
"""

from __future__ import annotations

import torch

_CHUNK_BYTES = 64 << 20


def gather_logprobs(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """log p(labels) per position. logits [..., V], labels [...] → [...] f32.

    Logits stay in their compute dtype; the subtraction of the row max
    happens in that dtype and only the exponent is taken in float32, as in
    the reference."""
    V = logits.shape[-1]
    flat = logits.reshape(-1, V)
    tok = flat.gather(-1, labels.reshape(-1, 1).long())[:, 0]
    lse = torch.empty(flat.shape[0], dtype=torch.float32, device=logits.device)
    rows = max(1, _CHUNK_BYTES // (4 * V))
    for s in range(0, flat.shape[0], rows):
        c = flat[s:s + rows]
        m = c.amax(dim=-1, keepdim=True)
        lse[s:s + rows] = (
            torch.exp((c - m).float()).sum(dim=-1).log() + m[:, 0].float()
        )
    return (tok.float() - lse).reshape(labels.shape)
