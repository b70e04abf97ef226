"""SFT interface — packed cross-entropy over answer tokens.

Counterpart of ``areal_tpu/algorithms/sft.py``: ``sft_loss:20``,
``SFTInterface:40`` (``train_step`` through the engine's ``train_batch``,
the eval ``inference``) and ``_attach_loss_mask:90``. Data contract:
``packed_input_ids`` + ``prompt_mask`` (1 on prompt tokens, excluded from
the loss).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from areal_tpu_torch.algorithms import ppo_functional as F
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model import Model, ModelInterface, register_interface


def _token_logprobs(logits: torch.Tensor, batch) -> torch.Tensor:
    """[R, L] logprobs: as given under the engine's chunked head, else
    gathered from [R, L, V] logits."""
    if logits.dim() == 2:
        return logits
    return F.token_logprobs_from_logits(logits, batch["tokens"],
                                        batch["segment_ids"])


def sft_loss(logits: torch.Tensor, batch: Dict[str, torch.Tensor]):
    """Sum of -logp over answer tokens. Token t is scored by the logits at
    t-1 (same doc), so the first token of each doc never contributes."""
    w = batch["_sft_loss_mask"]
    loss = -(_token_logprobs(logits, batch) * w).sum()
    return loss, {"n_tokens": w.sum(), "nll_sum": loss}


sft_loss.wants_token_logprobs = True


def _nll_hook(logits, batch):
    return -_token_logprobs(logits, batch) * batch["_sft_loss_mask"]


_nll_hook.wants_token_logprobs = True


def _loss_weight(mb) -> float:
    return float(mb.grids["_sft_loss_mask"].sum())


@dataclasses.dataclass
class SFTInterface(ModelInterface):
    token_normalize_scope: str = "global"

    def train_step(
        self, model: Model, data: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict[str, float]:
        stats = model.module.train_batch(
            _attach_loss_mask(data), mb_spec, sft_loss, _loss_weight,
            token_normalize_scope=self.token_normalize_scope,
            version_steps=model.version.global_step,
        )
        model.inc_version()
        n = max(stats.pop("n_tokens", 1.0), 1.0)
        stats["ppl"] = math.exp(min(stats["nll_sum"] / n, 20.0))
        return stats

    def inference(
        self, model: Model, data: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        """Eval: per-sample NLL."""
        data = _attach_loss_mask(data)
        per_sample = model.module.forward(data, mb_spec, post_hook=_nll_hook)
        nll = np.asarray([p.sum() for p in per_sample], np.float32)
        return SequenceSample.from_default(
            ids=data.ids, data={"eval_nll": nll}, seqlens=[1] * data.bs)


def _attach_loss_mask(data: SequenceSample) -> SequenceSample:
    """Answer-token mask as a full-length key (grids ride the layout)."""
    lm = (1 - np.asarray(data.data["prompt_mask"])).astype(np.float32)
    return SequenceSample(
        ids=list(data.ids),
        keys=set(data.keys) | {"_sft_loss_mask"},
        seqlens={**data.seqlens,
                 "_sft_loss_mask": data.seqlens["packed_input_ids"]},
        data={**data.data, "_sft_loss_mask": lm},
        metadata=data.metadata,
    )


register_interface("sft", SFTInterface)
