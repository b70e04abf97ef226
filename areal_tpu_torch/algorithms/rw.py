"""Learned reward-model training: the Bradley-Terry pairwise loss.

The port of ``areal_tpu/algorithms/rw.py`` (``_pairwise_loss:33``,
``_loss_weight:65``, ``flatten_pairs:72``, ``RewardModelingInterface:100``;
reference ``realhf/impl/dataset/rw_paired_dataset.py`` and the paired-RM
trainer of earlier RealHF releases): a critic-headed model scores each
answer at its last token, and each pair optimizes
``-log sigmoid(s_pos - s_neg)``.

Data contract: the paired dataset emits one multi-segment sample per
prompt (segments pos, neg, pos, neg, ...). ``train_step`` flattens each
pair into two sequences tagged with per-sequence ``_pair_idx`` /
``_pair_sign`` scalars, which the packer carries as ``[S]`` vectors beside
``seq_rows`` / ``seq_last_cols``; the loss re-joins the pairs of a
micro-batch by ``_pair_idx``. A pair that packing splits across
micro-batches is skipped for that step and counted in ``orphan_pairs``:
keep ``max_tokens_per_mb`` large enough that this stays 0.

Left out: the interface's ``n_minibatches``, which nothing reads (one
``train_batch`` over the micro-batches is the step).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model import Model, ModelInterface, register_interface


def _pairwise_loss(values: torch.Tensor, batch: Dict[str, torch.Tensor]):
    """values: a critic's ``[R, L]`` outputs. A sequence's score is its value
    at its last token; each positive finds its negative by ``_pair_idx``
    (O(S^2) over the micro-batch's few sequences); the loss sums over the
    pairs whose two members both landed in this micro-batch."""
    scores = values[batch["seq_rows"].long(), batch["seq_last_cols"].long()]
    mask = batch["seq_mask"]
    sign = batch["_pair_sign"]
    idx = batch["_pair_idx"]
    same = (idx[:, None] == idx[None, :]).float()
    neg_m = (sign < 0).float() * mask
    pos_m = (sign > 0).float() * mask
    partner_score = same @ (scores * neg_m)
    partner_present = same @ neg_m
    whole = pos_m * (partner_present == 1.0).float()
    diff = scores - partner_score  # meaningful where whole == 1
    # -log sigmoid(diff) = softplus(-diff)
    loss = (F.softplus(-diff) * whole).sum()
    correct = ((diff > 0).float() * whole).sum()
    n_pairs = whole.sum()
    orphan = pos_m.sum() - n_pairs + (neg_m * ((pos_m @ same) == 0.0).float()
                                      ).sum()
    return loss, {
        "n_pairs": n_pairs, "correct_sum": correct, "loss_sum": loss,
        "pos_score_sum": (scores * pos_m).sum(),
        "neg_score_sum": (scores * neg_m).sum(),
        "orphan_pairs": orphan,
    }


def _loss_weight(mb) -> float:
    # Normalize by pairs, not tokens: every comparison counts the same
    # whatever its answers' lengths.
    return float((mb.scalars["_pair_sign"] > 0).sum())


def flatten_pairs(data: SequenceSample) -> SequenceSample:
    """Paired multi-segment samples -> one sample per answer with
    ``_pair_idx`` / ``_pair_sign`` scalars (pairs numbered across the
    batch)."""
    out: List[SequenceSample] = []
    pair = 0
    toks = data.data["packed_input_ids"]
    for i in range(data.bs):
        segs = data.seqlens["packed_input_ids"][i]
        assert len(segs) % 2 == 0, "paired data needs pos/neg interleaved"
        off = int(data.offsets("packed_input_ids")[i])
        for j in range(0, len(segs), 2):
            for sign, name in ((1.0, "pos"), (-1.0, "neg")):
                ln = int(segs[j + (sign < 0)])
                out.append(SequenceSample.from_default(
                    ids=[f"{data.ids[i]}@p{j // 2}{name}"],
                    data={
                        "packed_input_ids": toks[off:off + ln],
                        "_pair_idx": np.asarray([pair], np.float32),
                        "_pair_sign": np.asarray([sign], np.float32),
                    },
                    seqlens=[ln],
                ))
                off += ln
            pair += 1
    return SequenceSample.gather(out)


def _last_value_hook(values, batch):
    return values[..., None]  # [R, L, 1] per-token values


@dataclasses.dataclass
class RewardModelingInterface(ModelInterface):
    def train_step(
        self, model: Model, data: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict[str, float]:
        engine = model.module
        assert engine.cfg.is_critic, "a reward model needs a scalar head"
        stats = engine.train_batch(
            flatten_pairs(data), mb_spec, _pairwise_loss, _loss_weight,
            token_normalize_scope="global",
            version_steps=model.version.global_step,
        )
        model.inc_version()
        n = max(stats.get("n_pairs", 1.0), 1.0)
        stats["pairwise_accuracy"] = stats.pop("correct_sum", 0.0) / n
        stats["pos_minus_neg"] = (
            stats.pop("pos_score_sum", 0.0) - stats.pop("neg_score_sum", 0.0)
        ) / n
        return stats

    def inference(
        self, model: Model, data: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        """A score per sequence of flat inputs (one answer a sample): the
        serving path of a trained reward model."""
        per_sample = model.module.forward(data, mb_spec,
                                          post_hook=_last_value_hook)
        scores = np.asarray([float(p[-1, 0]) for p in per_sample], np.float32)
        return SequenceSample.from_default(
            ids=list(data.ids), data={"scores": scores},
            seqlens=[1] * data.bs)


register_interface("rw_paired", RewardModelingInterface)
