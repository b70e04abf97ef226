"""The PPO actor interface — the algorithm layer of the train step.

Counterpart of ``areal_tpu/algorithms/ppo.py``: ``PPOHyperparameters:55``,
``_action_mask:135``, ``make_advantage_prep:219``, ``PPOActorInterface:326``
with ``train_step:407`` on the uniform fast path (``:421-468``: one upload,
GAE and advantage whitening on the device, contiguous micro-batch groups
with one optimizer step each, the early stop), ``_action_token_weight:588``
and ``attach_keys:592``.

Data contract (every per-token key full-length aligned to
``packed_input_ids``; see backend/microbatch.py): ``prompt_mask`` (1 on
prompt tokens), ``packed_logprobs`` (behaviour-policy logprob of token t at
slot t, 0 on prompt slots and each doc's first token), optional
``prox_logprobs``, ``packed_ref_logprobs`` and ``values``; per sample
``rewards`` and ``seq_no_eos_mask``.

Not ported yet: the host advantage path (``group_adv_norm``,
``compute_advantages_and_returns:142``, ``normalize_advantages:293``,
``train_batch``), ``generate``, ``inference``, ``save``, the critic and the
interface registry.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional

import numpy as np
import torch

from areal_tpu_torch.algorithms import ppo_functional as F
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model import (
    GenerationHyperparameters,
    Model,
    ModelInterface,
)
from areal_tpu_torch.backend import microbatch as mbu

logger = logging.getLogger("areal_tpu_torch.algorithms.ppo")


@dataclasses.dataclass
class PPOHyperparameters:
    """Reference cli_args.py:597 (PPOHyperparameters)."""

    gen: GenerationHyperparameters = dataclasses.field(
        default_factory=GenerationHyperparameters
    )
    ppo_n_minibatches: int = 4
    eps_clip: float = 0.2
    c_clip: Optional[float] = None
    value_eps_clip: float = 0.2
    early_stop_imp_ratio: float = 5.0
    reward_output_scaling: float = 1.0
    reward_output_bias: float = 0.0
    max_reward_clip: float = 20.0
    mask_no_eos_with_zero: bool = False
    discount: float = 1.0
    gae_lambda: float = 1.0
    adv_norm: bool = True
    kl_ctl: float = 0.1
    use_adaptive_kl_ctl: bool = False
    adaptive_kl_target: float = 6.0
    adaptive_kl_horizon: float = 10000.0
    disable_value: bool = False  # GRPO: no critic
    value_norm: bool = True
    value_norm_beta: float = 0.99995
    value_norm_eps: float = 1e-5
    group_size: int = 1
    group_adv_norm: bool = False
    use_decoupled_loss: bool = False
    behav_imp_weight_cap: Optional[float] = None
    recompute_logprob: bool = False


def _action_mask(grids: Dict[str, np.ndarray]) -> np.ndarray:
    """Host-side view of the shared loss mask (ppo_functional)."""
    return F.action_token_mask(grids["segment_ids"], grids["prompt_mask"])


def make_advantage_prep(hp: PPOHyperparameters):
    """Device-side advantage pipeline over an uploaded UniformBatch: KL-shaped
    token rewards with the task score on each sequence's last token, GAE
    over the action tokens, global advantage whitening — in one pass with
    no host round trip."""

    def prep(grids, seq, R, scalars):
        seg = grids["segment_ids"]
        amask = F.action_token_mask(seg, grids["prompt_mask"])
        amf = amask.float()
        behav = grids["packed_logprobs"]
        ref = grids.get("packed_ref_logprobs", torch.zeros_like(behav))
        kl = (behav - ref) * amf
        values = grids.get("values", torch.zeros_like(behav)) * (seg > 0)

        score = seq["rewards"].float()  # [n_mbs, S]
        no_eos = (seq["seq_no_eos_mask"] > 0 if "seq_no_eos_mask" in seq
                  else torch.zeros_like(score, dtype=torch.bool))
        if hp.mask_no_eos_with_zero:
            score = torch.where(no_eos, 0.0, score)
        tok_score = torch.clamp(
            (score - hp.reward_output_bias) * hp.reward_output_scaling,
            -hp.max_reward_clip, hp.max_reward_clip,
        )
        # Flatten [n_mbs, S] sequence coordinates into the [n_mbs*R, L] grid.
        n_mbs = seq["seq_rows"].shape[0]
        mb_off = torch.arange(n_mbs, device=seg.device)[:, None] * R
        rows_f = (seq["seq_rows"].long() + mb_off).reshape(-1)
        lasts_f = seq["seq_last_cols"].long().reshape(-1)
        valid_f = seq["seq_mask"].reshape(-1).float()

        kl_rw = -scalars["kl_coef"] * kl * amf
        rewards_grid = kl_rw.index_put(
            (rows_f, lasts_f), tok_score.reshape(-1) * valid_f, accumulate=True)
        v_prev = F.shift_right_in_doc(values, seg)
        boot = torch.zeros_like(values).index_put(
            (rows_f, lasts_f),
            values[rows_f, lasts_f] * no_eos.reshape(-1).float() * valid_f,
            accumulate=True,
        )
        act_seg = torch.where(amask, seg, 0)
        adv, ret = F.gae_grid(rewards_grid, v_prev, act_seg, bootstrap=boot,
                              gamma=hp.discount, lam=hp.gae_lambda)
        n_act = amf.sum().clamp_min(1.0)
        out_scalars = {
            "_mean_kl": kl.sum() / n_act,
            # Advantage scale BEFORE whitening: a collapsing or exploding
            # raw advantage signals a reward/value-pipeline divergence.
            "_adv_scale": (adv.abs() * amf).sum() / n_act,
        }
        if hp.adv_norm:
            adv = F.masked_normalization(adv, amask)
        return {"advantages": adv, "returns": ret, "kl_rewards": kl_rw}, out_scalars

    return prep


class PPOActorInterface(ModelInterface):
    def __init__(self, hp: Optional[PPOHyperparameters] = None, **kw):
        self.hp = hp or PPOHyperparameters(**kw)
        if self.hp.use_adaptive_kl_ctl:
            self.kl_ctl = F.AdaptiveKLController(
                self.hp.kl_ctl, self.hp.adaptive_kl_target,
                self.hp.adaptive_kl_horizon,
            )
        else:
            self.kl_ctl = F.FixedKLController(self.hp.kl_ctl)
        hp_ = self.hp

        def actor_loss_fn(logits, batch):
            # With the engine's chunked-logprob head (wants_token_logprobs)
            # this receives the [B, L] logprobs directly; otherwise raw
            # [B, L, V] logits.
            lp = logits if logits.dim() == 2 else F.token_logprobs_from_logits(
                logits, batch["tokens"], batch["segment_ids"]
            )
            amask = F.action_token_mask(batch["segment_ids"],
                                        batch["prompt_mask"])
            prox = batch.get("prox_logprobs") if hp_.use_decoupled_loss else None
            loss, st = F.actor_loss(
                lp, batch["packed_logprobs"], batch["advantages"], amask,
                eps_clip=hp_.eps_clip, c_clip=hp_.c_clip,
                proximal_logprobs=prox,
                behav_imp_weight_cap=hp_.behav_imp_weight_cap,
                loss_scale=1.0,  # sum; the engine divides by the weight
            )
            stats = {f"{k}_sum": v * 1.0 for k, v in st.items()}
            stats["n_action_tokens"] = amask.sum()
            return loss, stats

        actor_loss_fn.wants_token_logprobs = True
        self._loss_fn = actor_loss_fn
        self._prep_fn = make_advantage_prep(self.hp)

    def train_step(
        self, model: Model, data: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict[str, float]:
        hp = self.hp
        if hp.group_adv_norm:
            raise NotImplementedError(
                "group_adv_norm runs on the host advantage path "
                "(compute_advantages_and_returns, normalize_advantages, "
                "train_batch), which a later slice of the port brings"
            )
        engine = model.module
        skip_rule = (
            "importance_weight_sum", "n_action_tokens",
            hp.early_stop_imp_ratio or 0.0,
        )
        agg: Dict[str, float] = {}
        n_steps = 0
        # Request at least ppo_n_minibatches micro-batches from the packer,
        # or the PPO minibatch loop (reference ppo_interface.py:698) would
        # collapse into a single optimizer step.
        ub = engine.upload_uniform(data, dataclasses.replace(
            mb_spec, n_mbs=max(mb_spec.n_mbs or 1, hp.ppo_n_minibatches)
        ))
        scalars = engine.run_prep(ub, self._prep_fn,
                                  scalars={"kl_coef": self.kl_ctl.value})
        k = min(hp.ppo_n_minibatches, ub.n_mbs)
        # Contiguous micro-batch groups, one optimizer step each.
        bounds = np.linspace(0, ub.n_mbs, k + 1).astype(int)
        groups = [list(range(bounds[i], bounds[i + 1]))
                  for i in range(k) if bounds[i + 1] > bounds[i]]
        mean_kl = adv_scale = 0.0
        for g in groups:
            stats = engine.train_uniform(
                ub, self._loss_fn, _action_token_weight, mb_indices=g,
                skip_update_rule=skip_rule,
                extra_fetch={"_mean_kl": scalars["_mean_kl"],
                             "_adv_scale": scalars["_adv_scale"]},
            )
            mean_kl = stats.pop("_mean_kl")
            adv_scale = stats.pop("_adv_scale")
            n_steps += 1
            for key, v in stats.items():
                agg[key] = agg.get(key, 0.0) + float(v)
            if stats.get("update_applied", 1.0) == 0.0:
                n = max(stats.get("n_action_tokens", 1.0), 1.0)
                imp = stats.get("importance_weight_sum", 0.0) / n
                logger.warning(
                    f"early-stopping PPO minibatches: importance ratio "
                    f"{imp:.2f} > {hp.early_stop_imp_ratio} (update skipped)"
                )
                break
        self.kl_ctl.update(mean_kl, n_steps=1)
        # Version-staleness of the trained batch, before this step's bump.
        staleness = 0.0
        if "version_start" in data.keys:
            staleness = float(
                model.version.global_step
                - np.mean(np.asarray(data.data["version_start"], np.float64))
            )
        model.inc_version()
        n = max(agg.get("n_action_tokens", 1.0), 1.0)
        rewards_np = np.asarray(data.data["rewards"], np.float32).reshape(-1)
        return {
            "actor_loss": agg.get("loss", 0.0),
            "importance_weight": agg.get("importance_weight_sum", 0.0) / n,
            "clip_ratio": agg.get("clip_ratio_sum", 0.0) / n,
            "dual_clip_ratio": agg.get("dual_clip_ratio_sum", 0.0) / n,
            "mean_kl": mean_kl,
            "kl_coef": self.kl_ctl.value,
            "grad_norm": agg.get("grad_norm", 0.0) / max(n_steps, 1),
            "lr": agg.get("lr", 0.0) / max(n_steps, 1),
            "n_action_tokens": agg.get("n_action_tokens", 0.0),
            "n_ppo_steps": float(n_steps),
            "task_reward": float(rewards_np.mean()),
            "approx_kl": agg.get("approx_kl_sum", 0.0) / n,
            "entropy": agg.get("entropy_sum", 0.0) / n,
            "behav_imp_tail": agg.get("behav_tail_sum", 0.0) / n,
            "reward_std": float(rewards_np.std()),
            "adv_scale": float(adv_scale),
            "staleness_lag": staleness,
        }

    def state_dict(self):
        return {"kl_ctl": getattr(self.kl_ctl, "_value", self.kl_ctl.value)}

    def load_state_dict(self, d):
        if hasattr(self.kl_ctl, "_value"):
            self.kl_ctl._value = d["kl_ctl"]


def _action_token_weight(mb: mbu.MicroBatch) -> float:
    return float(_action_mask(mb.grids).sum())


def attach_keys(data: SequenceSample, extra: Dict[str, np.ndarray]) -> SequenceSample:
    """New sample with full-length per-token keys added (non-mutating)."""
    sls = data.seqlens["packed_input_ids"]
    return SequenceSample(
        ids=list(data.ids),
        keys=set(data.keys) | set(extra.keys()),
        seqlens={**data.seqlens, **{k: [list(s) for s in sls] for k in extra}},
        data={**data.data, **extra},
        metadata=data.metadata,
    )
