"""PPO actor and critic interfaces — the algorithm layer of the trainer.

Counterpart of ``areal_tpu/algorithms/ppo.py``: ``PPOHyperparameters:55``,
``RunningMoments:88`` (value normalisation), the host advantage path
(``compute_advantages_and_returns:142`` with GAE through ``gae_grid`` on the
engine's device, ``normalize_advantages:293`` global or per prompt group),
``make_advantage_prep:219``, ``PPOActorInterface:326`` (``generate:370``,
``inference:393``, ``train_step:407`` on the uniform fast path or, with
``group_adv_norm``, the host path through ``train_batch``, ``save:555``),
the post hooks, ``PPOCriticInterface:606``,
``trajectories_from_gen_output:709`` and ``LogprobInterface:772``.

Data contract (every per-token key full-length aligned to
``packed_input_ids``; see backend/microbatch.py): ``prompt_mask`` (1 on
prompt tokens), ``packed_logprobs`` (behaviour-policy logprob of token t at
slot t, 0 on prompt slots and each doc's first token), optional
``prox_logprobs``, ``packed_ref_logprobs`` and ``values``; per sample
``rewards`` and ``seq_no_eos_mask``. Generated groups are flattened into
independent samples (ids ``"qid@k"``, metadata ``group``), as there.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from areal_tpu_torch import resolve_device
from areal_tpu_torch.algorithms import ppo_functional as F
from areal_tpu_torch.api.cli_args import PPOHyperparameters
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model import (
    Model,
    ModelInterface,
    register_interface,
)
from areal_tpu_torch.backend import microbatch as mbu
from areal_tpu_torch.models import hf

logger = logging.getLogger("areal_tpu_torch.algorithms.ppo")


class RunningMoments:
    """EMA mean/std for value normalization (reference rms.py)."""

    def __init__(self, beta: float = 0.99995, eps: float = 1e-5):
        self.beta = beta
        self.eps = eps
        self.mean = 0.0
        self.mean_sq = 1.0
        self._initialized = False

    def update(self, x: np.ndarray, mask: np.ndarray) -> None:
        m = mask.astype(bool)
        if m.sum() == 0:
            return
        bm, bsq = float(x[m].mean()), float((x[m] ** 2).mean())
        if not self._initialized:
            self.mean, self.mean_sq = bm, bsq
            self._initialized = True
        else:
            # EMA of mean and mean-square: the variance E[x^2]-E[x]^2 then
            # includes batch-mean drift.
            self.mean = self.beta * self.mean + (1 - self.beta) * bm
            self.mean_sq = self.beta * self.mean_sq + (1 - self.beta) * bsq

    @property
    def var(self) -> float:
        return max(self.mean_sq - self.mean**2, self.eps)

    def normalize(self, x):
        return (x - self.mean) / np.sqrt(self.var + self.eps)

    def denormalize(self, x):
        return x * np.sqrt(self.var + self.eps) + self.mean

    def state_dict(self):
        return {"mean": self.mean, "mean_sq": self.mean_sq,
                "initialized": self._initialized}

    def load_state_dict(self, d):
        self.mean, self.mean_sq = d["mean"], d["mean_sq"]
        self._initialized = d["initialized"]


def _action_mask(grids: Dict[str, np.ndarray]) -> np.ndarray:
    """Host-side view of the shared loss mask (ppo_functional)."""
    return F.action_token_mask(grids["segment_ids"], grids["prompt_mask"])


def compute_advantages_and_returns(
    sample: SequenceSample, hp: PPOHyperparameters, kl_coef: float,
    device=None,
) -> Dict[str, np.ndarray]:
    """Full-batch grid pass: KL-shaped token rewards → GAE on ``device``
    (cuda unless named). Returns packed 1-D arrays keyed advantages /
    returns / kl_rewards, plus ``_mean_kl``."""
    device = resolve_device(device)
    mb = mbu.make_microbatch(sample, length_bucket=64, rows_bucket=1,
                             seqs_bucket=1)
    g = mb.grids
    amask = _action_mask(g)
    behav = g["packed_logprobs"]
    ref = g.get("packed_ref_logprobs", np.zeros_like(behav))
    kl = (behav - ref) * amask  # k1 estimator
    values = g.get("values", np.zeros_like(behav)) * (g["segment_ids"] > 0)

    score = np.asarray(sample.data["rewards"], np.float32).reshape(-1)
    no_eos = (
        np.asarray(sample.data["seq_no_eos_mask"]).reshape(-1) > 0
        if "seq_no_eos_mask" in sample.keys else np.zeros(sample.bs, bool)
    )
    if hp.mask_no_eos_with_zero:
        score = np.where(no_eos, 0.0, score)
    n = mb.n_seqs
    # The KL-only penalty is the logged kl_rewards key (taken before the
    # task score lands).
    kl_rw = (-kl_coef * kl * amask).astype(np.float32)
    tok_score = np.clip(
        (score - hp.reward_output_bias) * hp.reward_output_scaling,
        -hp.max_reward_clip, hp.max_reward_clip,
    )
    rows, lasts = mb.seq_rows[:n], mb.seq_last_cols[:n]
    rewards = kl_rw.copy()
    rewards[rows, lasts] += tok_score
    # The baseline of the action at slot t is V at slot t-1 (the state
    # before it): shift the values right inside each document BEFORE the
    # action mask restricts the grid, or each sequence's first action
    # token loses its baseline.
    v_prev = F.shift_right_in_doc(values, g["segment_ids"])
    # The last action's next value is V at the final token, kept only when
    # generation was truncated (no EOS).
    boot = np.zeros_like(values)
    boot[rows, lasts] = values[rows, lasts] * no_eos
    act_seg = np.where(amask, g["segment_ids"], 0)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    adv, ret = F.gae_grid(dev(rewards), dev(v_prev), dev(act_seg),
                          bootstrap=dev(boot), gamma=hp.discount,
                          lam=hp.gae_lambda)
    adv, ret = adv.cpu().numpy(), ret.cpu().numpy()
    out = {}
    for key, grid in (("advantages", adv), ("returns", ret),
                      ("kl_rewards", kl_rw)):
        out[key] = np.concatenate(
            mbu.scatter_back([mb], [grid], sample.bs)).astype(np.float32)
    out["_mean_kl"] = float(kl.sum() / max(amask.sum(), 1))
    return out


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


def _group_keys(sample: SequenceSample) -> List[str]:
    if "group" in sample.metadata:
        return [str(x) for x in sample.metadata["group"]]
    return [str(i).rsplit("@", 1)[0] for i in sample.ids]


def normalize_advantages(sample: SequenceSample, hp: PPOHyperparameters) -> None:
    """In-place advantage whitening: global, or per prompt group (GRPO)."""
    adv = sample.data["advantages"]
    # Includes each doc's first token, whose advantage is 0 anyway.
    amask_packed = (1 - np.asarray(sample.data["prompt_mask"])) > 0
    if hp.group_adv_norm:
        groups = _group_keys(sample)
        offs = sample.offsets("advantages")
        lens = [int(x) for x in sample.total_lens("advantages")]
        for gkey in set(groups):
            idx = [i for i, g in enumerate(groups) if g == gkey]
            sel = np.concatenate([np.arange(offs[i], offs[i] + lens[i])
                                  for i in idx])
            m = amask_packed[sel]
            vals = adv[sel]
            mu = vals[m].mean() if m.any() else 0.0
            sd = vals[m].std() + 1e-5
            adv[sel] = np.where(m, (vals - mu) / sd, 0.0)
    else:
        m = amask_packed
        mu = adv[m].mean() if m.any() else 0.0
        sd = adv[m].std() + 1e-5
        sample.data["advantages"] = np.where(
            m, (adv - mu) / sd, 0.0).astype(np.float32)


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
        self._gen_calls = 0

    # ---- MFC methods ----

    def generate(
        self, model: Model, data: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        """Prompt batch → flattened trajectory batch (group_size per
        prompt). The draws come from a generator seeded with the model
        version and this interface's call count."""
        hp = self.hp
        engine = model.module
        eos = getattr(model.tokenizer, "eos_token_id", 1) or 1
        pad = getattr(model.tokenizer, "pad_token_id", 0) or 0
        gconfig = dataclasses.replace(hp.gen, n=hp.group_size)
        gen = torch.Generator(device=engine.device).manual_seed(
            (model.version.global_step << 32) + self._gen_calls)
        self._gen_calls += 1
        out = engine.generate(data, mb_spec, gconfig, generator=gen,
                              eos_token_id=eos, pad_token_id=pad)
        return trajectories_from_gen_output(
            data, out, group_size=hp.group_size,
            version=model.version.global_step, eos_token_id=eos,
        )

    def inference(
        self, model: Model, data: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        """Recompute logprobs under the current policy → prox_logprobs."""
        return _logprob_sample(model, data, mb_spec, "prox_logprobs")

    def train_step(
        self, model: Model, data: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict[str, float]:
        hp = self.hp
        engine = model.module
        skip_rule = (
            "importance_weight_sum", "n_action_tokens",
            hp.early_stop_imp_ratio or 0.0,
        )
        agg: Dict[str, float] = {}
        n_steps = 0
        mean_kl = adv_scale = 0.0

        def record(stats: Dict[str, float]) -> bool:
            """Sum one optimizer step's stats; False once the skip rule
            fired (the remaining minibatches are abandoned)."""
            nonlocal n_steps
            n_steps += 1
            for key, v in stats.items():
                agg[key] = agg.get(key, 0.0) + float(v)
            if stats.get("update_applied", 1.0) != 0.0:
                return True
            n = max(stats.get("n_action_tokens", 1.0), 1.0)
            imp = stats.get("importance_weight_sum", 0.0) / n
            logger.warning(
                f"early-stopping PPO minibatches: importance ratio "
                f"{imp:.2f} > {hp.early_stop_imp_ratio} (update skipped)"
            )
            return False

        if not hp.group_adv_norm:
            # Request at least ppo_n_minibatches micro-batches from the
            # packer, or the PPO minibatch loop (reference
            # ppo_interface.py:698) would collapse into one optimizer step.
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
            for g in groups:
                stats = engine.train_uniform(
                    ub, self._loss_fn, _action_token_weight, mb_indices=g,
                    skip_update_rule=skip_rule,
                    extra_fetch={"_mean_kl": scalars["_mean_kl"],
                                 "_adv_scale": scalars["_adv_scale"]},
                )
                mean_kl = stats.pop("_mean_kl")
                adv_scale = stats.pop("_adv_scale")
                if not record(stats):
                    break
        else:
            # The host path: GAE over the whole batch, per-group whitening,
            # then ppo_n_minibatches token-balanced minibatches through
            # train_batch, one optimizer step each.
            extra = compute_advantages_and_returns(
                data, hp, self.kl_ctl.value, device=engine.device)
            mean_kl = extra.pop("_mean_kl")
            # Raw advantage scale before whitening; the prompt mask is the
            # action mask here (doc-first advantages are 0).
            am = (1 - np.asarray(data.data["prompt_mask"])) > 0
            if am.any():
                adv_scale = float(np.abs(extra["advantages"][am]).mean())
            data = attach_keys(data, extra)
            normalize_advantages(data, hp)
            minibatches, _ = data.split(k=min(hp.ppo_n_minibatches, data.bs))
            for mb_sample in minibatches:
                if mb_sample.bs == 0:
                    continue
                stats = engine.train_batch(
                    mb_sample, mb_spec, self._loss_fn, _action_token_weight,
                    version_steps=model.version.global_step,
                    skip_update_rule=skip_rule,
                )
                if not record(stats):
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
        # an MoE actor's routing stats, a mean over the optimizer steps
        moe_stats = {k: v / max(n_steps, 1) for k, v in agg.items()
                     if k.startswith("moe_")}
        rewards_np = np.asarray(data.data["rewards"], np.float32).reshape(-1)
        return {
            **moe_stats,
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

    def save(self, model: Model, save_dir: str) -> None:
        """HF checkpoint of the masters (what the trainer's model factory
        and the evaluation tools load)."""
        engine = model.module
        hf.save_hf_checkpoint(engine.params, engine.cfg, save_dir,
                              meta={"version": model.version.global_step})

    def state_dict(self):
        return {"kl_ctl": getattr(self.kl_ctl, "_value", self.kl_ctl.value)}

    def load_state_dict(self, d):
        if hasattr(self.kl_ctl, "_value"):
            self.kl_ctl._value = d["kl_ctl"]


def _logprob_hook(logits, batch):
    if logits.dim() == 2:  # the engine's chunked head already did it
        return logits
    return F.token_logprobs_from_logits(logits, batch["tokens"],
                                        batch["segment_ids"])


_logprob_hook.wants_token_logprobs = True


def _values_hook(values, batch):
    # the critic's forward output is [R, L] already
    return values * (batch["segment_ids"] > 0)


def _per_token_sample(data: SequenceSample, key: str,
                      values: np.ndarray) -> SequenceSample:
    return SequenceSample(
        ids=list(data.ids), keys={key},
        seqlens={key: [list(s) for s in data.seqlens["packed_input_ids"]]},
        data={key: values},
    )


def _logprob_sample(model: Model, data: SequenceSample,
                    mb_spec: MicroBatchSpec, key: str) -> SequenceSample:
    per_sample = model.module.forward(data, mb_spec, post_hook=_logprob_hook)
    return _per_token_sample(data, key,
                             np.concatenate(per_sample).astype(np.float32))


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


# ---------------- critic ----------------

class PPOCriticInterface(ModelInterface):
    def __init__(self, hp: Optional[PPOHyperparameters] = None, **kw):
        self.hp = hp or PPOHyperparameters(**kw)
        self.rms = RunningMoments(self.hp.value_norm_beta,
                                  self.hp.value_norm_eps)
        hp_ = self.hp

        def critic_loss_fn(values, batch):
            amask = F.action_token_mask(batch["segment_ids"],
                                        batch["prompt_mask"])
            # Returns at action slot t target the pre-action value V_{t-1}:
            # both the fresh values and the stored clip baseline shift right
            # by one inside each doc before the loss.
            seg = batch["segment_ids"]
            loss, st = F.critic_loss(
                F.shift_right_in_doc(values, seg),
                F.shift_right_in_doc(batch["values"], seg),
                batch["_norm_returns"], amask,
                value_eps_clip=hp_.value_eps_clip, loss_scale=1.0,
            )
            return loss, {"value_clip_ratio_sum": st["value_clip_ratio"],
                          "n_action_tokens": amask.sum()}

        self._loss_fn = critic_loss_fn

    def inference(
        self, model: Model, data: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        """Critic forward → denormalized per-token values."""
        per_sample = model.module.forward(data, mb_spec, post_hook=_values_hook)
        vals = np.concatenate(per_sample).astype(np.float32)
        if self.hp.value_norm:
            vals = self.rms.denormalize(vals).astype(np.float32)
        return _per_token_sample(data, "values", vals)

    def train_step(
        self, model: Model, data: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict[str, float]:
        hp = self.hp
        engine = model.module
        extra = compute_advantages_and_returns(data, hp, 0.0,
                                               device=engine.device)
        extra.pop("_mean_kl")
        returns = extra["returns"]
        amask = (1 - np.asarray(data.data["prompt_mask"])) > 0
        if hp.value_norm:
            self.rms.update(returns, amask)
            extra["_norm_returns"] = self.rms.normalize(returns).astype(
                np.float32)
        else:
            extra["_norm_returns"] = returns
        # The critic trains in normalized space; its stored values (the
        # clip baseline) are normalized the same way.
        if hp.value_norm and "values" in data.keys:
            data = attach_keys(data, {"values": self.rms.normalize(
                np.asarray(data.data["values"])).astype(np.float32)})
        data = attach_keys(data, extra)
        minibatches, _ = data.split(k=min(hp.ppo_n_minibatches, data.bs))
        agg: Dict[str, float] = {}
        n_steps = 0
        for mb_sample in minibatches:
            if mb_sample.bs == 0:
                continue
            stats = engine.train_batch(
                mb_sample, mb_spec, self._loss_fn, _action_token_weight,
                version_steps=model.version.global_step,
            )
            n_steps += 1
            for k, v in stats.items():
                agg[k] = agg.get(k, 0.0) + float(v)
        model.inc_version()
        n = max(agg.get("n_action_tokens", 1.0), 1.0)
        return {
            "critic_loss": agg.get("loss", 0.0),
            "value_clip_ratio": agg.get("value_clip_ratio_sum", 0.0) / n,
            "grad_norm": agg.get("grad_norm", 0.0) / max(n_steps, 1),
            "value_mean": float(self.rms.mean),
            "value_var": float(self.rms.var),
        }

    def state_dict(self):
        return {"rms": self.rms.state_dict()}

    def load_state_dict(self, d):
        self.rms.load_state_dict(d["rms"])


def trajectories_from_gen_output(
    prompts: SequenceSample,
    gen_out: Dict[str, np.ndarray],
    group_size: int,
    version: int,
    eos_token_id: int = 1,
) -> SequenceSample:
    """Flattened trajectory samples from ``engine.generate``'s output."""
    offs = prompts.offsets("packed_prompts")
    plens = prompts.total_lens("packed_prompts")
    ids, seqlens = [], []
    toks, pmask, lps = [], [], []
    n_eos = []
    for i in range(prompts.bs):
        prompt = prompts.data["packed_prompts"][offs[i]:offs[i] + plens[i]]
        for j in range(group_size):
            r = i * group_size + j
            gl = max(int(gen_out["output_lens"][r]), 1)
            g_toks = gen_out["output_ids"][r][:gl]
            ids.append(f"{prompts.ids[i]}@{j}")
            seqlens.append(len(prompt) + gl)
            toks.append(np.concatenate([prompt, g_toks]))
            pmask.append(np.concatenate([np.ones(len(prompt), np.int32),
                                         np.zeros(gl, np.int32)]))
            lps.append(np.concatenate([np.zeros(len(prompt), np.float32),
                                       gen_out["output_logprobs"][r][:gl]]))
            # Truncated iff EOS never appeared among the emitted tokens.
            n_eos.append(float(eos_token_id not in g_toks))
    md_task = prompts.metadata.get("task", ["math"] * prompts.bs)
    return SequenceSample.from_default(
        ids=ids,
        data={
            "packed_input_ids": np.concatenate(toks).astype(np.int32),
            "prompt_mask": np.concatenate(pmask),
            "packed_logprobs": np.concatenate(lps).astype(np.float32),
            "seq_no_eos_mask": np.asarray(n_eos, np.float32),
            "task_ids": np.repeat(np.asarray(prompts.data.get(
                "task_ids", np.zeros(prompts.bs, np.int32))).reshape(-1),
                group_size),
            "version_start": np.full(len(ids), version, np.int32),
            "version_end": np.full(len(ids), version, np.int32),
        },
        seqlens=seqlens,
        metadata={
            "group": [str(prompts.ids[i]) for i in range(prompts.bs)
                      for _ in range(group_size)],
            "task": [md_task[i] for i in range(prompts.bs)
                     for _ in range(group_size)],
        },
    )


class LogprobInterface(ModelInterface):
    """Frozen-model logprob recompute (the ref_inf MFC: the actor's
    ``inference`` on the reference policy under another output key)."""

    def __init__(self, output_key: str = "packed_ref_logprobs"):
        self.output_key = output_key

    def inference(
        self, model: Model, data: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        return _logprob_sample(model, data, mb_spec, self.output_key)


register_interface("ppo_actor", PPOActorInterface)
register_interface("ppo_critic", PPOCriticInterface)
register_interface("ref_logprob", LogprobInterface)
