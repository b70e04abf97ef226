"""The PyTorch train engine — counterpart of ``areal_tpu/backend/jax_train.py``
(``JaxTrainEngine``, ``JaxTrainBackend``).

 - f32 master parameters live on the device as leaf tensors; every grad
   step casts them to the compute dtype *inside* the differentiated
   function (``_cast:291``: ``torch.func.functional_call`` over ``.to()``
   copies), so the gradients arrive in f32, as in the reference, and
   accumulate over the micro-batches in the masters' ``.grad``.
 - The whole batch is packed once and uploaded once as ``[n_mbs·R, L]``
   grids (``upload_uniform:516``); the advantage prep runs over it on the
   device (``run_prep:558``); each micro-batch's grad step slices its rows
   there (``_get_sliced_grad_fn:587``).
 - ``train_uniform:654`` takes one optimizer step with one host sync: the
   stats, the loss and the pre-clip global grad norm come back together,
   then the skip rule (``:478-490``) decides on the host whether the update
   is applied. A skipped update leaves the parameters, the moments and the
   step count as they were.
 - The optimizer is the reference's optax chain written out on
   ``torch._foreach_*`` (``build_optimizer:128``, ``scale_by_adam_mixed:77``):
   clip by global norm, Adam with its moment math in f32 and the moments
   stored in ``mu_dtype``/``nu_dtype``, ``+ weight_decay·param``, ``×
   −lr(count)`` with the schedule read at the pre-increment count.
   ``torch.optim.AdamW`` orders these steps differently and cannot keep
   bf16 moments with f32 math.
 - The log-prob head is chunked over columns, each chunk under
   ``torch.utils.checkpoint`` (``_forward_token_logprobs:321``): the
   ``[R, L, V]`` logits never exist at once, forward or backward. A
   critic's values ``[R, L]`` come out of the model and are cast to f32.
 - ``train_batch`` (reference ``:802``) packs its sample per call and runs
   ``train_uniform`` over every micro-batch: one copy of the optimizer
   step and its skip rule.
 - ``forward`` (``:1010``) runs under ``torch.no_grad()`` without remat,
   fetches once per micro-batch and returns per-sample arrays
   (``scatter_back``); ``generate`` (``:1057``) runs ``models/generate.py``
   over compute-dtype copies, its draws from a ``torch.Generator``.
 - ``save_train_state`` / ``load_train_state`` (``:924``, ``:983``) keep the
   masters, the Adam moments in their stored dtype and the step count,
   each entry named by its state-dict name (the reference uses leaf
   positions, so a train state does not cross packages).
 - ``TorchTrainBackend(train=False)`` (``"torch_inference"``) keeps the
   parameters in their own dtype and builds no optimizer.

Not ported yet: meshes and MoE.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from areal_tpu_torch import resolve_device
from areal_tpu_torch.algorithms import ppo_functional as PF
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model import (
    FinetuneSpec,
    GenerationHyperparameters,
    Model,
    ModelBackend,
    TrainableEngine,
    register_backend,
)
from areal_tpu_torch.api.train_config import OptimizerConfig
from areal_tpu_torch.backend import microbatch as mbu
from areal_tpu_torch.base import safetensors_io as sio
from areal_tpu_torch.models import generate as genmod
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.packing import round_up
from areal_tpu_torch.models.transformer import (
    Transformer,
    head_logits,
    head_param_name,
)
from areal_tpu_torch.ops.xent import gather_logprobs

# Loss functions receive (logits or [R, L] logprobs, batch) and return
# (loss_sum, stats-sums).
LossFn = Callable[[torch.Tensor, Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


# ---------------- lr schedule ----------------

def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule."""
    def f(count: int) -> float:
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return f


def _cosine(init: float, steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule."""
    def f(count: int) -> float:
        cosine = 0.5 * (1 + math.cos(math.pi * min(count, steps) / steps))
        return init * ((1 - alpha) * cosine + alpha)
    return f


def build_lr_schedule(cfg: OptimizerConfig,
                      total_steps: int) -> Callable[[int], float]:
    """Warmup + {constant, cosine, linear} decay to min_lr_ratio·lr, as a
    function of the optimizer step count (reference
    ``build_lr_schedule:54``)."""
    total_steps = max(total_steps, 1)
    warmup = int(cfg.warmup_steps_proportion * total_steps)
    rest = max(total_steps - warmup, 1)
    if cfg.lr_scheduler_type == "cosine":
        decay = _cosine(cfg.lr, rest, cfg.min_lr_ratio)
    elif cfg.lr_scheduler_type == "linear":
        decay = _linear(cfg.lr, cfg.lr * cfg.min_lr_ratio, rest)
    else:
        def decay(count: int) -> float:
            return cfg.lr
    if warmup <= 0:
        return decay
    warm = _linear(0.0, cfg.lr, warmup)
    return lambda count: warm(count) if count < warmup else decay(count - warmup)


# ---------------- optimizer ----------------

def _dtype(name: Optional[str], default: torch.dtype) -> torch.dtype:
    return getattr(torch, name) if name else default


class Optimizer:
    """The reference's optimizer chain (``build_optimizer:128``) as one
    update over lists of tensors: clip by global norm
    (``gradient_clipping``), then AdamW (``scale_by_adam_mixed:77`` +
    ``add_decayed_weights`` + ``scale_by_learning_rate``) or SGD. ``count``
    is the number of applied updates: Adam's bias-correction count and the
    schedule's step."""

    def __init__(self, cfg: OptimizerConfig, params: List[torch.Tensor],
                 total_steps: int):
        if cfg.type not in ("adamw", "sgd"):
            raise ValueError(f"unknown optimizer type {cfg.type!r}")
        self.cfg = cfg
        self.lr_schedule = build_lr_schedule(cfg, total_steps)
        self.count = 0
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []
        if cfg.type == "adamw":
            self.mu = [torch.zeros_like(p, dtype=_dtype(cfg.mu_dtype, p.dtype))
                       for p in params]
            self.nu = [torch.zeros_like(p, dtype=_dtype(cfg.nu_dtype, p.dtype))
                       for p in params]

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             grad_norm: torch.Tensor, grad_norm_host: float) -> None:
        """One update in place: ``grads`` (f32, consumed) into ``params``.
        ``grad_norm`` is the device global norm; its host copy picks the
        clip branch, as the reference's ``select`` does on the device."""
        cfg = self.cfg
        clip = cfg.gradient_clipping
        if clip and clip > 0 and not grad_norm_host < clip:
            torch._foreach_div_(grads, grad_norm)
            torch._foreach_mul_(grads, clip)
        lr = self.lr_schedule(self.count)
        if cfg.type == "sgd":
            torch._foreach_add_(params, grads, alpha=-lr)
            self.count += 1
            return
        b1, b2 = cfg.beta1, cfg.beta2
        f32 = torch.float32
        mu = [m.to(f32) for m in self.mu]  # the same tensors when stored in f32
        nu = [n.to(f32) for n in self.nu]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        count = np.float32(self.count + 1)
        bc1 = float(np.float32(1) - np.float32(b1) ** count)
        bc2 = float(np.float32(1) - np.float32(b2) ** count)
        upd = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        torch._foreach_div_(upd, den)
        del den
        if cfg.weight_decay:
            torch._foreach_add_(upd, params, alpha=cfg.weight_decay)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)
        for store, new in zip(self.mu + self.nu, mu + nu):
            if store is not new:
                store.copy_(new)
        self.count += 1


# ---------------- the engine ----------------

@dataclasses.dataclass
class UniformBatch:
    """A whole batch resident on the device as one ``[n_mbs·R, L]`` grid set.

    ``grids``: per-token keys (+ prep outputs); ``seq``: ``[n_mbs, S]``
    stacked per-micro-batch sequence arrays (grid coordinates, masks,
    scalar keys). Host-side layouts stay in ``mbs``."""

    mbs: List[mbu.MicroBatch]
    R: int
    L: int
    S: int
    grids: Dict[str, torch.Tensor]
    seq: Dict[str, torch.Tensor]

    @property
    def n_mbs(self) -> int:
        return len(self.mbs)


def _chunk_scores(h_c: torch.Tensor, labels_c: torch.Tensor,
                  head: torch.Tensor) -> torch.Tensor:
    return gather_logprobs(head_logits(h_c, head), labels_c)


class TorchTrainEngine(TrainableEngine):
    """Owns the f32 masters and the optimizer state on one device."""

    def __init__(
        self,
        cfg: TransformerConfig,
        params: Dict[str, torch.Tensor],  # a Transformer state dict
        opt_cfg: Optional[OptimizerConfig] = None,
        ft_spec: Optional[FinetuneSpec] = None,
        device=None,
        compute_dtype: str = "bfloat16",
        length_bucket: int = 128,
        rows_bucket: int = 8,
        seqs_bucket: int = 8,
        attn_impl: str = "auto",
        remat=False,
        logprob_chunk: Optional[int] = 512,
        fill_bucket: Optional[int] = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = getattr(torch, compute_dtype)
        self.length_bucket = length_bucket
        self.rows_bucket = rows_bucket
        self.seqs_bucket = seqs_bucket
        self.fill_bucket = fill_bucket
        self.attn_impl = attn_impl
        self.remat = remat
        self.logprob_chunk = logprob_chunk
        # The module holds no weights: every forward runs it through
        # functional_call over compute-dtype copies of self.params.
        self.model = Transformer(cfg, device="meta")
        expected = set(self.model.state_dict())
        if set(params) != expected:
            raise KeyError(f"params do not match the model: missing "
                           f"{sorted(expected - set(params))}, unexpected "
                           f"{sorted(set(params) - expected)}")
        train = opt_cfg is not None
        # Training keeps explicit f32 masters: bf16 rounds away small Adam
        # updates; compute still runs in compute_dtype.
        self.params = {
            n: t.detach().to(
                self.device,
                torch.float32 if train and t.is_floating_point() else t.dtype,
            ).requires_grad_(train)
            for n, t in params.items()
        }
        self.optimizer = None
        if train:
            total = ft_spec.total_train_steps if ft_spec is not None else 1000
            self.optimizer = Optimizer(opt_cfg, list(self.params.values()),
                                       total)
        # With time_phases, train_uniform synchronizes after the fwd-bwd and
        # after the optimizer and records both times in last_phase_secs.
        self.time_phases = False
        self.last_phase_secs: Dict[str, float] = {}

    @property
    def opt_step_count(self) -> int:
        return self.optimizer.count if self.optimizer is not None else 0

    @property
    def lr_schedule(self) -> Callable[[int], float]:
        return self.optimizer.lr_schedule

    # -------------- internals --------------

    def _cast(self) -> Dict[str, torch.Tensor]:
        cd = self.compute_dtype
        return {n: p.to(cd) if p.is_floating_point() else p
                for n, p in self.params.items()}

    def _hidden_or_logits(self, cast, batch, return_hidden: bool, remat):
        """The model's final hidden, logits, or a critic's values (cast to
        f32 after the head, as the reference does)."""
        out, _ = torch.func.functional_call(
            self.model, cast, (batch["tokens"], batch["positions"]),
            dict(segment_ids=batch["segment_ids"], attn_impl=self.attn_impl,
                 remat=remat, return_kv=False, return_hidden=return_hidden),
        )
        return out.float() if self.cfg.is_critic and not return_hidden else out

    def _forward_token_logprobs(self, cast, batch, remat) -> torch.Tensor:
        """[R, L] per-token logprobs through the chunked head: each column
        chunk computes its logits and gathers its scores under checkpoint,
        so the backward recomputes the chunk's logits instead of keeping
        them (the head matmul is redone once). Without grad, the chunks just
        run one after another."""
        h = self._hidden_or_logits(cast, batch, return_hidden=True, remat=remat)
        L = h.shape[1]
        labels = PF.next_token_labels(batch["tokens"])
        C = self.logprob_chunk or L
        if L % C != 0:
            C = L  # bucketing guarantees divisibility in practice
        head = cast[head_param_name(self.cfg)]
        grad = torch.is_grad_enabled()
        s = torch.cat([
            checkpoint(_chunk_scores, h[:, c:c + C], labels[:, c:c + C], head,
                       use_reentrant=False) if grad
            else _chunk_scores(h[:, c:c + C], labels[:, c:c + C], head)
            for c in range(0, L, C)
        ], dim=1)
        return PF.shift_mask_scores(s, batch["segment_ids"])

    def _use_chunked_logprobs(self, fn) -> bool:
        return (
            self.logprob_chunk is not None
            and not self.cfg.is_critic
            and bool(getattr(fn, "wants_token_logprobs", False))
        )

    @staticmethod
    def _slice(ub: UniformBatch, i: int) -> Dict[str, torch.Tensor]:
        batch = {k: g[i * ub.R:(i + 1) * ub.R] for k, g in ub.grids.items()}
        batch.update({k: v[i] for k, v in ub.seq.items()})
        return batch

    def _grad_step(self, ub, loss_fn, i, denom, scale):
        """One micro-batch: forward, loss, backward into the masters'
        ``.grad`` (which sums over the micro-batches)."""
        batch = self._slice(ub, i)
        cast = self._cast()
        if self._use_chunked_logprobs(loss_fn):
            out = self._forward_token_logprobs(cast, batch, self.remat)
        else:
            out = self._hidden_or_logits(cast, batch, return_hidden=False,
                                         remat=self.remat)
        loss_sum, stats = loss_fn(out, batch)
        loss = loss_sum / max(denom, 1.0)
        (loss * scale if scale != 1.0 else loss).backward()
        return loss.detach() * scale, {k: v.detach() for k, v in stats.items()}

    def accumulate_grads(self, ub: UniformBatch, loss_fn: LossFn,
                         idxs: List[int], weights: List[float],
                         glob: bool = True):
        """Gradients of the micro-batches ``idxs`` summed into the masters'
        ``.grad``; returns the summed (loss, stats)."""
        total_w = sum(weights)
        scale = 1.0 if glob else 1.0 / len(idxs)
        for p in self.params.values():
            p.grad = None
        loss_acc, stats_acc = None, {}
        for i, w in zip(idxs, weights):
            loss, stats = self._grad_step(ub, loss_fn, i,
                                          total_w if glob else w, scale)
            loss_acc = loss if loss_acc is None else loss + loss_acc
            stats_acc = {k: stats[k] + stats_acc[k] if k in stats_acc
                         else stats[k] for k in stats}
        return loss_acc, stats_acc

    # -------------- upload-once uniform batches --------------

    def upload_uniform(self, input_: SequenceSample,
                       mb_spec: MicroBatchSpec) -> UniformBatch:
        """Pack the whole batch into micro-batches of one ``[R, L]`` shape
        and upload it to the device once."""
        mbs = mbu.split_into_microbatches(
            input_, mb_spec, length_bucket=self.length_bucket,
            rows_bucket=self.rows_bucket, seqs_bucket=self.seqs_bucket,
            fill_bucket=self.fill_bucket,
        )
        R, L = mbs[0].layout.shape
        S = round_up(max(len(mb.seq_mask) for mb in mbs), self.seqs_bucket)

        def up(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        grids = {k: up(np.concatenate([mb.grids[k] for mb in mbs], axis=0))
                 for k in mbs[0].grids}

        def pad_stack(getter) -> torch.Tensor:
            rows = []
            for mb in mbs:
                v = np.asarray(getter(mb))
                pad = np.zeros((S,) + v.shape[1:], v.dtype)
                pad[: len(v)] = v
                rows.append(pad)
            return up(np.stack(rows))

        seq = {
            "seq_rows": pad_stack(lambda mb: mb.seq_rows),
            "seq_first_cols": pad_stack(lambda mb: mb.seq_first_cols),
            "seq_last_cols": pad_stack(lambda mb: mb.seq_last_cols),
            "seq_mask": pad_stack(lambda mb: mb.seq_mask),
        }
        for k in mbs[0].scalars:
            seq[k] = pad_stack(lambda mb, k=k: mb.scalars[k])
        return UniformBatch(mbs=mbs, R=R, L=L, S=S, grids=grids, seq=seq)

    @torch.no_grad()
    def run_prep(self, ub: UniformBatch, prep_fn: Callable,
                 scalars: Optional[Dict[str, float]] = None
                 ) -> Dict[str, torch.Tensor]:
        """Full-batch preprocessing on the device:
        ``prep_fn(grids, seq, R, scalars) -> (extra_grids, out_scalars)``.
        The extra grids join ``ub.grids``; the returned scalars stay on the
        device for the end-of-step fetch."""
        sc = {k: torch.tensor(v, dtype=torch.float32, device=self.device)
              for k, v in (scalars or {}).items()}
        extra, out_scalars = prep_fn(ub.grids, ub.seq, ub.R, sc)
        ub.grids.update(extra)
        return out_scalars

    def train_uniform(
        self,
        ub: UniformBatch,
        loss_fn: LossFn,
        loss_weight_fn: Callable[[mbu.MicroBatch], float],
        mb_indices: Optional[List[int]] = None,
        token_normalize_scope: str = "global",
        skip_update_rule: Optional[Tuple[str, str, float]] = None,
        extra_fetch: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, float]:
        """One optimizer step over the micro-batches ``mb_indices`` (default
        all) of an uploaded batch, with one host sync.

        ``loss_fn`` returns the SUM of per-token losses; it is divided by
        the total ``loss_weight_fn`` mass of the step ("global" scope) or of
        each micro-batch ("mb"). ``skip_update_rule=(num_key, den_key,
        cap)`` skips the update when stats[num]/max(stats[den], 1) > cap.
        ``grad_norm`` is the global norm before clipping."""
        if self.optimizer is None:
            raise RuntimeError("engine built without an optimizer")
        idxs = list(mb_indices) if mb_indices is not None else list(range(ub.n_mbs))
        weights = [float(loss_weight_fn(ub.mbs[i])) for i in idxs]
        glob = token_normalize_scope == "global"
        t0 = self._phase_clock()
        loss_acc, stats_acc = self.accumulate_grads(ub, loss_fn, idxs, weights,
                                                    glob)
        params = list(self.params.values())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        fetch = {**stats_acc, **(extra_fetch or {}), "loss": loss_acc,
                 "grad_norm": grad_norm}
        values = torch.stack([v.detach().float().reshape(()) for v in fetch.values()])
        fetched = dict(zip(fetch, values.tolist()))  # the one host sync
        t1 = self._phase_clock()
        apply = True
        if skip_update_rule is not None and skip_update_rule[2]:
            num, den, cap = skip_update_rule
            ratio = fetched[num] / max(fetched[den], 1.0)
            apply = cap <= 0.0 or ratio <= cap
        # The schedule is read at the pre-increment count.
        applied_lr = float(self.lr_schedule(self.opt_step_count))
        if apply:
            self.optimizer.step(params, grads, grad_norm, fetched["grad_norm"])
        for p in params:
            p.grad = None
        t2 = self._phase_clock()
        if self.time_phases:
            self.last_phase_secs = {"fwd_bwd": t1 - t0, "optimizer": t2 - t1}
        out = self._finish_stats(fetched)
        out["update_applied"] = float(apply)
        out["lr"] = applied_lr
        out["total_tokens"] = float(sum(ub.mbs[i].n_tokens for i in idxs))
        out["loss_weight"] = sum(weights)
        return out

    def _phase_clock(self) -> float:
        if not self.time_phases:
            return 0.0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    @staticmethod
    def _finish_stats(fetched: Dict[str, Any]) -> Dict[str, float]:
        """Host-side stat post-processing (reference ``_finish_stats:757``
        without its MoE and telemetry parts)."""
        return {k: float(v) for k, v in fetched.items()}

    # -------------- TrainableEngine API --------------

    def train_batch(
        self,
        input_: SequenceSample,
        mb_spec: MicroBatchSpec,
        loss_fn: LossFn,
        loss_weight_fn: Callable[[mbu.MicroBatch], float],
        token_normalize_scope: str = "global",
        version_steps: int = 0,
        skip_update_rule: Optional[Tuple[str, str, float]] = None,
    ) -> Dict[str, float]:
        """Gradients accumulated over the micro-batches of ``input_``, then
        one optimizer step (reference ``train_batch:802``; see
        :meth:`train_uniform` for the loss scope and the skip rule). The
        sample is packed and uploaded per call."""
        ub = self.upload_uniform(input_, mb_spec)
        return self.train_uniform(
            ub, loss_fn, loss_weight_fn,
            token_normalize_scope=token_normalize_scope,
            skip_update_rule=skip_update_rule,
        )

    @torch.no_grad()
    def forward(
        self,
        input_: SequenceSample,
        mb_spec: MicroBatchSpec,
        output_key: str = "logprobs",
        post_hook: Optional[Callable] = None,
    ) -> List[np.ndarray]:
        """Micro-batched inference without autograd or remat.
        ``post_hook(out, batch)`` maps the model's output (``[R, L]``
        logprobs through the chunked head when the hook declares
        ``wants_token_logprobs``, else logits or a critic's values) to a
        per-token ``[R, L, ...]`` quantity on the device; one fetch per
        micro-batch. Returns per-sample packed arrays in input order."""
        ub = self.upload_uniform(input_, mb_spec)
        use_lp = self._use_chunked_logprobs(post_hook)
        cast = self._cast()
        outs = []
        for i in range(ub.n_mbs):
            batch = self._slice(ub, i)
            if use_lp:
                out = self._forward_token_logprobs(cast, batch, remat=False)
            else:
                out = self._hidden_or_logits(cast, batch, return_hidden=False,
                                             remat=False)
            if post_hook is not None:
                out = post_hook(out, batch)
            if out.dtype == torch.bfloat16:  # numpy has no bf16
                out = out.float()
            outs.append(out.cpu().numpy())
        return mbu.scatter_back(ub.mbs, outs, input_.bs)

    @torch.no_grad()
    def generate(
        self,
        input_: SequenceSample,
        mb_spec: MicroBatchSpec,
        gconfig: GenerationHyperparameters,
        generator: Optional[torch.Generator] = None,
        prompt_key: str = "packed_prompts",
        eos_token_id: int = 1,
        pad_token_id: int = 0,
    ) -> Dict[str, np.ndarray]:
        """In-process generation over compute-dtype copies of the weights;
        ``gconfig.n`` samples per prompt by repeating it. ``generator``
        (on the engine's device) stands in for the reference's PRNG key;
        the default is seeded from the optimizer step count."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                self.opt_step_count)
        offs = input_.offsets(prompt_key)
        lens = input_.total_lens(prompt_key)
        prompts = [input_.data[prompt_key][o:o + n] for o, n in zip(offs, lens)]
        prompts = [p for p in prompts for _ in range(gconfig.n)]
        padded, plens = genmod.pad_prompts(prompts, pad_token_id)
        model = Transformer.from_params(
            self.cfg, {n: p.detach() for n, p in self._cast().items()})
        out = genmod.generate_batch(
            model, torch.from_numpy(padded).to(self.device),
            torch.from_numpy(plens).to(self.device), generator, gconfig,
            max_new_tokens=gconfig.max_new_tokens, eos_token_id=eos_token_id,
            pad_token_id=pad_token_id, attn_impl=self.attn_impl,
        )
        return {k: v.cpu().numpy() for k, v in out.items()}

    # -------------- train-state checkpointing --------------

    def save_train_state(self, ckpt_dir: str) -> int:
        """``params.safetensors`` (the masters) and, with an optimizer,
        ``opt_state.safetensors`` (``mu/<name>``, ``nu/<name>`` in their
        stored dtype, and ``opt_step_count``). Returns the bytes written."""
        os.makedirs(ckpt_dir, exist_ok=True)
        n = sio.save_file(self.params,
                          os.path.join(ckpt_dir, "params.safetensors"))
        opt = self.optimizer
        if opt is not None:
            state = {"opt_step_count": torch.tensor(opt.count)}
            for kind, moments in (("mu", opt.mu), ("nu", opt.nu)):
                state.update({f"{kind}/{name}": m
                              for name, m in zip(self.params, moments)})
            n += sio.save_file(state,
                               os.path.join(ckpt_dir, "opt_state.safetensors"))
        return n

    @torch.no_grad()
    def load_train_state(self, ckpt_dir: str) -> None:
        """Restore what :meth:`save_train_state` wrote, in place: each tensor
        keeps its dtype, shape and device."""
        z = sio.load_file(os.path.join(ckpt_dir, "params.safetensors"))
        for name, p in self.params.items():
            p.copy_(z[name].reshape(p.shape))
        path = os.path.join(ckpt_dir, "opt_state.safetensors")
        opt = self.optimizer
        if opt is None or not os.path.exists(path):
            return
        z = sio.load_file(path)
        for kind, moments in (("mu", opt.mu), ("nu", opt.nu)):
            for name, m in zip(self.params, moments):
                m.copy_(z[f"{kind}/{name}"].reshape(m.shape))
        opt.count = int(z["opt_step_count"])


@dataclasses.dataclass
class TorchTrainBackend(ModelBackend):
    """Builds a TorchTrainEngine for a Model whose ``module`` is a
    ``(TransformerConfig, state dict)`` pair."""

    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    device: Any = None  # cuda unless named
    compute_dtype: str = "bfloat16"
    length_bucket: int = 128
    rows_bucket: int = 8
    seqs_bucket: int = 8
    attn_impl: str = "auto"
    remat: Any = False
    logprob_chunk: Optional[int] = 512
    fill_bucket: Optional[int] = None
    train: bool = True  # False: an inference engine, no optimizer

    def initialize(self, model: Model, spec: FinetuneSpec) -> Model:
        cfg, params = model.module
        model.module = TorchTrainEngine(
            cfg,
            params,
            opt_cfg=self.optimizer if self.train else None,
            ft_spec=spec,
            device=self.device,
            compute_dtype=self.compute_dtype,
            length_bucket=self.length_bucket,
            rows_bucket=self.rows_bucket,
            seqs_bucket=self.seqs_bucket,
            attn_impl=self.attn_impl,
            remat=self.remat,
            logprob_chunk=self.logprob_chunk,
            fill_bucket=self.fill_bucket,
        )
        return model


register_backend("torch_train", TorchTrainBackend)
register_backend("torch_inference",
                 lambda **kw: TorchTrainBackend(train=False, **kw))
