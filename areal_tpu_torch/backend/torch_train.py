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

With telemetry on (``base/telemetry.py``) a train step records the
reference's ``train/split_pack``, ``train/fwd_bwd`` and
``train/optimizer`` spans, the ``train/pack_fill`` / ``infer/pack_fill``
gauges, the ``train/tokens`` and ``train/optimizer_steps`` counters and
the ``train/fwd_bwd`` memory watermark; it then synchronises the device
at the end of the fwd-bwd and of the optimizer spans, so that each span
times the work and not its launches. With telemetry off the step keeps
its one host sync.

MoE models (``models/moe.py``): each grad step adds the forward's
``aux_total`` times ``aux_scale`` (1/n_mbs under the global normalize scope,
else 1) to the loss and returns the aux as ``moe_*`` stats; the step divides
them by the micro-batch count, observes the ``[E]`` expert load as the
``train/moe_expert_load_dist`` distribution and sets the
``train/moe_dropped_frac`` / ``train/moe_expert_load_ratio`` gauges (the
reference's ``_finish_stats:757``). ``train/moe_ep_engaged`` is set from
the expert-parallel gate on every uploaded train batch (the reference's
``_ep_engagement:739``): 1 where the dispatch runs over ``ep``, 0 under
``pp`` (a stage's MoE layers run the grouped dispatch on experts gathered
over ``ep``, as the reference's stages do). Router jitter
(``input_jitter_eps > 0``) draws from one ``torch.Generator`` per
micro-batch seeded from the optimizer step count and the micro-batch index.

On a mesh (``mesh=``, a ``parallel/mesh.py make_mesh`` DeviceMesh; the
reference's ``JaxTrainEngine(mesh=...)``). The engine is functional
(``functional_call`` over a meta module), so FSDP2's module hooks do not
fit it; DTensor placements on the masters carry the reference's layout one
for one instead:

 - the f32 masters are DTensors placed by ``parallel/sharding.py
   param_partition_specs`` (``fsdp`` on the hidden dim, ``tp`` on heads and
   MLP columns, replicated over ``dp``);
 - the cast (``_CastGather``) casts each master's local shard to the
   compute dtype, **then** all-gathers it over ``fsdp`` (half the bytes of
   gathering f32, as FSDP's mixed precision does), and hands the model a
   plain local tensor (K1-K3 read raw pointers and never see a DTensor).
   Its backward casts the gradient back to f32 and reduces it into the
   master's placements: a reduce-scatter over ``fsdp``, a sum over ``dp``,
   the tp shard kept (``sharding.grad_placements``). The gradients land on
   the masters' local shards, which are the autograd leaves, so that their
   sum over the micro-batches runs on plain tensors (a DTensor op pays the
   sharding propagation over six mesh axes on the host);
 - the data axes split a step's micro-batches: data rank r runs micro-
   batches r, r + D, ... (D = dp·fsdp·ep), padded to one count on every
   rank with zero-weighted replays, so that every rank issues the same
   collectives. The tp ranks of one data rank run the same micro-batches,
   each on its heads (``sharding.constrain`` in ``models/transformer.py``);
 - the losses and stats (sums) and the squared grad norm (local squares,
   each replicated element counted once) are summed over the world in one
   all-reduce, fused into the one host sync, so the skip rule still reads
   the host once;
 - ``Optimizer.step`` runs on the local shards.

``forward`` (inference) runs every micro-batch on every rank, each on its
tp share, and ``generate`` runs over weights gathered whole.

Sequence parallelism over ``sp`` (``parallel/ring.py``): the ``sp`` ranks
of one data rank run the same micro-batches, each on its shard of every
row in the zig-zag layout, attention through the ring over the ``sp``
group. Each rank runs the head and the log-prob (or the values) on its own
tokens; only those per-token results are gathered over ``sp`` (the next-
token labels are formed before the layout), so every loss function sees
whole rows; each ``sp`` rank backpropagates through its own tokens and the
masters' gradients are partial over ``sp`` (summed by the cast's
backward). Where the ring's gate fails, every ``sp`` rank runs whole rows
and weighs its loss by ``1/sp``.

Pipeline parallelism over ``pp`` (``parallel/pipeline.py``): stage ``k``
holds only its own layers' masters; the embedding, the final norm and the
head are held on every stage, used on stage 0 (the lookup) and the last
(the head: a tied embedding's gradient sums across the stages), and their
gradients are summed over the ``pp`` group once a step, after the
micro-batches. The pipeline splits each micro-batch's rows into its
micro-batches (1F1B, or GPipe under ``AREAL_PP_SCHEDULE=gpipe``); the
last stage's loss counts, the others weigh theirs by 0
and backpropagate what reaches them over the pipeline. An MoE model's aux
is each stage's share of its layers, added to every stage's loss. The
inference forward broadcasts the last stage's outputs over ``pp``;
``generate`` and ``full_params`` gather every stage's layers.

``train/pp_engaged`` and ``train/ring_engaged`` are set from the gates
(``pipeline.pp_engagement``) on every uploaded train batch. Without a
mesh, an engine whose ``_spec`` has ``sp`` or ``pp`` above 1 runs the same
ring and pipeline in one process on its device: every rank's shard and
every stage, one after another (how the card holds them against plain
attention).

Expert parallelism over ``ep`` (``models/moe.py dispatch_ep``): each ``ep``
rank is a data rank with micro-batches of its own, and the source of its
tokens; the expert stacks' compute copies keep their ``ep`` shard (each
rank runs the experts it owns, ``sharding.compute_placements``), the
exchange runs over the ``ep`` group, and the experts' gradients come back
whole over ``ep``. Under ``pp`` the stages run the grouped dispatch on
experts gathered over ``ep``. Without a mesh, an engine whose ``_spec`` has
``ep`` above 1 runs every source and owner in this process, each
micro-batch's rows split into ``ep`` sources. MoE layers under ``tp`` split
each expert's width over ``tp`` and sum the partial products; under ``sp``
they take their capacity slots and statistics over whole rows
(``models/moe.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

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
from areal_tpu_torch.base import telemetry
from areal_tpu_torch.models import generate as genmod
from areal_tpu_torch.models import moe as moemod
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.packing import round_up
from areal_tpu_torch.models.transformer import (
    Transformer,
    head_logits,
    head_param_name,
)
from areal_tpu_torch.ops.xent import gather_logprobs
from areal_tpu_torch.parallel import pipeline as ppl
from areal_tpu_torch.parallel import ring as ring_mod
from areal_tpu_torch.parallel import sharding as psh
from areal_tpu_torch.parallel.mesh import ParallelSpec
from areal_tpu_torch.system import memwatch

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


class _CastGather(torch.autograd.Function):
    """A master's local shard → its compute copy: cast to ``dtype``, then
    redistributed into the compute placements (an all-gather over
    ``fsdp``), returned as a plain local tensor. The backward casts the
    gradient back to the master's dtype and reduces it from the gradient
    placements into the master's (reduce-scatter over ``fsdp``, all-reduce
    over ``dp``).

    ``mesh`` is the mesh's sub-mesh of the axes of degree > 1 (the
    placements cut to them), or None when every axis has degree 1: then
    both directions are the identity and only the casts run.
    """

    @staticmethod
    def forward(ctx, local, dtype, mesh, placements, compute_pl, grad_pl,
                shape, stride):
        from torch.distributed.tensor import DTensor

        ctx.meta = (mesh, placements, grad_pl, shape, stride, local.dtype)
        out = local.to(dtype)
        if mesh is not None:
            out = DTensor.from_local(
                out, mesh, placements, run_check=False, shape=shape,
                stride=stride).redistribute(mesh, compute_pl).to_local()
        # never hand the model the master's own storage
        return out.clone() if out.data_ptr() == local.data_ptr() else out

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        mesh, placements, grad_pl, shape, stride, dt = ctx.meta
        g = g.to(dt)
        if mesh is not None:
            g = DTensor.from_local(g, mesh, grad_pl, run_check=False,
                                   shape=shape, stride=stride).redistribute(
                mesh, placements).to_local()
        return g, None, None, None, None, None, None, None


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
        mesh=None,
    ):
        self.cfg = cfg
        self.mesh = mesh
        # sp / pp / ep: over the mesh's groups (set by _setup_mesh);
        # without a group, every rank, stage and source runs in this one
        # process
        self._spec = ParallelSpec()
        self._sp_rank, self._sp_group = 0, None
        self._ep_rank, self._ep_group = 0, None
        self._stage, self._pp_group = None, None
        self._reports_data = self._reports_aux = True
        if mesh is not None:
            if device is None and mesh.device_type == "cpu":
                device = "cpu"
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
        if train and remat:
            # torch.utils.checkpoint imports torch._dynamo on its first
            # call (seconds in a fresh process): pay it while the trainer
            # starts, not in its first train step
            import torch._dynamo as _dynamo  # noqa: F401
        # Training keeps explicit f32 masters: bf16 rounds away small Adam
        # updates; compute still runs in compute_dtype.
        self.params = {
            n: t.detach().to(
                self.device,
                torch.float32 if train and t.is_floating_point() else t.dtype,
            )
            for n, t in params.items()
        }
        if mesh is not None:
            self._setup_mesh()
        # On a mesh the local shards are the autograd leaves: gradients
        # accumulate over the micro-batches in plain tensors (a DTensor op
        # pays the sharding propagation over the six mesh axes on the host).
        for t in self._local_params():
            t.requires_grad_(train)
        self.optimizer = None
        if train:
            total = ft_spec.total_train_steps if ft_spec is not None else 1000
            self.optimizer = Optimizer(opt_cfg, self._local_params(), total)
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

    # -------------- the mesh --------------

    def _setup_mesh(self) -> None:
        """Place the masters on the mesh and precompute, per master, its
        compute and gradient placements, the kv rows this tp rank reads,
        and its weight in the grad norm (1 on the first rank of every axis
        it is replicated over, else 0)."""
        mesh, cfg = self.mesh, self.cfg
        tp = psh.mesh_degree(mesh, "tp")
        layouts = psh.param_layouts(cfg, tp)
        deg = {a: psh.mesh_degree(mesh, a) for a in psh.AXIS_ORDER}
        coords = {a: psh.mesh_coord(mesh, a) for a in psh.AXIS_ORDER}
        self._spec = ParallelSpec(**deg)
        if deg["sp"] > 1:
            self._sp_rank, self._sp_group = coords["sp"], mesh.get_group("sp")
        if deg["ep"] > 1:
            if cfg.moe is not None and cfg.moe.num_experts % deg["ep"]:
                raise ValueError(f"ep={deg['ep']} does not divide "
                                 f"{cfg.moe.num_experts} experts")
            self._ep_rank, self._ep_group = coords["ep"], mesh.get_group("ep")
        # the expert-parallel dispatch's layout: each rank its own experts
        ep_local = (cfg.moe is not None and deg["ep"] > 1
                    and deg["pp"] == 1)
        if deg["pp"] > 1:
            # each stage holds its own layers' masters only
            self._stage, self._pp_group = coords["pp"], mesh.get_group("pp")
            self.params = {n: t for n, t in self.params.items()
                           if self._stage_of(n) in (None, self._stage)}
        self.params = psh.shard_params(self.params, mesh, cfg)
        # The cast's DTensors live on the sub-mesh of the axes of degree >
        # 1 (DTensor's host cost grows with the mesh's dims), or nowhere.
        active = [i for i, a in enumerate(psh.AXIS_ORDER)
                  if psh.mesh_degree(mesh, a) > 1]
        self._cast_mesh = (mesh[tuple(psh.AXIS_ORDER[i] for i in active)]
                           if active else None)

        def cut(pl):
            return tuple(pl[i] for i in active)

        full = psh.placements_of({})
        self._cast_pl = {
            n: (cut(p.placements),
                cut(psh.compute_placements(n, layouts[n], ep_local)),
                cut(full),
                cut(psh.grad_placements(n, layouts[n], cfg, tp, ep_local)))
            for n, p in self.params.items()}
        rows = psh.kv_head_rows(cfg, tp, psh.mesh_coord(mesh, "tp"))
        self._kv_rows = {n: rows for n in self.params if rows is not None
                         and n.split(".", 2)[-1] in psh._KV_SUFFIXES}
        # a stage's layers are its own (no other stage counts them); every
        # other replicated element is counted on the axis's first rank
        self._norm_weight = torch.tensor(
            [float(all(coords[a] == 0 for a in psh.AXIS_ORDER
                       if a not in layouts[n] and not (
                           a == "pp" and self._stage_of(n) is not None)))
             for n in self.params], device=self.device)
        self._data_degree = deg["dp"] * deg["fsdp"] * deg["ep"]
        self._data_rank = ((coords["dp"] * deg["fsdp"] + coords["fsdp"])
                           * deg["ep"] + coords["ep"])
        # one rank of each data shard reports its sums (the loss is whole
        # on every sp rank, and real on the last stage), each stage its
        # layers' MoE aux; rank 0 alone reports what every rank computed
        # alike
        self._reports_aux = coords["sp"] == 0 and coords["tp"] == 0
        self._reports_data = (self._reports_aux
                              and coords["pp"] == deg["pp"] - 1)
        self._reports_all = all(c == 0 for c in coords.values())

    def _stage_of(self, name: str) -> Optional[int]:
        """The pipeline stage that holds parameter ``name`` (None: every
        stage, outside the layers)."""
        if not name.startswith("layers."):
            return None
        i = int(name.split(".", 2)[1])
        for k, (lo, hi) in enumerate(ppl.stage_bounds(self.cfg.n_layers,
                                                      self._spec.pp)):
            if lo <= i < hi:
                return k
        raise ValueError(name)

    def _parallel(self, batch) -> Tuple[Optional[ring_mod.RingCtx],
                                        Optional[ppl.PipeCtx]]:
        """The ring and pipeline contexts for a micro-batch: the ring when
        ``sp > 1`` and its gate holds for the rows' shape, the pipeline
        when ``pp > 1``."""
        R, L = batch["tokens"].shape
        spec, ring, pipe = self._spec, None, None
        if ring_mod.ring_eligible(spec, self.cfg, R, L):
            ring = ring_mod.RingCtx(
                n=spec.sp, my=self._sp_rank, group=self._sp_group,
                schedule=ring_mod.resolve_schedule(None, L, spec.sp))
        if spec.pp > 1:
            pipe = ppl.PipeCtx(pp=spec.pp, stage=self._stage,
                               group=self._pp_group, sp=spec.sp)
        return ring, pipe

    def _expert_ctx(self, rows: int, cols: int
                    ) -> Optional[moemod.ExpertCtx]:
        """The expert-parallel dispatch's context for ``[rows, cols]``
        micro-batches (the reference's gate): an MoE model, ``ep`` above 1,
        no pipeline; without a mesh, one process splits the rows into the
        ``ep`` sources, so ``moe.ep_eligible`` must hold for the shape."""
        spec = self._spec
        if self.cfg.moe is None or spec.ep <= 1 or spec.pp > 1:
            return None
        if self._ep_group is not None:
            return moemod.ExpertCtx(ep=spec.ep, rank=self._ep_rank,
                                    group=self._ep_group)
        if not moemod.ep_eligible(spec, self.cfg.moe, rows, cols):
            return None
        return moemod.ExpertCtx(ep=spec.ep)

    def _loss_share(self, ring) -> float:
        """The weight of this rank's head loss in its backward: 0 on a
        stage before the last, ``1/sp`` where every sp rank ran whole rows
        (the ring's gate failed), else 1."""
        if self._stage is not None and self._stage != self._spec.pp - 1:
            return 0.0
        if self._sp_group is not None and ring is None:
            return 1.0 / self._spec.sp
        return 1.0

    def _local_params(self) -> List[torch.Tensor]:
        """The masters' local shards (the masters themselves off a mesh):
        the tensors autograd and the optimizer update."""
        if self.mesh is None:
            return list(self.params.values())
        return [p._local_tensor for p in self.params.values()]

    def _mesh_ctx(self):
        return psh.activation_sharding(self.mesh) if self.mesh is not None \
            else contextlib.nullcontext()

    @torch.no_grad()
    def full_params(self, dtype: Optional[torch.dtype] = None,
                    names: Optional[Sequence[str]] = None
                    ) -> Dict[str, torch.Tensor]:
        """Every parameter (or those in ``names``: every rank passes the
        same) whole on this rank's device (gathered from the mesh), cast to
        ``dtype`` when given. Off a mesh: the masters (or their casts)."""
        out = {}
        for n, p in self.params.items():
            if names is not None and n not in names:
                continue
            t = p._local_tensor if self.mesh is not None else p
            t = t.detach()
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)  # cast, then gather
            out[n] = t if self.mesh is None else self._whole(n, t)
        return self._fill_stages(out, dtype, names=names)

    def _fill_stages(self, out: Dict[str, torch.Tensor],
                     dtype: Optional[torch.dtype] = None,
                     prefix: str = "",
                     names: Optional[Sequence[str]] = None
                     ) -> Dict[str, torch.Tensor]:
        """Under ``pp``, whole tensors (``prefix + name``) of every
        stage's layers (of those in ``names``, if given): each broadcast
        over the ``pp`` group from the stage that holds it, in the model's
        order on every rank. ``dtype``: of the tensors received (default
        the masters')."""
        if self._pp_group is None:
            return out
        import torch.distributed as dist

        ranks = dist.get_process_group_ranks(self._pp_group)
        dt = dtype or next(iter(self.params.values())).dtype
        full = dict(out)
        for n, meta in self.model.state_dict().items():
            k = self._stage_of(n)
            if k is None or (names is not None and n not in names):
                continue
            t = out.get(prefix + n)
            if t is None:
                t = torch.empty(meta.shape, dtype=dt, device=self.device)
            t = t.contiguous()
            dist.broadcast(t, ranks[k], group=self._pp_group)
            full[prefix + n] = t
        return full

    # -------------- internals --------------

    def _cast(self, full: bool = False) -> Dict[str, torch.Tensor]:
        """Compute-dtype copies of the masters, differentiable back into
        them. On a mesh: this rank's compute shards (``full``: the whole
        tensors, for generation)."""
        cd = self.compute_dtype
        if self.mesh is None:
            return {n: p.to(cd) if p.is_floating_point() else p
                    for n, p in self.params.items()}
        out = {}
        for n, p in self.params.items():
            pl, compute_pl, full_pl, grad_pl = self._cast_pl[n]
            t = _CastGather.apply(p._local_tensor, cd, self._cast_mesh, pl,
                                  full_pl if full else compute_pl, grad_pl,
                                  p.shape, p.stride())
            rows = None if full else self._kv_rows.get(n)
            out[n] = t if rows is None else t[rows]
        if full:
            with torch.no_grad():
                return self._fill_stages(out, cd)
        return out

    def _hidden_or_logits(self, cast, batch, return_hidden: bool, remat,
                          aux: Optional[Dict[str, torch.Tensor]] = None,
                          rng: Optional[torch.Generator] = None):
        """The model's final hidden, logits, or a critic's values (cast to
        f32 after the head, as the reference does). An MoE model's aux goes
        into ``aux`` when a dict is given; ``rng`` draws its router
        jitter. Under a multi-rank ring the hidden is this rank's shard in
        the ring's layout, logits and values are gathered whole."""
        ring, pipe = self._parallel(batch)
        out, _, moe_aux = torch.func.functional_call(
            self.model, cast, (batch["tokens"], batch["positions"]),
            dict(segment_ids=batch["segment_ids"], attn_impl=self.attn_impl,
                 remat=remat, return_kv=False, return_hidden=return_hidden,
                 return_aux=True, rng=rng, ring=ring, pipeline=pipe,
                 ep=self._expert_ctx(*batch["tokens"].shape)),
        )
        if ring is not None and not ring.one_process and not return_hidden:
            out = ring_mod.gather_sequence(out, ring)
        if aux is not None:
            aux.update(moe_aux)
        return out.float() if self.cfg.is_critic and not return_hidden else out

    def _forward_token_logprobs(self, cast, batch, remat,
                                aux: Optional[Dict[str, torch.Tensor]] = None,
                                rng: Optional[torch.Generator] = None
                                ) -> torch.Tensor:
        """[R, L] per-token logprobs through the chunked head: each column
        chunk computes its logits and gathers its scores under checkpoint,
        so the backward recomputes the chunk's logits instead of keeping
        them (the head matmul is redone once). Without grad, the chunks just
        run one after another. ``aux``, ``rng``: as
        :meth:`_hidden_or_logits`."""
        h = self._hidden_or_logits(cast, batch, return_hidden=True,
                                   remat=remat, aux=aux, rng=rng)
        L = h.shape[1]
        labels = PF.next_token_labels(batch["tokens"])
        ring, _ = self._parallel(batch)
        gather = ring is not None and not ring.one_process
        if gather:  # labels formed before the layout, then this shard's
            labels = ring_mod.shard_sequence(labels, ring)
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
        if gather:
            s = ring_mod.gather_sequence(s, ring)
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

    def _jitter_generator(self, i: int) -> Optional[torch.Generator]:
        """Micro-batch ``i``'s router-jitter generator for this optimizer
        step (reference ``train_batch:853``: a key per step folded with the
        micro-batch index), or None when the model has no jitter."""
        moe = self.cfg.moe
        if moe is None or moe.input_jitter_eps <= 0:
            return None
        return torch.Generator(device=self.device).manual_seed(
            (self.opt_step_count << 20) + i)

    def _grad_step(self, ub, loss_fn, i, denom, scale, aux_scale):
        """One micro-batch: forward, loss (plus an MoE model's
        ``aux_total · aux_scale``, its aux returned as ``moe_*`` stats),
        backward into the masters' ``.grad`` (which sums over the
        micro-batches)."""
        batch = self._slice(ub, i)
        cast = self._cast()
        aux: Dict[str, torch.Tensor] = {}
        rng = self._jitter_generator(i)
        if self._use_chunked_logprobs(loss_fn):
            out = self._forward_token_logprobs(cast, batch, self.remat,
                                               aux=aux, rng=rng)
        else:
            out = self._hidden_or_logits(cast, batch, return_hidden=False,
                                         remat=self.remat, aux=aux, rng=rng)
        loss_sum, stats = loss_fn(out, batch)
        loss = loss_sum / max(denom, 1.0)
        ring = self._parallel(batch)[0]
        share = self._loss_share(ring)
        total = loss * share if share != 1.0 else loss
        # what this rank reports: the head loss where it reports data, the
        # aux (its stage's share) where it reports aux
        report = loss.detach() if self._reports_data else \
            torch.zeros_like(loss.detach())
        if aux:
            aux_loss = aux["aux_total"] * aux_scale
            # sp ranks that ran whole rows each hold the whole aux
            total = total + (aux_loss / self._spec.sp
                             if self._sp_group is not None and ring is None
                             else aux_loss)
            if self._reports_aux:
                report = report + aux_loss.detach()
            stats = dict(stats, **{f"moe_{k}": v for k, v in aux.items()})
        (total * scale if scale != 1.0 else total).backward()
        return report * scale, {k: v.detach() for k, v in stats.items()}

    def accumulate_grads(self, ub: UniformBatch, loss_fn: LossFn,
                         idxs: List[int], weights: List[float],
                         glob: bool = True):
        """Gradients of the micro-batches ``idxs`` summed into the masters'
        ``.grad``; returns the summed (loss, stats)."""
        total_w = sum(weights)
        scale = 1.0 if glob else 1.0 / len(idxs)
        aux_scale = 1.0 / len(idxs) if glob else 1.0
        for p in self._local_params():
            p.grad = None
        # (micro-batch, its weight, whether it counts): on a mesh this data
        # rank's share, padded with zero-scaled replays to the common count
        work = [(i, w, True) for i, w in zip(idxs, weights)]
        if self.mesh is not None:
            n_local = -(-len(work) // self._data_degree)
            work = work[self._data_rank::self._data_degree]
            work += [(idxs[0], weights[0], False)] * (n_local - len(work))
        loss_acc, stats_acc = None, {}
        with self._mesh_ctx():
            for i, w, counts in work:
                loss, stats = self._grad_step(ub, loss_fn, i,
                                              total_w if glob else w,
                                              scale if counts else 0.0,
                                              aux_scale)
                if not counts:
                    continue
                loss_acc = loss if loss_acc is None else loss + loss_acc
                stats_acc = {k: stats[k] + stats_acc[k] if k in stats_acc
                             else stats[k] for k in stats}
        if loss_acc is None:  # a data rank with no micro-batch of its own
            loss_acc = torch.zeros((), device=self.device)
            stats_acc = {k: torch.zeros_like(v) for k, v in stats.items()}
        if self._pp_group is not None:
            self._sum_over_stages()
        return loss_acc, stats_acc

    @torch.no_grad()
    def _sum_over_stages(self) -> None:
        """The gradients of the parameters every stage holds (embedding,
        final norm, head), summed over the ``pp`` group: stage 0 saw the
        lookup, the last stage the head."""
        import torch.distributed as dist

        for n, loc in zip(self.params, self._local_params()):
            if self._stage_of(n) is not None:
                continue
            if loc.grad is None:
                loc.grad = torch.zeros_like(loc)
            dist.all_reduce(loc.grad, group=self._pp_group)

    # -------------- upload-once uniform batches --------------

    def _split(self, input_: SequenceSample,
               mb_spec: MicroBatchSpec) -> List[mbu.MicroBatch]:
        return mbu.split_into_microbatches(
            input_, mb_spec, length_bucket=self.length_bucket,
            rows_bucket=self.rows_bucket, seqs_bucket=self.seqs_bucket,
            fill_bucket=self.fill_bucket,
        )

    def upload_uniform(self, input_: SequenceSample,
                       mb_spec: MicroBatchSpec,
                       train: bool = True) -> UniformBatch:
        """Pack the whole batch into micro-batches of one ``[R, L]`` shape
        and upload it to the device once. ``train=False`` (the inference
        forward) reports its fill as ``infer/pack_fill``, outside the
        ``train/split_pack`` span."""
        if train:
            with telemetry.span("train/split_pack"):
                mbs = self._split(input_, mb_spec)
                telemetry.set_gauge("train/pack_fill", mbu.pack_fill(mbs))
            telemetry.set_gauge(
                "train/moe_ep_engaged",
                float(self._expert_ctx(*mbs[0].layout.shape) is not None))
        else:
            mbs = self._split(input_, mb_spec)
            telemetry.set_gauge("infer/pack_fill", mbu.pack_fill(mbs))
        R, L = mbs[0].layout.shape
        if train:
            pp_on, ring_on = ppl.pp_engagement(self._spec, self.cfg, R, L)
            telemetry.set_gauge("train/pp_engaged", pp_on)
            telemetry.set_gauge("train/ring_engaged", ring_on)
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
        with telemetry.span("train/fwd_bwd", n_mbs=len(idxs)), \
                memwatch.watermark("train/fwd_bwd"):
            loss_acc, stats_acc = self.accumulate_grads(ub, loss_fn, idxs,
                                                        weights, glob)
            if telemetry.enabled():
                # An honest fwd-bwd / optimizer split; without telemetry
                # this sync does not exist.
                self._sync()
        with telemetry.span("train/optimizer"):
            params = self._local_params()
            grads = self._local_grads()
            if self.mesh is None:
                grad_norm = torch.linalg.vector_norm(
                    torch.stack(torch._foreach_norm(grads)))
                fetch = {**stats_acc, **(extra_fetch or {}),
                         "loss": loss_acc, "grad_norm": grad_norm}
                flat_dev = torch.cat([v.detach().float().reshape(-1)
                                      for v in fetch.values()])
            else:
                fetch, flat_dev = self._reduce_fetch(stats_acc, extra_fetch,
                                                     loss_acc, grads)
                grad_norm = flat_dev[-1]
            # the one host sync
            flat = flat_dev.tolist()
            fetched, at = {}, 0
            for k, v in fetch.items():
                n = v.numel()
                fetched[k] = flat[at] if n == 1 else flat[at:at + n]
                at += n
            t1 = self._phase_clock()
            apply = True
            if skip_update_rule is not None and skip_update_rule[2]:
                num, den, cap = skip_update_rule
                ratio = fetched[num] / max(fetched[den], 1.0)
                apply = cap <= 0.0 or ratio <= cap
            # The schedule is read at the pre-increment count.
            applied_lr = float(self.lr_schedule(self.opt_step_count))
            if apply:
                self.optimizer.step(params, grads, grad_norm,
                                    fetched["grad_norm"])
            for p in params:
                p.grad = None
            if telemetry.enabled():
                self._sync()
        t2 = self._phase_clock()
        if self.time_phases:
            self.last_phase_secs = {"fwd_bwd": t1 - t0, "optimizer": t2 - t1}
        out = self._finish_stats(fetched, len(idxs))
        out["update_applied"] = float(apply)
        out["lr"] = applied_lr
        out["total_tokens"] = float(sum(ub.mbs[i].n_tokens for i in idxs))
        out["loss_weight"] = sum(weights)
        telemetry.inc("train/tokens", out["total_tokens"])
        telemetry.inc("train/optimizer_steps", float(apply))
        return out

    def _local_grads(self) -> List[torch.Tensor]:
        """The masters' gradients (their local shards on a mesh); zeros for
        a master the step did not reach."""
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self._local_params()]

    def _reduce_fetch(self, stats_acc, extra_fetch, loss_acc, grads):
        """The mesh's half of the one host sync: the loss and stats (sums
        over this rank's micro-batches, counted by one rank of each data
        shard), the prep scalars (alike on every rank, counted once) and
        the squared grad norm (each element counted once) summed over the
        world in one all-reduce; the norm's square root taken after it.
        Returns (fetch keys, the reduced flat vector)."""
        import torch.distributed as dist

        with torch.no_grad():
            sq = (torch.stack(torch._foreach_norm(grads)) ** 2
                  * self._norm_weight).sum()
            parts = [(v, self._reports_aux if k.startswith("moe_")
                      else self._reports_data) for k, v in stats_acc.items()]
            parts += [(v, self._reports_all)
                      for v in (extra_fetch or {}).values()]
            parts.append((loss_acc, True))  # masked where it was made
            # a rank that does not report sends zeros (never 0 * a NaN)
            flat_dev = torch.cat(
                [v.detach().float().reshape(-1) if keep else
                 torch.zeros(v.numel(), device=self.device)
                 for v, keep in parts] + [sq.reshape(1)])
            dist.all_reduce(flat_dev)
            flat_dev[-1] = flat_dev[-1].sqrt()
        fetch = {**stats_acc, **(extra_fetch or {}), "loss": loss_acc,
                 "grad_norm": flat_dev[-1]}
        return fetch, flat_dev

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _phase_clock(self) -> float:
        if not self.time_phases:
            return 0.0
        self._sync()
        return time.perf_counter()

    # Per-expert routed-load shares cluster around 1/E: log-ish buckets.
    _EXPERT_LOAD_BUCKETS = (0.001, 0.002, 0.005, 0.01, 0.02, 0.05,
                            0.1, 0.2, 0.5, 1.0)

    @classmethod
    def _finish_stats(cls, fetched: Dict[str, Any],
                      n_mbs: int) -> Dict[str, float]:
        """Host-side stat post-processing (reference ``_finish_stats:757``):
        the ``moe_*`` stats, sums of per-micro-batch values, are divided by
        the micro-batch count; the ``[E]`` ``moe_expert_load`` is split off
        and observed as ``train/moe_expert_load_dist``; the drop fraction
        and the load ratio are also set as ``train/moe_*`` gauges."""
        n_mbs = max(n_mbs, 1)
        vec = {k: v for k, v in fetched.items() if isinstance(v, list)}
        out = {k: float(v) for k, v in fetched.items() if k not in vec}
        for k in out:
            if k.startswith("moe_"):
                out[k] /= n_mbs
        for share in vec.get("moe_expert_load", ()):
            telemetry.observe("train/moe_expert_load_dist", share / n_mbs,
                              buckets=cls._EXPERT_LOAD_BUCKETS)
        for stat in ("moe_dropped_frac", "moe_expert_load_ratio"):
            if stat in out:
                telemetry.set_gauge(f"train/{stat}", out[stat])
        return out

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
        ub = self.upload_uniform(input_, mb_spec, train=False)
        use_lp = self._use_chunked_logprobs(post_hook)
        cast = self._cast()
        outs = []
        with self._mesh_ctx():
            outs = self._forward_mbs(ub, cast, use_lp, post_hook)
        return mbu.scatter_back(ub.mbs, outs, input_.bs)

    def _forward_mbs(self, ub, cast, use_lp, post_hook) -> List[np.ndarray]:
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
            if self._pp_group is not None:  # the last stage's is real
                import torch.distributed as dist

                out = out.contiguous()
                dist.broadcast(out, dist.get_process_group_ranks(
                    self._pp_group)[-1], group=self._pp_group)
            if out.dtype == torch.bfloat16:  # numpy has no bf16
                out = out.float()
            outs.append(out.cpu().numpy())
        return outs

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
            self.cfg, {n: p.detach() for n, p in self._cast(full=True).items()})
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
        opt = self.optimizer
        state = None
        if opt is not None:
            state = {"opt_step_count": torch.tensor(opt.count)}
            for kind, moments in (("mu", opt.mu), ("nu", opt.nu)):
                state.update({f"{kind}/{name}": self._whole(name, m)
                              for name, m in zip(self.params, moments)})
                if moments:
                    state = self._fill_stages(state, moments[0].dtype,
                                              prefix=f"{kind}/")
        params = self.full_params()
        if self.mesh is not None and self.mesh.get_rank() != 0:
            return 0  # every rank gathers; rank 0 writes
        os.makedirs(ckpt_dir, exist_ok=True)
        n = sio.save_file(params, os.path.join(ckpt_dir, "params.safetensors"))
        if state is not None:
            n += sio.save_file(state,
                               os.path.join(ckpt_dir, "opt_state.safetensors"))
        return n

    def _whole(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """A tensor laid out as master ``name`` (e.g. an Adam moment's
        local shard), whole; off a mesh, as it is."""
        if self.mesh is None:
            return local
        from torch.distributed.tensor import DTensor

        p = self.params[name]
        return DTensor.from_local(local, self.mesh, p.placements,
                                  run_check=False, shape=p.shape,
                                  stride=p.stride()).full_tensor()

    def _shard_of(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a whole tensor laid out as master
        ``name``."""
        if self.mesh is None:
            return full
        from torch.distributed.tensor import distribute_tensor

        p = self.params[name]
        return distribute_tensor(full.to(self.device), self.mesh,
                                 p.placements, src_data_rank=None).to_local()

    @torch.no_grad()
    def load_train_state(self, ckpt_dir: str) -> None:
        """Restore what :meth:`save_train_state` wrote, in place: each tensor
        keeps its dtype, shape and device."""
        z = sio.load_file(os.path.join(ckpt_dir, "params.safetensors"))
        for (name, p), loc in zip(self.params.items(), self._local_params()):
            loc.copy_(self._shard_of(name, z[name].reshape(p.shape)))
        path = os.path.join(ckpt_dir, "opt_state.safetensors")
        opt = self.optimizer
        if opt is None or not os.path.exists(path):
            return
        z = sio.load_file(path)
        for kind, moments in (("mu", opt.mu), ("nu", opt.nu)):
            for (name, p), m in zip(self.params.items(), moments):
                m.copy_(self._shard_of(
                    name, z[f"{kind}/{name}"].reshape(p.shape)))
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
    # "f2t2"-style spec: the engine runs on a make_mesh mesh over the
    # current process group (parallel/distributed.initialize first)
    parallel_spec: Optional[str] = None

    def initialize(self, model: Model, spec: FinetuneSpec) -> Model:
        cfg, params = model.module
        mesh = None
        if self.parallel_spec:
            from areal_tpu_torch.parallel import mesh as pmesh

            dev = None if self.device is None else torch.device(self.device)
            mesh = pmesh.make_mesh(
                pmesh.ParallelSpec.parse(self.parallel_spec),
                None if dev is None else dev.type)
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
            mesh=mesh,
        )
        return model


register_backend("torch_train", TorchTrainBackend)
register_backend("torch_inference",
                 lambda **kw: TorchTrainBackend(train=False, **kw))
