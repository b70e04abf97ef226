"""Sharding rules: DTensor placements for parameters, and the points where
activations cross the tensor-parallel group.

The port's counterpart of ``areal_tpu/parallel/sharding.py``
(``param_partition_specs:35``, ``shard_params:114``, ``ACTIVATION_RULES``,
``constrain``). The reference writes a ``PartitionSpec`` per leaf and lets
GSPMD insert the collectives. The port keeps the same table, written as
one DTensor placement per mesh axis (``mesh.AXIS_ORDER``) in its own
layout (``nn.Linear`` weights are ``[out, in]``, layers are not stacked:
the reference's ``pp`` entry of a stacked leaf becomes the pipeline stage
that holds the layer, ``backend/torch_train.py``), and
places the collectives by hand, Megatron's way, at two kinds of point:

 - ``constrain(x, "column_in")``: the replicated hidden state enters a
   column-parallel block (``wq``/``wk``/``wv``, ``w_gate``/``w_up``).
   Identity forward; the backward sums the partial input gradients over
   ``tp``.
 - ``constrain(x, "row_out")``: a row-parallel block (``wo``, ``w_down``)
   has produced partial sums. The forward sums them over ``tp``; the
   backward is the identity. Row-parallel biases (``bo``, ``b_down``) are
   added once, after the sum.

Outside an :func:`activation_sharding` context (or at ``tp`` 1) both are
the identity, so the model runs as it always has.

Where the DTensor masters turn local, and their gradients turn back, is
the train engine's cast (``backend/torch_train.py``): each master is cast
to the compute dtype, gathered over ``fsdp`` (:func:`compute_placements`),
and handed to the model as a plain local tensor; its gradient comes back
as a local tensor whose placements :func:`grad_placements` names (partial
over the data axes) and is reduced into the master's layout.

Expert stacks (``e_gate``/``e_up``/``e_down``) shard their expert dim over
``ep``. Where the expert-parallel dispatch runs (``expert_local``), their
compute copies keep that shard (each rank the experts it owns) and their
gradients come back whole over ``ep`` (every source's rows reached the
owner through the exchange); everywhere else (pipeline stages, the
inference engine's generate, ``full_params``, publication and
checkpoints) they are gathered whole, as every other master is.

A generation server's ``fsdp × pp × tp`` ranks hold plain tensors, not
DTensors: :func:`serving_slices` names each rank's tensors (its stage's
layers and everything outside the layers) and its cut of each (the same
table: ``tp`` and ``fsdp`` dims split evenly, the embedding and an untied
head whole over ``tp``, the kv rule below), :func:`serving_shards` cuts
them and :func:`rank_config` gives the rank's model geometry; a layer's
``fsdp`` shards are gathered just before it runs (:class:`FsdpGather`,
ZeRO-3 inference: every ``fsdp`` rank runs the whole batch); the server's
forwards run under :func:`activation_sharding` like the trainer's
(``system/server_mesh.py``).
:data:`_ACTIVE` is process-wide (a remat recompute runs on autograd's
device thread): one process holds one rank, so a server's ranks are
processes, never threads of one.

Two departures from the reference's table, both Megatron's rules:

 - where ``n_kv_heads % tp != 0`` (and ``tp % n_kv_heads == 0``), each
   rank keeps the kv heads its q heads read: ``wk``/``wv``/``bk``/``bv``
   are replicated over ``tp`` (``param_partition_specs(cfg, tp=...)``),
   never split inside a head;
 - the vocab-sharded embedding (``tp`` on the vocab rows) and an untied
   head are all-gathered over ``tp`` before the lookup and the head, so
   the lookup is a plain one and the log-softmax sees the whole vocab.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    DATA_AXES,
    ParallelSpec,
    tp_kv_replicated,
)

# A layout: mesh axis -> the tensor dim it shards (absent: replicated).
Layout = Dict[str, int]


def _layer_layouts(cfg: TransformerConfig, tp: int) -> Dict[str, Layout]:
    """Per-layer parameter suffix -> layout (the reference's ``layers``
    specs with ``pp`` dropped, in ``[out, in]``)."""
    col, row = {"tp": 0, "fsdp": 1}, {"tp": 1, "fsdp": 0}
    kv_col = dict(col) if not kv_replicated(cfg, tp) else {"fsdp": 1}
    lay: Dict[str, Layout] = {
        "ln1.weight": {}, "ln2.weight": {},
        "wq.weight": dict(col), "wk.weight": dict(kv_col),
        "wv.weight": dict(kv_col), "wo.weight": dict(row),
    }
    if cfg.use_attention_bias:
        lay["wq.bias"] = {"tp": 0}
        kv_b = {"tp": 0} if "tp" in kv_col else {}
        lay["wk.bias"] = dict(kv_b)
        lay["wv.bias"] = dict(kv_b)
    if cfg.use_attn_output_bias:
        lay["wo.bias"] = {}
    if cfg.use_qk_norm:
        lay["q_norm.weight"] = {}
        lay["k_norm.weight"] = {}
    if cfg.norm_type == "layer":
        lay["ln1.bias"] = {}
        lay["ln2.bias"] = {}
    if cfg.moe is not None:
        lay["router.weight"] = {}
        # experts [E, in, out] in the reference's layout: E over ep
        lay["e_gate"] = {"ep": 0, "fsdp": 1, "tp": 2}
        lay["e_up"] = {"ep": 0, "fsdp": 1, "tp": 2}
        lay["e_down"] = {"ep": 0, "tp": 1, "fsdp": 2}
        if cfg.moe.shared_intermediate_dim:
            lay["s_gate.weight"] = {"tp": 0}
            lay["s_up.weight"] = {"tp": 0}
            lay["s_down.weight"] = {"tp": 1}
    elif cfg.mlp_type == "plain":
        lay.update({"w_up.weight": dict(col), "w_up.bias": {"tp": 0},
                    "w_down.weight": dict(row), "w_down.bias": {}})
    else:
        lay.update({"w_gate.weight": dict(col), "w_up.weight": dict(col),
                    "w_down.weight": dict(row)})
    return lay


def kv_replicated(cfg: TransformerConfig, tp: int) -> bool:
    """Whether ``wk``/``wv`` stay whole on every ``tp`` rank (Megatron's rule
    for fewer kv heads than ranks). Raises for head counts that no rule
    splits: ``n_q_heads % tp``, or kv heads that neither divide nor are
    divided by ``tp`` (``parallel/mesh.py tp_kv_replicated``)."""
    return tp_kv_replicated(cfg.n_q_heads, cfg.n_kv_heads, tp)


def param_layouts(cfg: TransformerConfig, tp: int = 1) -> Dict[str, Layout]:
    """State-dict name -> layout for every parameter of ``Transformer(cfg)``
    (the reference's ``param_partition_specs`` in the port's names and
    layout). ``tp`` only matters for the kv rule (:func:`kv_replicated`)."""
    out: Dict[str, Layout] = {"embedding.weight": {"tp": 0, "fsdp": 1},
                              "final_ln.weight": {}}
    if cfg.norm_type == "layer":
        out["final_ln.bias"] = {}
    if cfg.pos_embedding == "learned":
        out["pos_embedding.weight"] = {"fsdp": 1}
    if cfg.is_critic:
        out["value_head.weight"] = {"fsdp": 1}
    elif not cfg.tie_word_embeddings:
        out["lm_head.weight"] = {"tp": 0, "fsdp": 1}
    for suffix, lay in _layer_layouts(cfg, tp).items():
        for i in range(cfg.n_layers):
            out[f"layers.{i}.{suffix}"] = lay
    return out


def placements_of(layout: Layout) -> tuple:
    """One DTensor placement per mesh axis (``AXIS_ORDER``)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(layout[a]) if a in layout else Replicate()
                 for a in AXIS_ORDER)


def param_partition_specs(cfg: TransformerConfig,
                          tp: int = 1) -> Dict[str, tuple]:
    """State-dict name -> placements, one per mesh axis (reference
    ``param_partition_specs:35``)."""
    return {n: placements_of(l) for n, l in param_layouts(cfg, tp).items()}


def shard_params(params: Dict[str, torch.Tensor], mesh,
                 cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """Every tensor of a full state dict placed on ``mesh`` as a DTensor
    with its canonical placements (reference ``shard_params:114``). Each
    rank passes the same full values and keeps its own shard; nothing is
    sent."""
    from torch.distributed.tensor import distribute_tensor

    specs = param_partition_specs(cfg, mesh_degree(mesh, "tp"))
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")
    return {n: distribute_tensor(t.detach().to(dev), mesh, specs[n],
                                 src_data_rank=None)
            for n, t in params.items()}


def mesh_degree(mesh, axis: str) -> int:
    return mesh.size(AXIS_ORDER.index(axis))


def mesh_coord(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


# ---------------- the cast's layouts ----------------

# Replicated parameters whose gradient each tp rank computes only in part
# (its own heads); every other replicated parameter gets the same gradient
# on every tp rank.
_TP_PARTIAL_SUFFIXES = ("q_norm.weight", "k_norm.weight")
_KV_SUFFIXES = ("wk.weight", "wv.weight", "wk.bias", "wv.bias")
# gathered over tp before use (the lookup and the head see every row)
_TP_GATHERED = ("embedding.weight", "lm_head.weight")


_EXPERT_SUFFIXES = ("e_gate", "e_up", "e_down")


def _is_expert_stack(name: str) -> bool:
    return name.split(".", 2)[-1] in _EXPERT_SUFFIXES


def compute_placements(name: str, layout: Layout,
                       expert_local: bool = False) -> tuple:
    """The placements a master is used in: gathered over every axis but
    ``tp``, and over ``tp`` too for the embedding and an untied head. With
    ``expert_local`` an expert stack also keeps its ``ep`` shard (the
    owner's experts, for the expert-parallel dispatch)."""
    kept = ("tp", "ep") if expert_local and _is_expert_stack(name) else ("tp",)
    keep = {} if name in _TP_GATHERED else {
        a: d for a, d in layout.items() if a in kept}
    return placements_of(keep)


def grad_placements(name: str, layout: Layout, cfg: TransformerConfig,
                    tp: int, expert_local: bool = False) -> tuple:
    """The placements of the local gradient of a master's compute copy:
    partial over the data axes (each data rank saw its own micro-batches)
    and over ``sp`` (each sequence rank backpropagated its own tokens);
    over ``tp``, the shard where the copy is sharded, partial where each
    rank computed only its heads' share, else replicated. Over ``pp`` it
    is replicated: a stage's layers are its own, and the engine sums the
    parameters every stage holds over the ``pp`` group itself, once a
    step (``backend/torch_train.py``). With ``expert_local`` an expert
    stack's gradient is this owner's shard over ``ep``, whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    suffix = name.split(".", 2)[-1]
    out = []
    for a in AXIS_ORDER:
        if a == "ep" and expert_local and _is_expert_stack(name):
            out.append(Shard(layout["ep"]))
        elif a in DATA_AXES or a == "sp":
            out.append(Partial())
        elif a != "tp":
            out.append(Replicate())
        elif "tp" in layout and name not in _TP_GATHERED:
            out.append(Shard(layout["tp"]))
        elif suffix in _TP_PARTIAL_SUFFIXES or (
                suffix in _KV_SUFFIXES and kv_replicated(cfg, tp)):
            out.append(Partial())
        else:
            out.append(Replicate())
    return tuple(out)


def kv_head_rows(cfg: TransformerConfig, tp: int, tp_rank: int
                 ) -> Optional[slice]:
    """Rows of a replicated ``wk``/``wv`` (or ``bk``/``bv``) this tp rank
    uses: the kv heads its q heads read. None when kv is sharded."""
    if not kv_replicated(cfg, tp):
        return None
    q_per_rank = cfg.n_q_heads // tp
    group = cfg.n_q_heads // cfg.n_kv_heads
    h = (tp_rank * q_per_rank) // group
    return slice(h * cfg.head_dim, (h + 1) * cfg.head_dim)


# ---------------- serving ----------------

# A rank's cut of one tensor: a (dim, start, length) per cut dim, () whole.
Cut = Tuple[Tuple[int, int, int], ...]


def _even_cut(name: str, shape, dim: int, n: int, i: int, axis: str
              ) -> Tuple[int, int, int]:
    size = shape[dim] // n
    if size * n != shape[dim]:
        raise ValueError(f"{axis}={n} does not divide dim {dim} of {name} "
                         f"{tuple(shape)}")
    return (dim, i * size, size)


def serving_slices(cfg: TransformerConfig, spec: ParallelSpec
                   ) -> List[Dict[str, Cut]]:
    """Each rank of a generation server of ``spec`` (its ``fsdp``, ``pp``
    and ``tp``, ``parallel/mesh.py ServerRank``) ->
    the tensors it holds, by state-dict name, and its cut of each: the
    layout a generation server's ranks hold (the serving counterpart of
    :func:`shard_params`).

     - ``pp``: a rank holds its stage's layers (``parallel/pipeline.py
       stage_bounds``) and every tensor outside the layers (the embedding,
       the final norm and an untied head), as the reference replicates
       them over ``pp``;
     - ``tp``: ``tp``-sharded parameters split evenly along the dim
       :func:`param_layouts` names; the embedding and an untied head whole,
       as the trainer's ``tp`` uses them (so every rank computes the whole
       logits); a replicated ``wk``/``wv``/``bk``/``bv`` cut to the kv head
       the rank's q heads read (:func:`kv_head_rows`);
     - ``fsdp``: every parameter with an ``fsdp`` dim split evenly along
       it; the server gathers a layer's shards just before the layer runs
       (:class:`FsdpGather`).

    Raises for head counts no rule splits (:func:`kv_replicated`), a dim
    an axis does not divide, or a stage without a layer."""
    from areal_tpu_torch.models.transformer import Transformer
    from areal_tpu_torch.parallel.mesh import ServerRank
    from areal_tpu_torch.parallel.pipeline import stage_bounds

    tp, fsdp = spec.tp, spec.fsdp
    if spec.pp > cfg.n_layers:
        raise ValueError(f"pp={spec.pp} stages for {cfg.n_layers} layers: "
                         "a stage holds at least one layer")
    bounds = stage_bounds(cfg.n_layers, spec.pp)
    replicated = kv_replicated(cfg, tp)
    shapes = {n: t.shape for n, t in
              Transformer(cfg, device="meta").state_dict().items()}
    layouts = param_layouts(cfg, tp)
    out: List[Dict[str, Cut]] = []
    for rank in range(spec.world_size):
        me = ServerRank(spec, rank)
        lo, hi = bounds[me.pp_rank]
        cuts: Dict[str, Cut] = {}
        for name, lay in layouts.items():
            if name.startswith("layers.") and not (
                    lo <= int(name.split(".")[1]) < hi):
                continue
            suffix = name.split(".", 2)[-1]
            cut = []
            if tp > 1 and replicated and suffix in _KV_SUFFIXES:
                s = kv_head_rows(cfg, tp, me.tp_rank)
                cut.append((0, s.start, s.stop - s.start))
            elif tp > 1 and "tp" in lay and name not in _TP_GATHERED:
                cut.append(_even_cut(name, shapes[name], lay["tp"], tp,
                                     me.tp_rank, "tp"))
            if fsdp > 1 and "fsdp" in lay:
                cut.append(_even_cut(name, shapes[name], lay["fsdp"], fsdp,
                                     me.fsdp_rank, "fsdp"))
            cuts[name] = tuple(cut)
        out.append(cuts)
    return out


def take_slice(t: torch.Tensor, cut: Cut) -> torch.Tensor:
    """A view of ``t``'s cut (``t`` itself for ``()``)."""
    for dim, start, length in cut:
        t = t.narrow(dim, start, length)
    return t


def cut_shape(shape, cut: Cut) -> List[int]:
    out = list(shape)
    for dim, _, length in cut:
        out[dim] = length
    return out


def serving_shards(params: Dict[str, torch.Tensor], cfg: TransformerConfig,
                   spec: ParallelSpec, rank: int
                   ) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s tensors of a whole state dict (global names; views:
    the caller copies them where it needs its own storage)."""
    cuts = serving_slices(cfg, spec)[rank]
    return {n: take_slice(params[n], c) for n, c in cuts.items()}


def shift_layers(params: Dict[str, torch.Tensor], offset: int
                 ) -> Dict[str, torch.Tensor]:
    """``params`` with every layer index moved by ``offset``: a stage's
    model names its layers from 0 (``offset = -lo``), a layout names them
    by their place in the whole model (``offset = lo``)."""
    if not offset:
        return dict(params)
    out = {}
    for n, t in params.items():
        if n.startswith("layers."):
            _, i, rest = n.split(".", 2)
            n = f"layers.{int(i) + offset}.{rest}"
        out[n] = t
    return out


def rank_config(cfg: TransformerConfig, spec: ParallelSpec, rank: int = 0
                ) -> TransformerConfig:
    """The geometry rank ``rank`` of a server of ``spec`` computes with: its stage's layers, its q heads, the kv heads
    they read, and its share of the MLP (or expert) width. ``fsdp`` leaves
    it whole (a layer runs on its gathered weights). Its KV cache
    (``init_kv_cache``) then holds the rank's layers and kv heads."""
    import dataclasses

    from areal_tpu_torch.parallel.mesh import ServerRank
    from areal_tpu_torch.parallel.pipeline import stage_bounds

    tp, kw = spec.tp, {}
    if spec.pp > 1:
        lo, hi = stage_bounds(cfg.n_layers, spec.pp)[
            ServerRank(spec, rank).pp_rank]
        kw["n_layers"] = hi - lo
    if tp > 1:
        replicated = kv_replicated(cfg, tp)
        kw.update(n_q_heads=cfg.n_q_heads // tp,
                  n_kv_heads=1 if replicated else cfg.n_kv_heads // tp,
                  intermediate_dim=cfg.intermediate_dim // tp)
        if cfg.moe is not None:
            moe = cfg.moe
            kw["moe"] = dataclasses.replace(
                moe, routed_intermediate_dim=(
                    moe.routed_intermediate_dim or cfg.intermediate_dim)
                // tp,
                shared_intermediate_dim=(moe.shared_intermediate_dim // tp
                                         if moe.shared_intermediate_dim
                                         else None))
    return dataclasses.replace(cfg, **kw) if kw else cfg


def fsdp_dims(cfg: TransformerConfig, spec: ParallelSpec) -> Dict[str, int]:
    """State-dict name -> the dim ``fsdp`` splits, for a server of ``spec``
    (empty at ``fsdp`` 1): what :class:`FsdpGather` concatenates along."""
    if spec.fsdp <= 1:
        return {}
    return {n: lay["fsdp"] for n, lay in param_layouts(cfg, spec.tp).items()
            if "fsdp" in lay}


class FsdpGather:
    """ZeRO-3 for a served forward: a module's parameters whole over the
    ``fsdp`` group, gathered when the forward asks for them and dropped
    when it lets go. One ``all_gather`` moves all of a module's shards
    (packed flat; a layer's are about one layer's bytes / ``fsdp``), and
    each parameter is then put together along the dim
    :func:`serving_slices` cut. ``dims``: the rank's local state-dict name
    -> its ``fsdp`` dim (absent: whole). Every rank of the group asks for
    the same modules in the same order (they run the same batch)."""

    def __init__(self, group, n: int, dims: Dict[str, int]):
        self.group, self.n, self.dims = group, n, dims
        # over the rank's life: gathers, bytes received, host seconds
        self.stats = {"gathers": 0, "bytes": 0, "secs": 0.0}

    def __call__(self, module: torch.nn.Module, prefix: str
                 ) -> Dict[str, torch.Tensor]:
        """``module``'s parameters (named as in ``module``) whole;
        ``prefix`` is its name in the rank's model."""
        out = dict(module.named_parameters())
        cut = [n for n in out if prefix + n in self.dims]
        if not cut:
            return out
        t0 = time.perf_counter()
        flat = torch.cat([out[n].reshape(-1) for n in cut])
        parts = [torch.empty_like(flat) for _ in range(self.n)]
        dist.all_gather(parts, flat, group=self.group)
        self.stats["gathers"] += 1
        self.stats["bytes"] += flat.numel() * flat.element_size() * (
            self.n - 1)
        at = 0
        for n in cut:
            shard = out[n]
            k = shard.numel()
            out[n] = torch.cat([p[at:at + k].view(shard.shape)
                                for p in parts], dim=self.dims[prefix + n])
            at += k
        self.stats["secs"] += time.perf_counter() - t0
        return out


# ---------------- activations ----------------

_ACTIVE: List[Tuple] = []  # stack of (tp group, tp size)


@contextlib.contextmanager
def activation_sharding(mesh):
    """Arm :func:`constrain` with ``mesh``'s tp group for the forward and
    backward run inside (a remat recompute included)."""
    tp = mesh_degree(mesh, "tp") if mesh is not None else 1
    _ACTIVE.append((mesh.get_group("tp") if tp > 1 else None, tp))
    try:
        yield
    finally:
        _ACTIVE.pop()


def tp_active() -> bool:
    return bool(_ACTIVE) and _ACTIVE[-1][1] > 1


class _ColumnIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _RowOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


# The activation points where data crosses the tp group (the reference's
# ACTIVATION_RULES name layouts GSPMD enforces; the port's data split is
# over micro-batches, backend/torch_train.py, so only these move data):
# the hidden state entering a column-parallel block, and the partial sums
# leaving a row-parallel one.
ACTIVATION_RULES: Dict[str, type] = {"column_in": _ColumnIn,
                                     "row_out": _RowOut}


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The tp transition ``kind`` (a key of ``ACTIVATION_RULES``) of
    ``x``; the identity outside a tp context."""
    if not tp_active():
        return x
    return ACTIVATION_RULES[kind].apply(x, _ACTIVE[-1][0])
