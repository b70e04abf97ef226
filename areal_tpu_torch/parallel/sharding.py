"""Sharding rules: DTensor placements for parameters, and the points where
activations cross the tensor-parallel group.

The port's counterpart of ``areal_tpu/parallel/sharding.py``
(``param_partition_specs:35``, ``shard_params:114``, ``ACTIVATION_RULES``,
``constrain``). The reference writes a ``PartitionSpec`` per leaf and lets
GSPMD insert the collectives. The port keeps the same table, written as
one DTensor placement per mesh axis (``mesh.AXIS_ORDER``) in its own
layout (``nn.Linear`` weights are ``[out, in]``, layers are not stacked, so
the reference's ``pp`` entry of a stacked leaf has no counterpart), and
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
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.parallel.mesh import AXIS_ORDER, DATA_AXES

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
    divided by ``tp``."""
    if tp <= 1:
        return False
    if cfg.n_q_heads % tp:
        raise ValueError(f"tensor parallelism of {tp} does not divide "
                         f"{cfg.n_q_heads} query heads")
    if cfg.n_kv_heads % tp == 0:
        return False
    if tp % cfg.n_kv_heads:
        raise ValueError(f"tensor parallelism of {tp} neither divides nor "
                         f"is divided by {cfg.n_kv_heads} kv heads")
    return True


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


def compute_placements(name: str, layout: Layout) -> tuple:
    """The placements a master is used in: gathered over every axis but
    ``tp``, and over ``tp`` too for the embedding and an untied head."""
    keep = {} if name in _TP_GATHERED else {
        a: d for a, d in layout.items() if a == "tp"}
    return placements_of(keep)


def grad_placements(name: str, layout: Layout, cfg: TransformerConfig,
                    tp: int) -> tuple:
    """The placements of the local gradient of a master's compute copy:
    partial over the data axes (each data rank saw its own micro-batches);
    over ``tp``, the shard where the copy is sharded, partial where each
    rank computed only its heads' share, else replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    suffix = name.split(".", 2)[-1]
    out = []
    for a in AXIS_ORDER:
        if a in DATA_AXES:
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
