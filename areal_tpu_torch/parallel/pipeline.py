"""Pipeline parallelism: micro-batches streaming through the stages of the
mesh's ``pp`` axis.

The port's counterpart of ``areal_tpu/parallel/pipeline.py``. Stage ``k``
owns layers ``[k·L/pp, (k+1)·L/pp)`` (:func:`stage_bounds`); the rows of
the batch split into ``n_micro`` micro-batches (:func:`pick_pp_microbatches`)
that stream through the stages, each stage handing its output to the next.
As in the reference, only the layer stack pipelines: the embedding, the
head and the loss stay outside (``models/transformer.py``), and decode
never pipelines.

Two schedules, one differentiable op (:class:`_PipelineFn`) over the same
per-stage loops (:meth:`_Schedule.forward`, :meth:`_Schedule.backward`):

 - ``"1f1b"`` (the default): the reference's memory-bounded trade. The
   forward keeps only each stage's ``n_micro`` micro-batch **inputs** (the
   saved-input buffer, :func:`backward_residual_bytes`); at each step of
   the backward a stage runs one forward (a recompute from the saved
   input) and one backward (``torch.autograd.grad`` on that graph against
   the cotangent from its successor) and passes the input's cotangent to
   its predecessor. Live activations: the saved inputs plus one
   micro-batch's graph per stage;
 - ``"gpipe"`` (the oracle): the forward keeps every micro-batch's graph;
   the backward runs ``torch.autograd.grad`` on the saved graphs. Live
   activations: ``n_micro`` graphs per stage.

The activations and their cotangents travel over a link with two
implementations: :class:`_P2PLink`, ``isend``/``recv`` over the ``pp``
process group (one process per stage; a generation server's stages use
it too, ``models/generate.py StageChain``), and
:class:`_LocalLink`, in-memory queues for one process that runs every
stage on one device, one stage after another. A :class:`PipeCtx` names
which (``stage`` None: one process).

PP∘SP: a ring context (``parallel/ring.py RingCtx``) handed in reaches
every layer of every stage, so attention rings inside the stages; the
sequence layout is applied once at the model's boundary.

Expert parallelism never runs inside a stage, as in the reference: a
stage's MoE layers run the grouped dispatch on experts gathered whole
over ``ep`` (the engine's compute copies, ``parallel/sharding.py
compute_placements``), and ``ep`` splits the batch as a data axis.

The fallback: where a gate of :func:`pick_pp_microbatches` fails, the
stages still run (the layers live on their stages), in order, as a single
pipeline micro-batch; the ``parallel/pp_fallback{reason=...}`` counter is
bumped and a warning names the gate once.
"""

from __future__ import annotations

import collections
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from areal_tpu_torch.base import logging, telemetry
from areal_tpu_torch.parallel.ring import mesh_axis, ring_eligible

logger = logging.getLogger("parallel.pipeline")

SCHEDULES = ("1f1b", "gpipe")

# One warning per reason (the gate runs per forward; the operator needs
# the reason once).
_WARNED_FALLBACKS: set = set()

_FALLBACK_HINTS = {
    "layers_indivisible": "n_layers must divide the pp axis",
    "batch_too_small": "batch has no divisor in [pp, 2*pp]",
    "requested_indivisible": "requested micro-batch count must divide batch",
    "sp_seq_indivisible": "seq_len must divide the sp axis to ring",
    "sp_sliding_window": "sliding-window attention is not ring-expressible",
}


def _fallback(reason: str) -> None:
    """Fallback bookkeeping: a counter per reason plus a one-time warning
    naming the failed gate."""
    telemetry.inc(f"parallel/pp_fallback{{reason={reason}}}")
    if reason not in _WARNED_FALLBACKS:
        _WARNED_FALLBACKS.add(reason)
        logger.warning(
            "pipeline disengaged, running the stages in order as one "
            "micro-batch: %s (%s)", reason, _FALLBACK_HINTS.get(reason, "")
        )
    return None


def pick_pp_microbatches(
    mesh,
    cfg,
    batch: int,
    requested: Optional[int] = None,
    seq_len: Optional[int] = None,
) -> Optional[int]:
    """The pipeline gate: the micro-batch count, or None when the stages
    should run unpipelined. ``mesh`` is a ``DeviceMesh``, a
    ``ParallelSpec`` or None.

    Requirements: a ``pp`` axis > 1, layers divisible across stages, and a
    batch divisible into >= pp micro-batches (auto: the largest divisor in
    ``[pp, 2pp]``). With sp > 1 (PP∘SP) the sequence must shard over the
    ring and the attention be ring-expressible (no sliding window)."""
    pp = mesh_axis(mesh, "pp")
    if pp <= 1:
        return None  # no pipeline requested — not a fallback
    if mesh_axis(mesh, "sp") > 1:
        if seq_len is None or seq_len % mesh_axis(mesh, "sp") != 0:
            return _fallback("sp_seq_indivisible")
        if cfg.sliding_window is not None:
            return _fallback("sp_sliding_window")
    if cfg.n_layers % pp != 0:
        return _fallback("layers_indivisible")
    if requested is not None:
        if batch % requested != 0:
            return _fallback("requested_indivisible")
        return requested
    for n_micro in range(min(2 * pp, batch), 0, -1):
        if batch % n_micro == 0 and n_micro >= pp:
            return n_micro
    return _fallback("batch_too_small")


def pp_engagement(mesh, cfg, batch: int, seq_len: int,
                  requested: Optional[int] = None) -> Tuple[float, float]:
    """(pp_engaged, ring_engaged) as 0/1 gauge values for this shape: the
    gates the forward applies (``train/pp_engaged``,
    ``train/ring_engaged``)."""
    n_micro = pick_pp_microbatches(mesh, cfg, batch, requested,
                                   seq_len=seq_len)
    if n_micro is not None:
        ring_on = mesh_axis(mesh, "sp") > 1
    else:
        ring_on = ring_eligible(mesh, cfg, batch, seq_len)
    return float(n_micro is not None), float(ring_on)


def _aux_keys(cfg) -> Tuple[str, ...]:
    """The SCALAR MoE aux keys the pipeline carries (summed over layers,
    micro-batches and stages). The per-expert ``expert_load`` vector does
    not pipeline, as in the reference."""
    return (("aux_total", "load_balance_loss", "z_loss", "dropped_frac",
             "expert_load_ratio")
            if cfg.moe is not None else ())


def _scale_aux(cfg, n_micro: int) -> List[float]:
    """Per-key factors taking the summed aux to the layer stack's
    contract: aux_total a total over layers, the others layer means, each
    averaged over the micro-batches."""
    return [1.0 / n_micro if k == "aux_total"
            else 1.0 / (cfg.n_layers * n_micro) for k in _aux_keys(cfg)]


def stage_bounds(n_layers: int, pp: int) -> List[Tuple[int, int]]:
    """Each stage's ``[lo, hi)`` layers (as even as the count allows)."""
    return [(k * n_layers // pp, (k + 1) * n_layers // pp) for k in range(pp)]


@dataclass(frozen=True)
class PipeCtx:
    """Where a pipeline runs: ``pp`` stages; ``stage`` this process's
    (None: one process runs every stage); ``group`` the ``pp`` process
    group; ``schedule`` ("1f1b" | "gpipe", None: ``AREAL_PP_SCHEDULE`` or
    "1f1b"); ``sp`` the ring's size, for the gates."""
    pp: int
    stage: Optional[int] = None
    group: Any = None
    schedule: Optional[str] = None
    sp: int = 1

    @property
    def one_process(self) -> bool:
        return self.stage is None

    def stages(self) -> List[int]:
        return list(range(self.pp)) if self.stage is None else [self.stage]

    def resolved_schedule(self) -> str:
        s = self.schedule or os.environ.get("AREAL_PP_SCHEDULE", "1f1b")
        if s not in SCHEDULES:
            raise ValueError(f"unknown pipeline schedule {s!r}")
        return s


# ---------------- the links between stages ----------------

class _LocalLink:
    """One process, every stage: a queue per (direction, receiving
    stage). Stages run one after another, so a stage's receives find what
    its neighbour sent."""

    def __init__(self):
        self.queues = collections.defaultdict(collections.deque)

    def send(self, kind: str, dst: int, t: torch.Tensor) -> None:
        self.queues[(kind, dst)].append(t)

    def recv(self, kind: str, src: int, dst: int, shape, dtype, device):
        return self.queues[(kind, dst)].popleft()

    def flush(self) -> None:
        pass


class _P2PLink:
    """One process per stage over the ``pp`` group: sends are ``isend``s
    waited at :meth:`flush`, receives block. Each pair of neighbours sends
    in one order (micro-batch order) and receives in the same, so the
    messages match without tags. Over gloo (two ranks that share a card
    run it) a tensor crosses through host memory, since gloo's send and
    receive take no CUDA tensor: :meth:`send` copies it to the host,
    :meth:`recv` receives into host memory and copies it onto ``device``.
    Over NCCL it stays on the device."""

    def __init__(self, ctx: PipeCtx):
        import torch.distributed as dist

        self.ranks = dist.get_process_group_ranks(ctx.group)
        self.group = ctx.group
        self.host = dist.get_backend(ctx.group) == "gloo"
        self.pending: List[tuple] = []

    def send(self, kind: str, dst: int, t: torch.Tensor) -> None:
        import torch.distributed as dist

        t = t.detach().contiguous()
        if self.host:
            t = t.cpu()
        self.pending.append((dist.isend(t, self.ranks[dst],
                                        group=self.group), t))

    def recv(self, kind: str, src: int, dst: int, shape, dtype, device):
        import torch.distributed as dist

        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if self.host else device)
        dist.recv(buf, self.ranks[src], group=self.group)
        return buf.to(device)

    def flush(self) -> None:
        for work, _ in self.pending:
            work.wait()
        self.pending.clear()


# ---------------- one stage's layers ----------------

def _make_stage_fn(cfg, attn_impl, remat, ring):
    """One stage's layer application, shared by both schedules' forwards
    and the 1F1B recompute: ``fn(layers, params, x, cos, sin, seg, pos) ->
    (y, aux)``, ``params`` one ``{name: tensor}`` per layer, ``aux`` the
    scalar aux keys summed over the stage's layers (an empty vector for a
    dense model)."""
    from areal_tpu_torch.models import transformer as tfm

    keys = _aux_keys(cfg)

    def stage_fn(layers, params, x, cos, sin, seg, pos):
        auxes = []
        for layer, p in zip(layers, params):
            if remat:
                x, aux = tfm._checkpointed_layer(
                    layer, remat, x, cos, sin, seg, pos, attn_impl,
                    ring=ring, params=p)
            else:
                x, _, aux = torch.func.functional_call(
                    layer, p, (x, cos, sin, seg, pos, None, None, None,
                               attn_impl, None, ring))
            if aux is not None:
                auxes.append(aux)
        if not keys:
            return x, x.new_zeros(0, dtype=torch.float32)
        return x, torch.stack([sum(a[k].float() for a in auxes)
                               for k in keys])

    return stage_fn


class _Schedule:
    """The state of one pipelined call: the local stages' layers and
    parameters, the micro-batched side inputs, the link, and what the
    forward keeps for the backward."""

    def __init__(self, cfg, layers, params, ctx: PipeCtx, n_micro: int,
                 side, act_shape, act_dtype, device, attn_impl, remat,
                 ring):
        self.cfg, self.ctx, self.n_micro = cfg, ctx, n_micro
        self.layers = layers  # stage -> [Block]
        self.params = params  # stage -> [{name: tensor}] per layer
        self.side = side  # (cos, sin, seg, pos) each split per micro-batch
        self.act_shape, self.act_dtype, self.device = (act_shape, act_dtype,
                                                       device)
        self.gpipe = ctx.resolved_schedule() == "gpipe"
        self.stage_fn = _make_stage_fn(cfg, attn_impl, remat, ring)
        self.link = _LocalLink() if ctx.one_process else _P2PLink(ctx)
        self.aux_scale = torch.tensor(_scale_aux(cfg, n_micro),
                                      dtype=torch.float32, device=device)
        self.saved: Dict[tuple, Any] = {}
        self.leaves: Dict[int, list] = {}

    def _side(self, j):
        return [None if s is None else s[j] for s in self.side]

    def _leaves(self, k):
        """Stage k's parameters as leaves of the graphs built here (the
        same storage, detached), made once per call."""
        if k not in self.leaves:
            self.leaves[k] = [{n: t.detach().requires_grad_(
                t.is_floating_point()) for n, t in p.items()}
                for p in self.params[k]]
        return self.leaves[k]

    def _run(self, k, x, params, j):
        return self.stage_fn(self.layers[k], params, x, *self._side(j))

    def forward(self, h, keep: bool):
        """Every local stage over every micro-batch; returns (the last
        stage's output [B, T, D] — zeros on another stage — and the scaled
        aux vector). ``keep``: save what the backward needs."""
        last = self.ctx.pp - 1
        h_mbs = h.chunk(self.n_micro) if 0 in self.ctx.stages() else None
        out, aux_acc = [None] * self.n_micro, None
        for k in self.ctx.stages():
            for j in range(self.n_micro):
                x = h_mbs[j] if k == 0 else self.link.recv(
                    "fwd", k - 1, k, self.act_shape, self.act_dtype,
                    self.device)
                if keep and self.gpipe:
                    x = x.detach().requires_grad_()
                    with torch.enable_grad():
                        y, aux = self._run(k, x, self._leaves(k), j)
                    self.saved[(k, j)] = (x, y, aux)
                else:
                    if keep:
                        self.saved[(k, j)] = x.detach()
                    with torch.no_grad():
                        y, aux = self._run(k, x, self.params[k], j)
                aux = aux.detach()
                aux_acc = aux if aux_acc is None else aux_acc + aux
                if k == last:
                    out[j] = y.detach()
                else:
                    self.link.send("fwd", k + 1, y.detach())
        self.link.flush()
        if last in self.ctx.stages():
            out = torch.cat(out)
        else:
            B = self.act_shape[0] * self.n_micro
            out = torch.zeros((B,) + tuple(self.act_shape[1:]),
                              dtype=self.act_dtype, device=self.device)
        return out, aux_acc * self.aux_scale

    def backward(self, d_out, d_aux):
        """The reverse pipeline: per local stage (last first), per
        micro-batch, the cotangent from the successor (or ``d_out``) run
        back through the stage's graph, saved (GPipe) or recomputed from
        the saved input (1F1B). Returns (d_h or None, {stage: per-layer
        {name: grad}})."""
        last = self.ctx.pp - 1
        d_out_mbs = d_out.chunk(self.n_micro) \
            if last in self.ctx.stages() else None
        d_aux = None if d_aux is None else d_aux * self.aux_scale
        grads: Dict[int, list] = {}
        d_h = [None] * self.n_micro
        for k in reversed(self.ctx.stages()):
            leaves = self._leaves(k)
            flat = [(i, n, t) for i, p in enumerate(leaves)
                    for n, t in p.items() if t.requires_grad]
            acc = [dict() for _ in leaves]
            for j in range(self.n_micro):
                dy = d_out_mbs[j] if k == last else self.link.recv(
                    "bwd", k + 1, k, self.act_shape, self.act_dtype,
                    self.device)
                if self.gpipe:
                    x, y, aux = self.saved.pop((k, j))
                else:
                    x = self.saved.pop((k, j)).requires_grad_()
                    with torch.enable_grad():
                        y, aux = self._run(k, x, leaves, j)
                outs, gouts = [y], [dy.to(y.dtype)]
                if aux.numel() and d_aux is not None and aux.requires_grad:
                    outs.append(aux)
                    gouts.append(d_aux)
                gs = torch.autograd.grad(outs, [x] + [t for _, _, t in flat],
                                         gouts, allow_unused=True)
                # summed over the micro-batches in float32, rounded once
                # to the parameter's dtype by autograd on the way out
                for (i, n, _), g in zip(flat, gs[1:]):
                    if g is not None:
                        acc[i][n] = g.float() if n not in acc[i] \
                            else acc[i][n] + g
                dx = gs[0] if gs[0] is not None else torch.zeros_like(x)
                if k > 0:
                    self.link.send("bwd", k - 1, dx)
                else:
                    d_h[j] = dx
            grads[k] = acc
        self.link.flush()
        return (torch.cat(d_h) if d_h[0] is not None else None), grads


class _PipelineFn(torch.autograd.Function):
    """The pipeline as one differentiable op: inputs the stage-0 hidden
    and the local stages' parameters (flattened), outputs the last stage's
    hidden and the scaled aux vector."""

    @staticmethod
    def forward(ctx, sched, names, h, *flat):
        ctx.sched, ctx.names = sched, names
        return sched.forward(h, keep=True)

    @staticmethod
    def backward(ctx, d_out, d_aux):
        d_h, grads = ctx.sched.backward(d_out, d_aux)
        flat = [grads[k][i].get(n) for k, i, n in ctx.names]
        return (None, None, d_h, *flat)


def _schedule(cfg, layers, h, cos, sin, segment_ids, positions,
              ctx: PipeCtx, n_micro: int, attn_impl, remat, ring):
    """The local stages' layers and parameters (read from the modules:
    under ``functional_call``, the substituted ones) in a
    :class:`_Schedule`; with the parameters flattened, and their (stage,
    layer, name) keys, for :class:`_PipelineFn`."""
    B = h.shape[0]
    assert B % n_micro == 0, (B, n_micro)
    bounds = stage_bounds(cfg.n_layers, ctx.pp)
    stage_layers = {k: [layers[i] for i in range(*bounds[k])]
                    for k in ctx.stages()}
    stage_params = {k: [dict(layer.named_parameters()) for layer in ls]
                    for k, ls in stage_layers.items()}
    names = [(k, i, n) for k, ps in stage_params.items()
             for i, p in enumerate(ps) for n in p]
    flat = [stage_params[k][i][n] for k, i, n in names]
    side = [None if s is None else s.chunk(n_micro)
            for s in (cos, sin, segment_ids, positions)]
    act_shape = (B // n_micro,) + tuple(h.shape[1:])
    sched = _Schedule(cfg, stage_layers, stage_params, ctx, n_micro, side,
                      act_shape, h.dtype, h.device, attn_impl, remat, ring)
    return sched, names, flat


def pipeline_apply_layers(
    cfg,
    layers,  # every layer of the model (a ModuleList of Blocks)
    h: torch.Tensor,  # [B, T, D]: stage 0's input
    cos: Optional[torch.Tensor],
    sin: Optional[torch.Tensor],
    segment_ids: Optional[torch.Tensor],
    positions: Optional[torch.Tensor],
    ctx: PipeCtx,
    n_micro: int,
    attn_impl: str = "auto",
    remat=False,
    ring=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the layers as a ``ctx.pp``-stage pipeline over ``n_micro``
    micro-batches of ``h``'s rows. Returns (h, aux) as the layer loop
    does: aux_total a total over layers, the other MoE stats layer means,
    each averaged over the micro-batches ({} for a dense model). On a
    process that runs one stage, the layers are its own, the output is
    zeros but on the last stage and the aux covers its own layers only."""
    sched, names, flat = _schedule(cfg, layers, h, cos, sin, segment_ids,
                                   positions, ctx, n_micro, attn_impl, remat,
                                   ring)
    needs_grad = torch.is_grad_enabled() and (
        h.requires_grad or any(t.requires_grad for t in flat))
    if needs_grad:
        out, aux_vec = _PipelineFn.apply(sched, names, h, *flat)
    else:
        out, aux_vec = sched.forward(h, keep=False)
    aux = {k: aux_vec[i] for i, k in enumerate(_aux_keys(cfg))}
    return out, aux


def backward_residual_bytes(cfg, layers, h, cos, sin, segment_ids,
                            positions, ctx: PipeCtx, n_micro: int,
                            attn_impl: str = "auto", remat=False,
                            ring=None) -> int:
    """PER-STAGE bytes of activation residuals the 1F1B backward keeps
    between forward and backward, measured from what the forward actually
    saved (not a formula): each stage's ``n_micro`` micro-batch inputs,
    counted as whole sequences under a ring (``h`` in the ring's layout,
    every shard). Excludes the parameters."""
    one = PipeCtx(pp=ctx.pp, stage=ctx.stage, group=ctx.group,
                  schedule="1f1b", sp=ctx.sp)
    sched, _, _ = _schedule(cfg, layers, h, cos, sin, segment_ids, positions,
                            one, n_micro, attn_impl, remat, ring)
    sched.forward(h, keep=True)
    total = sum(t.numel() * t.element_size() for t in sched.saved.values())
    if ring is not None and not ring.one_process:
        total *= ring.n  # this rank's shard of each input → the whole
    return total // len(ctx.stages())
