"""The dense decoder-only transformer as an ``nn.Module``.

Counterpart of ``areal_tpu/models/transformer.py`` (``forward:398``,
``_block:160``, ``apply_head:519``, ``init_kv_cache:530``). Differences in
form, not in arithmetic:

 - the layers are a ``ModuleList`` of :class:`Block` instead of a pytree
   stacked on a leading layer axis; projections are ``nn.Linear`` (weights
   ``[out, in]``; ``models/convert.py`` is the one place that maps the
   reference's ``[in, out]`` stacks);
 - in cache mode (decode and suffix extension) the new K/V are written into
   the given cache tensors **in place** and those same tensors are returned,
   where the reference returns updated copies. Callers hand ``forward`` only
   cache buffers they own (``models/generate.py``).

Supports GQA, rotate-half RoPE or a learned position table (GPT-2),
RMSNorm or LayerNorm, gated or plain MLP, optional qk-norm and attention
biases, scaled embeddings (Gemma), tied or untied embeddings, the critic's
value head (``is_critic``: ``value_head [1, D]``, no bias, values ``[B, T]``
in the compute dtype), Mixture-of-Experts blocks (``models/moe.py``; the
reference's ``_block:260-280``) with their balancing aux (``return_aux``)
and the training forward: no KV stack (``return_kv=False``), the final
hidden instead of logits (``return_hidden=True``) and per-layer remat
(``_maybe_checkpoint:385``). Tensor parallelism runs inside
:class:`Block` through ``parallel/sharding.py constrain`` (the rank's heads
and MLP columns, Megatron's two sums over ``tp``). Ring and pipeline
parallelism, and the MoE expert-parallel path, are still to come
(ROADMAP.md Queue 1).

Learned positions differ from the reference in one respect, by design. The
reference adds ``pos_embedding[positions]`` (``forward:430``), whose gather
clamps an index past the table, so a token at position >=
``max_position_embeddings`` silently reuses the last row. Here a kept token
(segment id != 0 in packed mode; every row in cache mode) at such a position
raises ``ValueError``; pad tokens (segment 0), whose outputs are masked,
index a clamped position, so their results equal the reference's and no
index trips a device assert.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from areal_tpu_torch import resolve_device
from areal_tpu_torch.models import moe as moemod
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.ops.attention import decode_attention, packed_attention
from areal_tpu_torch.parallel.sharding import constrain, tp_active

KVCache = Dict[str, torch.Tensor]


# ---------------- primitives ----------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    # The normalised value is cast back to the input dtype BEFORE the weight
    # multiply, as in the reference (bf16 rounding points must match).
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (w * (x32 * torch.rsqrt(var + eps)).to(dt)).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    return (w * ((x32 - mu) * torch.rsqrt(var + eps)).to(dt) + b).to(dt)


_ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


def rope_tables(positions: torch.Tensor, head_dim: int,
                base: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [..., head_dim] (f32) for rotate-half RoPE."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv_freq = 1.0 / (base ** exps)
    angles = positions[..., None].float() * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, Dh]; cos/sin: [B, T, Dh], cast to x's dtype first."""
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * c + rot * s


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


def _norm(cfg: TransformerConfig, dim: int, **factory) -> nn.Module:
    cls = LayerNorm if cfg.norm_type == "layer" else RMSNorm
    return cls(dim, cfg.rms_norm_eps, **factory)


# ---------------- one block ----------------

_MOE_KEYS = ("router", "e_gate", "e_up", "e_down", "s_gate", "s_up", "s_down")


class Block(nn.Module):
    """One decoder layer. Parameter names follow the reference's layer keys
    (``wq``/``bq`` become ``wq.weight``/``wq.bias``, ``ln1`` becomes
    ``ln1.weight``, ...). An MoE layer holds ``router.weight [E, D]``, the
    expert stacks ``e_gate``/``e_up [E, D, F]`` and ``e_down [E, F, D]`` as
    plain parameters in the reference's ``[in, out]`` layout, and the
    optional shared expert ``s_gate``/``s_up``/``s_down`` as linears, in
    place of the dense MLP."""

    def __init__(self, cfg: TransformerConfig, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        d, qd, kvd, ff = (cfg.hidden_dim, cfg.q_dim, cfg.kv_dim,
                          cfg.intermediate_dim)
        self.cfg = cfg
        self.ln1 = _norm(cfg, d, **f)
        self.ln2 = _norm(cfg, d, **f)
        self.wq = nn.Linear(d, qd, bias=cfg.use_attention_bias, **f)
        self.wk = nn.Linear(d, kvd, bias=cfg.use_attention_bias, **f)
        self.wv = nn.Linear(d, kvd, bias=cfg.use_attention_bias, **f)
        self.wo = nn.Linear(qd, d, bias=cfg.use_attn_output_bias, **f)
        if cfg.use_qk_norm:
            self.q_norm = RMSNorm(cfg.head_dim, cfg.rms_norm_eps, **f)
            self.k_norm = RMSNorm(cfg.head_dim, cfg.rms_norm_eps, **f)
        if cfg.moe is not None:
            moe = cfg.moe
            E, fr = moe.num_experts, moe.routed_intermediate_dim or ff
            self.router = nn.Linear(d, E, bias=False, **f)
            self.e_gate = nn.Parameter(torch.empty(E, d, fr, **f))
            self.e_up = nn.Parameter(torch.empty(E, d, fr, **f))
            self.e_down = nn.Parameter(torch.empty(E, fr, d, **f))
            if moe.shared_intermediate_dim:
                fs = moe.shared_intermediate_dim
                self.s_gate = nn.Linear(d, fs, bias=False, **f)
                self.s_up = nn.Linear(d, fs, bias=False, **f)
                self.s_down = nn.Linear(fs, d, bias=False, **f)
        elif cfg.mlp_type == "plain":
            self.w_up = nn.Linear(d, ff, bias=True, **f)
            self.w_down = nn.Linear(ff, d, bias=True, **f)
        else:
            self.w_gate = nn.Linear(d, ff, bias=False, **f)
            self.w_up = nn.Linear(d, ff, bias=False, **f)
            self.w_down = nn.Linear(ff, d, bias=False, **f)
        self.act = _ACTIVATIONS[cfg.hidden_act]

    def forward(
        self,
        h: torch.Tensor,  # [B, T, D]
        cos: torch.Tensor,
        sin: torch.Tensor,
        segment_ids: Optional[torch.Tensor],
        positions: Optional[torch.Tensor],
        cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]],  # [B,S,Hkv,Dh]
        cache_write_index,  # int slot, or [B] per-row slots
        kv_valid: Optional[torch.Tensor],
        attn_impl: str,
        jitter_seed: Optional[int] = None,  # MoE router jitter (training)
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor],
               Optional[Dict[str, torch.Tensor]]]:
        """Returns (h, (k, v), aux): aux is the MoE layer's routing stats,
        None for a dense layer."""
        cfg = self.cfg
        B, T, _ = h.shape
        dh = cfg.head_dim

        # Under tensor parallelism the projections hold this rank's heads
        # only: head counts come from the output widths.
        x = constrain(self.ln1(h), "column_in")
        q = self.wq(x).reshape(B, T, -1, dh)
        k = self.wk(x).reshape(B, T, -1, dh)
        v = self.wv(x).reshape(B, T, -1, dh)
        if cfg.use_qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        if cfg.pos_embedding == "rope":
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)

        if cache_kv is None:
            attn = packed_attention(
                q, k, v, segment_ids, segment_ids,
                q_positions=positions, kv_positions=positions, causal=True,
                sliding_window=cfg.sliding_window, impl=attn_impl,
            )
            new_kv = (k, v)
        else:
            k_cache, v_cache = cache_kv
            if isinstance(cache_write_index, torch.Tensor):
                # Per-row write slots: rows sit at different lengths.
                rows = torch.arange(B, device=h.device)
                if T == 1:
                    k_cache[rows, cache_write_index] = k[:, 0]
                    v_cache[rows, cache_write_index] = v[:, 0]
                else:
                    # Multi-token extension: row b's T new tokens land in
                    # slots cache_write_index[b] .. + T.
                    idx = cache_write_index[:, None] + torch.arange(
                        T, device=h.device)[None, :]
                    k_cache[rows[:, None], idx] = k
                    v_cache[rows[:, None], idx] = v
            else:
                k_cache[:, cache_write_index:cache_write_index + T] = k
                v_cache[:, cache_write_index:cache_write_index + T] = v
            attn = decode_attention(q, k_cache, v_cache, kv_valid)
            new_kv = (k_cache, v_cache)

        h = h + _row_parallel(self.wo, attn.reshape(B, T, -1))
        x = self.ln2(h)
        aux = None
        if cfg.moe is not None:
            mlp, aux = self.moe(x, segment_ids, jitter_seed)
        elif cfg.mlp_type == "plain":
            x = constrain(x, "column_in")
            mlp = _row_parallel(self.w_down, self.act(self.w_up(x)))
        else:
            x = constrain(x, "column_in")
            mlp = _row_parallel(self.w_down,
                                self.act(self.w_gate(x)) * self.w_up(x))
        return h + mlp, new_kv, aux

    def moe(self, x: torch.Tensor, segment_ids: Optional[torch.Tensor],
            jitter_seed: Optional[int] = None):
        """The MoE MLP: pad tokens (segment 0) masked out in packed mode;
        in cache mode (``segment_ids`` None) every row is routed, as the
        reference does (see ROADMAP.md, Queue 3). The jitter's generator
        is made here from its seed, so a remat recompute draws the same
        noise."""
        lp = {}
        for key in _MOE_KEYS:
            mod = getattr(self, key, None)
            if mod is not None:
                lp[key] = mod.weight if isinstance(mod, nn.Linear) else mod
        rng = None
        if jitter_seed is not None:
            rng = torch.Generator(device=x.device).manual_seed(jitter_seed)
        return moemod.moe_mlp(
            x, lp, self.cfg.moe, rng=rng,
            mask=None if segment_ids is None else segment_ids > 0)


def _row_parallel(lin: nn.Linear, a: torch.Tensor) -> torch.Tensor:
    """A row-parallel linear: under tensor parallelism the partial
    products are summed over the tp group and the bias is added once,
    after the sum; otherwise the plain linear."""
    if not tp_active():
        return lin(a)
    y = constrain(F.linear(a, lin.weight), "row_out")
    return y if lin.bias is None else y + lin.bias


# ---------------- the model ----------------

class Transformer(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, dtype=None):
        super().__init__()
        if cfg.pos_embedding not in ("rope", "learned"):
            raise ValueError(f"unknown pos_embedding {cfg.pos_embedding!r}")
        if cfg.pos_embedding == "learned" and not cfg.max_position_embeddings:
            raise ValueError("learned position embeddings need "
                             "max_position_embeddings")
        f = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_dim, **f)
        if cfg.pos_embedding == "learned":
            self.pos_embedding = nn.Embedding(cfg.max_position_embeddings,
                                              cfg.hidden_dim, **f)
        self.layers = nn.ModuleList(Block(cfg, **f) for _ in range(cfg.n_layers))
        self.final_ln = _norm(cfg, cfg.hidden_dim, **f)
        if cfg.is_critic:
            self.value_head = nn.Linear(cfg.hidden_dim, 1, bias=False, **f)
        elif not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_dim, cfg.vocab_size,
                                     bias=False, **f)

    @classmethod
    def from_params(cls, cfg: TransformerConfig,
                    params: Dict[str, torch.Tensor]) -> "Transformer":
        """A model holding ``params`` (a state dict, e.g. from
        :func:`init_params` or ``convert.params_from_jax``) as they are,
        on their device and in their dtype."""
        model = cls(cfg, device="meta")
        model.load_state_dict(params, strict=True, assign=True)
        return model.eval()

    def forward(
        self,
        tokens: torch.Tensor,  # [B, T] int
        positions: torch.Tensor,  # [B, T] per-sequence positions (RoPE)
        segment_ids: Optional[torch.Tensor] = None,  # [B, T], 0 = pad
        kv_cache: Optional[KVCache] = None,  # decode mode, updated in place
        cache_write_index=None,
        kv_valid: Optional[torch.Tensor] = None,
        attn_impl: str = "auto",
        remat=False,  # False | True / "full" | "dots" (packed, no KV only)
        return_kv: bool = True,  # False in training: no per-layer K/V stack
        return_hidden: bool = False,  # skip the head; return final hidden
        return_aux: bool = False,  # also return the MoE aux
        rng: Optional[torch.Generator] = None,  # MoE router jitter (train)
    ):
        """Returns (output, kv), or (output, kv, aux) with ``return_aux``:
        output is logits [B, T, V] (a critic's values [B, T]; the final
        hidden [B, T, D] with ``return_hidden``); kv {"k", "v"} stacks
        per-layer keys/values [n_layers, B, S, Hkv, Dh] (S = T in packed
        mode, the cache length in decode mode), or is None with
        ``return_kv=False``; aux holds the MoE balancing stats
        (``models/moe.py reduce_layer_aux``: ``aux_total`` summed over the
        layers, the rest layer means), {} for a dense model.

        ``rng`` draws the router jitter of an MoE model with
        ``input_jitter_eps > 0`` on the training forward only (packed,
        ``return_kv=False``), as in the reference: one seed per layer is
        drawn from it first.

        Packed mode: ``segment_ids`` given, no cache — block-causal attention.
        Decode mode: ``kv_cache`` given — T new tokens are written at
        ``cache_write_index`` (in place) and attend the ``kv_valid`` slots.
        ``remat`` recomputes each layer in the backward (reference
        ``_maybe_checkpoint:385``); it applies to the training forward only
        (packed mode with ``return_kv=False``)."""
        cfg = self.cfg
        decode = kv_cache is not None
        if remat not in _REMAT_MODES:
            raise ValueError(f"unknown remat mode {remat!r}")
        if remat and (decode or return_kv):
            raise ValueError("remat needs the packed forward with return_kv=False")
        h = self.embedding(tokens)
        if cfg.scale_embeddings:  # gemma normalizer
            h = h * torch.tensor(cfg.hidden_dim ** 0.5, dtype=h.dtype)
        if cfg.pos_embedding == "learned":
            h = h + self.pos_embedding(table_positions(
                cfg, positions, None if decode else segment_ids))
            cos = sin = None
        else:
            cos, sin = rope_tables(positions, cfg.head_dim, cfg.rotary_base)
        seeds = [None] * cfg.n_layers
        if (rng is not None and cfg.moe is not None
                and cfg.moe.input_jitter_eps > 0 and not decode
                and not return_kv):
            seeds = torch.randint(0, 2 ** 62, (cfg.n_layers,), generator=rng,
                                  device=rng.device).tolist()
        ks, vs, auxes = [], [], []
        for i, layer in enumerate(self.layers):
            if remat:
                h, aux = _checkpointed_layer(layer, remat, h, cos, sin,
                                             segment_ids, positions,
                                             attn_impl, seeds[i])
            else:
                cache = ((kv_cache["k"][i], kv_cache["v"][i]) if decode
                         else None)
                h, (k, v), aux = layer(
                    h, cos, sin, None if decode else segment_ids,
                    None if decode else positions, cache, cache_write_index,
                    kv_valid, attn_impl, seeds[i],
                )
                if return_kv and not decode:
                    ks.append(k)
                    vs.append(v)
            if aux is not None:
                auxes.append(aux)
        h = self.final_ln(h)
        if decode:
            kv = kv_cache
        elif return_kv:
            kv = {"k": torch.stack(ks), "v": torch.stack(vs)}
        else:
            kv = None
        out = h if return_hidden else self.apply_head(h)
        if return_aux:
            return out, kv, moemod.reduce_layer_aux(auxes)
        return out, kv

    def apply_head(self, h: torch.Tensor) -> torch.Tensor:
        """Final hidden → logits (tied embeddings or a separate head), or a
        critic's values ``[..., T]`` (reference ``apply_head:519``), in the
        hidden's dtype."""
        head = getattr(self, head_param_name(self.cfg).split(".")[0])
        out = head_logits(h, head.weight)
        return out[..., 0] if self.cfg.is_critic else out


def table_positions(cfg: TransformerConfig, positions: torch.Tensor,
                    segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """The rows of the learned position table that ``positions`` index:
    clamped into the table, after checking that no kept token (segment id
    != 0; every token when ``segment_ids`` is None) sits at or past
    ``max_position_embeddings``. The check reads one integer on the host per
    forward (not per layer); ``ValueError`` names the limit."""
    limit = cfg.max_position_embeddings
    kept = positions if segment_ids is None else \
        positions.masked_fill(segment_ids == 0, 0)
    top = int(kept.max()) if kept.numel() else 0
    if top >= limit:
        raise ValueError(
            f"position {top} of a kept token is past the learned position "
            f"table: max_position_embeddings={limit}")
    return positions.clamp(0, limit - 1)


def head_param_name(cfg: TransformerConfig) -> str:
    """The state-dict name of the head matrix: ``[V, D]`` (the embedding
    when tied), or a critic's ``value_head`` ``[1, D]``."""
    if cfg.is_critic:
        return "value_head.weight"
    return "embedding.weight" if cfg.tie_word_embeddings else "lm_head.weight"


def head_logits(h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """The head's one definition: hidden ``[..., D]`` times the head matrix
    ``[V, D]``. The train engine calls it per column chunk with the
    compute-dtype copy of the matrix."""
    return F.linear(h, head)


# ---------------- remat ----------------

_REMAT_MODES = (False, None, True, "full", "dots")
_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The ``"dots"`` policy (reference ``dots_with_no_batch_dims_saveable``):
    keep the outputs of non-batched matrix products, recompute the rest —
    norms, rope, activations and attention (K1 reruns in the backward)."""
    if op in _SAVED_BY_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed_layer(layer: Block, remat, h, cos, sin, segment_ids,
                        positions, attn_impl, jitter_seed=None):
    """One layer under ``torch.utils.checkpoint``; returns (h, aux). Its
    parameters go in as explicit inputs and are swapped back in for the
    recompute, so the recompute sees the tensors the forward saw even when a
    caller ran the forward through ``torch.func.functional_call`` (the train
    engine's compute-dtype copies of its masters)."""
    names, tensors = zip(*layer.named_parameters())

    def run(h, *tensors):
        out, _, aux = torch.func.functional_call(
            layer, dict(zip(names, tensors)),
            (h, cos, sin, segment_ids, positions, None, None, None, attn_impl,
             jitter_seed),
        )
        return out, aux

    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)
    return checkpoint(run, h, *tensors, use_reentrant=False, **kw)


def init_kv_cache(cfg: TransformerConfig, batch: int, length: int,
                  dtype=torch.float32, device=None) -> KVCache:
    """Zero K/V caches on ``device`` (cuda unless the caller names one)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_params(cfg: TransformerConfig, seed: int, device=None,
                dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Synthetic weights made from ``seed`` on ``device`` (cuda unless the
    caller names one): normal(0, 0.02) matrices and embeddings, zero biases,
    unit norm scales (the reference's init recipe; not its numbers)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params: Dict[str, torch.Tensor] = {}
    for name, mod in Transformer(cfg, device="meta").named_modules():
        prefix = f"{name}." if name else ""
        for pname, p in mod.named_parameters(recurse=False):
            if isinstance(mod, (RMSNorm, LayerNorm)):
                val = (torch.ones if pname == "weight" else torch.zeros)(
                    p.shape, device=device, dtype=dtype)
            elif pname == "bias":
                val = torch.zeros(p.shape, device=device, dtype=dtype)
            else:
                val = (torch.randn(p.shape, generator=gen, device=device,
                                   dtype=torch.float32) * 0.02).to(dtype)
            params[prefix + pname] = val
    return params


def param_count(cfg: TransformerConfig) -> int:
    """Parameters of the model as the reference counts them
    (``param_count:537``: attention and MLP matrices, norms, embedding and
    head; biases are left out)."""
    n, d, f, v = cfg.n_layers, cfg.hidden_dim, cfg.intermediate_dim, cfg.vocab_size
    attn = d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
    if cfg.moe is not None:
        fr = cfg.moe.routed_intermediate_dim or f
        mlp = cfg.moe.num_experts * 3 * d * fr + d * cfg.moe.num_experts
        if cfg.moe.shared_intermediate_dim:
            mlp += 3 * d * cfg.moe.shared_intermediate_dim
    elif cfg.mlp_type == "plain":
        mlp = 2 * d * f
    else:
        mlp = 3 * d * f
    per_layer = attn + mlp + 2 * d
    head = d * v if not (cfg.tie_word_embeddings or cfg.is_critic) else 0
    pos = (
        cfg.max_position_embeddings * d
        if cfg.pos_embedding == "learned"
        else 0
    )
    return v * d + n * per_layer + d + head + pos + (d if cfg.is_critic else 0)


def activated_param_count(cfg: TransformerConfig) -> int:
    """Parameters a token actually touches in one forward (reference
    ``activated_param_count:559``): for MoE, only ``top_k`` of the
    ``num_experts`` routed FFNs; equals :func:`param_count` for dense
    models."""
    if cfg.moe is None:
        return param_count(cfg)
    n, d, f = cfg.n_layers, cfg.hidden_dim, cfg.intermediate_dim
    fr = cfg.moe.routed_intermediate_dim or f
    total_mlp = cfg.moe.num_experts * 3 * d * fr
    active_mlp = cfg.moe.top_k * 3 * d * fr
    return param_count(cfg) - n * (total_mlp - active_mlp)
