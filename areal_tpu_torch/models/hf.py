"""HF ↔ port weight conversion and sharded safetensors checkpoints.

Counterpart of ``areal_tpu/models/hf.py``: the registry
(``register_hf_family:35``, ``HF_FAMILIES:32``) with the llama-like four
(llama, qwen2 — Qwen2.5 —, qwen3, mistral; ``_llama_like:62``),
``_gemma_config:79``, ``_gpt2_config:90`` and the MoE families
``_mixtral_config:114`` and ``_qwen3_moe_config:129``,
``config_from_hf:145``, the codecs ``_llama_from_sd:213`` /
``_llama_to_sd:263`` (with Gemma's (w − 1) norm storage, the critic's
``score.weight`` and the MoE layers' router and per-expert weights,
``_moe_names:179``) and ``_gpt2_from_sd:295`` /
``_gpt2_to_sd:341`` (fused ``c_attn``, Conv1D ``[in, out]`` weights, the
optional ``transformer.`` prefix), ``params_from_hf_state_dict:372``,
``params_to_hf_state_dict:381``, ``hf_config_dict:404``, the sharded
safetensors IO (``:468-534``), ``save_hf_checkpoint:561`` /
``load_hf_checkpoint:662``, the native weight-sync layout
(``save_native_checkpoint:618``, ``load_native_checkpoint:644``,
``load_checkpoint_auto:655``) and ``load_hf_model:540`` for a directory or
an in-memory model.

The port's state dict already holds HF's ``[out, in]`` linear layout, so the
llama-like mapping is a renaming; GPT-2's Conv1D weights are transposed and
its ``c_attn`` split. The native layout keeps the reference's flattened
names and stacked ``[in, out]`` layers (through ``models/convert.py``), so a
checkpoint published by either package loads in the other. Files go through
``base/safetensors_io.py``; ``config.json`` is read with ``json``, and
``transformers`` is never imported. An MoE layer's HF router ``[E, d]`` is
the port's ``router.weight`` as it is; HF's per-expert ``[F, d]`` / ``[d,
F]`` linears are transposed into the port's ``[E, d, F]`` / ``[E, F, d]``
stacks. A shared expert has no HF mapping (neither family has one, and the
reference maps none), so such a config raises.

Gemma's activation: the reference reads ``hidden_activation`` (absent:
``gelu_pytorch_tanh``) and never ``hidden_act``, where ``transformers``
builds ``GemmaMLP`` from ``hidden_act``. The port reads the reference's key,
because parity is held to the reference, and writes both keys with the
model's own activation.
"""

from __future__ import annotations

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from areal_tpu_torch import resolve_device
from areal_tpu_torch.base import safetensors_io as sio
from areal_tpu_torch.models import convert
from areal_tpu_torch.models.config import MoEConfig, TransformerConfig

# model_type -> builder of a TransformerConfig from a config.json dict with
# the family's defaults filled in (reference HF_FAMILIES:32)
HF_FAMILIES: Dict[str, Callable[[Mapping[str, Any]], TransformerConfig]] = {}


def register_hf_family(name: str):
    def deco(fn):
        HF_FAMILIES[name] = fn
        return fn

    return deco


LLAMA_FAMILIES = ("llama", "qwen2", "qwen3", "mistral")
_HF_ARCH = {
    "llama": "LlamaForCausalLM",
    "qwen2": "Qwen2ForCausalLM",
    "qwen3": "Qwen3ForCausalLM",
    "mistral": "MistralForCausalLM",
    "gemma": "GemmaForCausalLM",
    "gpt2": "GPT2LMHeadModel",
    "mixtral": "MixtralForCausalLM",
    "qwen3_moe": "Qwen3MoeForCausalLM",
}


# What each family's ``transformers`` config class fills in for a key that
# ``config.json`` leaves out (``LlamaConfig``, ``Qwen2Config``,
# ``Qwen3Config``, ``MistralConfig``, ``GemmaConfig``, ``GPT2Config``,
# ``MixtralConfig``, ``Qwen3MoeConfig`` as of transformers 4.57). ``None``
# for ``num_key_value_heads`` / ``head_dim`` means "derived" (rules in
# ``_base_kwargs``; ``Qwen3MoeConfig`` has no ``head_dim`` at all, so a
# config.json without one gets hidden / heads). Llama and Mistral have no
# ``use_sliding_window``: the reference reads its absence as True; the
# reference's Mixtral reads ``sliding_window`` with no flag at all.
_COMMON = dict(num_hidden_layers=32, hidden_size=4096, num_attention_heads=32,
               rope_theta=10000.0, rms_norm_eps=1e-6,
               tie_word_embeddings=False)
_HF_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "llama": dict(_COMMON, vocab_size=32000, intermediate_size=11008,
                  num_key_value_heads=None, head_dim=None,
                  sliding_window=None, use_sliding_window=True),
    "qwen2": dict(_COMMON, vocab_size=151936, intermediate_size=22016,
                  num_key_value_heads=32, head_dim=None,
                  sliding_window=4096, use_sliding_window=False),
    "qwen3": dict(_COMMON, vocab_size=151936, intermediate_size=22016,
                  num_key_value_heads=32, head_dim=128,
                  sliding_window=4096, use_sliding_window=False),
    "mistral": dict(_COMMON, vocab_size=32000, intermediate_size=14336,
                    num_key_value_heads=8, head_dim=None,
                    sliding_window=4096, use_sliding_window=True),
    "gemma": dict(_COMMON, num_hidden_layers=28, hidden_size=3072,
                  num_attention_heads=16, vocab_size=256000,
                  intermediate_size=24576, num_key_value_heads=16,
                  head_dim=256, tie_word_embeddings=True,
                  hidden_activation=None),
    "gpt2": dict(n_layer=12, n_embd=768, n_head=12, n_inner=None,
                 vocab_size=50257, layer_norm_epsilon=1e-5, n_positions=1024),
    "mixtral": dict(_COMMON, vocab_size=32000, intermediate_size=14336,
                    num_key_value_heads=8, head_dim=None, rope_theta=1e6,
                    rms_norm_eps=1e-5, sliding_window=None,
                    num_local_experts=8, num_experts_per_tok=2,
                    router_aux_loss_coef=1e-3),
    "qwen3_moe": dict(_COMMON, num_hidden_layers=24, hidden_size=2048,
                      vocab_size=151936, intermediate_size=6144,
                      num_key_value_heads=4, head_dim=None,
                      moe_intermediate_size=768, num_experts=128,
                      num_experts_per_tok=8, norm_topk_prob=False,
                      router_aux_loss_coef=1e-3),
}


def _base_kwargs(c: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's ``_base_kwargs:43``: a null ``head_dim`` is hidden /
    heads, a null ``num_key_value_heads`` the q-head count."""
    return dict(
        n_layers=c["num_hidden_layers"],
        hidden_dim=c["hidden_size"],
        n_q_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"] or c["num_attention_heads"],
        head_dim=c["head_dim"] or c["hidden_size"] // c["num_attention_heads"],
        intermediate_dim=c["intermediate_size"],
        vocab_size=c["vocab_size"],
        rotary_base=c["rope_theta"],
        rms_norm_eps=c["rms_norm_eps"],
        tie_word_embeddings=c["tie_word_embeddings"],
    )


def _llama_like(c: Mapping[str, Any]) -> TransformerConfig:
    """llama, qwen2, qwen3, mistral (reference ``_llama_like:62``): a window
    counts only with ``use_sliding_window``."""
    mt = c["model_type"]
    return TransformerConfig(
        **_base_kwargs(c),
        sliding_window=c["sliding_window"] if c["use_sliding_window"] else None,
        use_attention_bias=mt == "qwen2",
        use_qk_norm=mt == "qwen3",
        hf_family=mt,
    )


for _fam in LLAMA_FAMILIES:
    register_hf_family(_fam)(_llama_like)


@register_hf_family("gemma")
def _gemma_config(c: Mapping[str, Any]) -> TransformerConfig:
    """Reference ``_gemma_config:79``: scaled embeddings, and the
    activation from ``hidden_activation`` (see the module docstring)."""
    act = c.get("hidden_activation") or "gelu_pytorch_tanh"
    return TransformerConfig(
        **_base_kwargs(c),
        hidden_act="gelu_tanh" if "tanh" in act else "gelu",
        scale_embeddings=True,
        hf_family="gemma",
    )


@register_hf_family("gpt2")
def _gpt2_config(c: Mapping[str, Any]) -> TransformerConfig:
    """Reference ``_gpt2_config:90``: LayerNorm with biases, biased
    attention and MLP, tanh GELU (``gelu_new``), learned positions, always
    tied."""
    d = c["n_embd"]
    return TransformerConfig(
        n_layers=c["n_layer"],
        hidden_dim=d,
        n_q_heads=c["n_head"],
        n_kv_heads=c["n_head"],
        head_dim=d // c["n_head"],
        intermediate_dim=c["n_inner"] or 4 * d,
        vocab_size=c["vocab_size"],
        rms_norm_eps=c["layer_norm_epsilon"],
        tie_word_embeddings=True,
        use_attention_bias=True,
        use_attn_output_bias=True,
        hidden_act="gelu_tanh",
        mlp_type="plain",
        norm_type="layer",
        pos_embedding="learned",
        max_position_embeddings=c["n_positions"],
        hf_family="gpt2",
    )


@register_hf_family("mixtral")
def _mixtral_config(c: Mapping[str, Any]) -> TransformerConfig:
    """Reference ``_mixtral_config:114``: ``num_local_experts`` experts of
    ``intermediate_size``, renormalised top-k gates, and the window
    whenever ``sliding_window`` is set."""
    return TransformerConfig(
        **_base_kwargs(c),
        sliding_window=c["sliding_window"],
        moe=MoEConfig(num_experts=c["num_local_experts"],
                      top_k=c["num_experts_per_tok"],
                      aux_loss_coeff=c["router_aux_loss_coef"],
                      norm_topk_prob=True),
        hf_family="mixtral",
    )


@register_hf_family("qwen3_moe")
def _qwen3_moe_config(c: Mapping[str, Any]) -> TransformerConfig:
    """Reference ``_qwen3_moe_config:129``: qk-norm, ``num_experts`` experts
    of ``moe_intermediate_size``, ``norm_topk_prob`` as the file says (its
    ``transformers`` default is False), no window."""
    return TransformerConfig(
        **_base_kwargs(c),
        use_qk_norm=True,
        moe=MoEConfig(num_experts=c["num_experts"],
                      top_k=c["num_experts_per_tok"],
                      routed_intermediate_dim=c["moe_intermediate_size"],
                      aux_loss_coeff=c["router_aux_loss_coef"],
                      norm_topk_prob=c["norm_topk_prob"]),
        hf_family="qwen3_moe",
    )


def config_from_hf(hf_config: Mapping[str, Any]) -> TransformerConfig:
    """A ``TransformerConfig`` from a ``config.json`` dict (reference
    ``config_from_hf:145``), with the family's ``transformers`` defaults
    for the keys it leaves out."""
    mt = hf_config.get("model_type", "llama")
    if mt not in HF_FAMILIES:
        raise NotImplementedError(f"HF model family {mt!r} is not ported yet")
    return HF_FAMILIES[mt]({**_HF_DEFAULTS[mt], "model_type": mt,
                            **hf_config})


def _check_mapped(cfg: TransformerConfig) -> str:
    """The config's family, if the port maps its weights (not a shared
    expert's: no HF family here has one)."""
    fam = cfg.hf_family or "llama"
    if fam not in HF_FAMILIES:
        raise NotImplementedError(
            f"the HF layout of this config is not ported yet ({fam!r})")
    if cfg.moe is not None and cfg.moe.shared_intermediate_dim:
        raise NotImplementedError(
            "a shared expert has no HF layout (neither Mixtral nor "
            "Qwen3-MoE has one)")
    return fam


# ---------------- the llama-like codec (and Gemma) ----------------

def _llama_mapping(cfg: TransformerConfig) -> List[Tuple[str, str]]:
    """(port parameter suffix, HF name format) of every per-layer weight."""
    p = "model.layers.{i}."
    m = [
        ("ln1.weight", p + "input_layernorm.weight"),
        ("ln2.weight", p + "post_attention_layernorm.weight"),
        ("wq.weight", p + "self_attn.q_proj.weight"),
        ("wk.weight", p + "self_attn.k_proj.weight"),
        ("wv.weight", p + "self_attn.v_proj.weight"),
        ("wo.weight", p + "self_attn.o_proj.weight"),
    ]
    if cfg.moe is not None:
        m.append(("router.weight", _moe_names(cfg)["router"]))
    else:
        m += [("w_gate.weight", p + "mlp.gate_proj.weight"),
              ("w_up.weight", p + "mlp.up_proj.weight"),
              ("w_down.weight", p + "mlp.down_proj.weight")]
    if cfg.use_attention_bias:
        m += [("wq.bias", p + "self_attn.q_proj.bias"),
              ("wk.bias", p + "self_attn.k_proj.bias"),
              ("wv.bias", p + "self_attn.v_proj.bias")]
    if cfg.use_qk_norm:
        m += [("q_norm.weight", p + "self_attn.q_norm.weight"),
              ("k_norm.weight", p + "self_attn.k_norm.weight")]
    return m


def _moe_names(cfg: TransformerConfig) -> Dict[str, str]:
    """HF name formats of an MoE layer's router and expert weights
    (reference ``_moe_names:179``): Mixtral's ``block_sparse_moe`` with
    ``w1`` (gate), ``w3`` (up), ``w2`` (down); every other family Qwen3-MoE's
    ``mlp.gate`` and ``mlp.experts.{e}.*_proj``."""
    p = "model.layers.{i}."
    if cfg.hf_family == "mixtral":
        q = p + "block_sparse_moe."
        return {"router": q + "gate.weight",
                "e_gate": q + "experts.{e}.w1.weight",
                "e_up": q + "experts.{e}.w3.weight",
                "e_down": q + "experts.{e}.w2.weight"}
    q = p + "mlp."
    return {"router": q + "gate.weight",
            "e_gate": q + "experts.{e}.gate_proj.weight",
            "e_up": q + "experts.{e}.up_proj.weight",
            "e_down": q + "experts.{e}.down_proj.weight"}


_EXPERT_KEYS = ("e_gate", "e_up", "e_down")


def _top_mapping(cfg: TransformerConfig) -> List[Tuple[str, str]]:
    m = [("embedding.weight", "model.embed_tokens.weight"),
         ("final_ln.weight", "model.norm.weight")]
    if cfg.is_critic:
        m.append(("value_head.weight", "score.weight"))
    elif not cfg.tie_word_embeddings:
        m.append(("lm_head.weight", "lm_head.weight"))
    return m


# Gemma stores each RMSNorm scale as (w − 1) (reference hf.py:242-252).
_GEMMA_NORMS = ("ln1.weight", "ln2.weight")


def _fold(t: torch.Tensor, by: float, dtype: torch.dtype) -> torch.Tensor:
    """``t + by`` computed in float32, then in ``dtype``."""
    return (t.float() + by).to(dtype)


def _getter(sd: Mapping[str, torch.Tensor], dtype: torch.dtype, device):
    def get(name: str) -> torch.Tensor:
        if name not in sd:
            raise KeyError(f"missing HF weight {name}; have e.g. {list(sd)[:5]}")
        return sd[name].to(device=device, dtype=dtype)
    return get


def _value_head(sd, cfg, get, dtype, device) -> torch.Tensor:
    """A critic's head from ``score.weight``, or zeros without one."""
    if "score.weight" in sd:
        return get("score.weight")
    return torch.zeros(1, cfg.hidden_dim, device=device, dtype=dtype)


def _llama_from_sd(sd: Mapping[str, torch.Tensor], cfg: TransformerConfig,
                   dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """HF state dict → the port's ``Transformer`` state dict. A critic
    without ``score.weight`` gets a zero value head."""
    get = _getter(sd, dtype, device)
    gemma = cfg.scale_embeddings
    out: Dict[str, torch.Tensor] = {}
    for port, hf in _top_mapping(cfg):
        if port == "value_head.weight":
            out[port] = _value_head(sd, cfg, get, dtype, device)
        elif gemma and port == "final_ln.weight":
            out[port] = _fold(get(hf), 1.0, dtype)
        else:
            out[port] = get(hf)
    for i in range(cfg.n_layers):
        for port, hf in _llama_mapping(cfg):
            t = get(hf.format(i=i))
            if gemma and port in _GEMMA_NORMS:
                t = _fold(t, 1.0, dtype)
            out[f"layers.{i}.{port}"] = t
        if cfg.moe is not None:  # HF [out, in] per expert -> [E, in, out]
            names = _moe_names(cfg)
            for key in _EXPERT_KEYS:
                out[f"layers.{i}.{key}"] = torch.stack([
                    get(names[key].format(i=i, e=e)).T
                    for e in range(cfg.moe.num_experts)])
    return out


def _llama_to_sd(params: Mapping[str, torch.Tensor],
                 cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """The port's state dict → HF names, each tensor in its own dtype."""
    gemma = cfg.scale_embeddings

    def put(port: str, t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        if gemma and (port == "final_ln.weight"
                      or port.split(".", 2)[-1] in _GEMMA_NORMS):
            return _fold(t, -1.0, t.dtype)
        return t

    sd = {hf: put(port, params[port]) for port, hf in _top_mapping(cfg)}
    for i in range(cfg.n_layers):
        for port, hf in _llama_mapping(cfg):
            name = f"layers.{i}.{port}"
            sd[hf.format(i=i)] = put(name, params[name])
        if cfg.moe is not None:
            names = _moe_names(cfg)
            for key in _EXPERT_KEYS:
                stack = params[f"layers.{i}.{key}"].detach()
                for e in range(cfg.moe.num_experts):
                    sd[names[key].format(i=i, e=e)] = stack[e].T.contiguous()
    return sd


# ---------------- the GPT-2 codec ----------------

def _gpt2_layer(i: int) -> List[Tuple[str, str]]:
    """(port parameter suffix, HF name) of layer i's unfused weights; the
    Conv1D matrices (``.weight`` of a linear) are ``[in, out]`` in HF."""
    p = f"h.{i}."
    return [("ln1.weight", p + "ln_1.weight"), ("ln1.bias", p + "ln_1.bias"),
            ("ln2.weight", p + "ln_2.weight"), ("ln2.bias", p + "ln_2.bias"),
            ("wo.weight", p + "attn.c_proj.weight"),
            ("wo.bias", p + "attn.c_proj.bias"),
            ("w_up.weight", p + "mlp.c_fc.weight"),
            ("w_up.bias", p + "mlp.c_fc.bias"),
            ("w_down.weight", p + "mlp.c_proj.weight"),
            ("w_down.bias", p + "mlp.c_proj.bias")]


_GPT2_TOP = [("embedding.weight", "wte.weight"),
             ("pos_embedding.weight", "wpe.weight"),
             ("final_ln.weight", "ln_f.weight"),
             ("final_ln.bias", "ln_f.bias")]


def _gpt2_from_sd(sd: Mapping[str, torch.Tensor], cfg: TransformerConfig,
                  dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """GPT-2 (reference ``_gpt2_from_sd:295``): fused ``c_attn`` (q, k, v
    along its output columns), Conv1D ``[in, out]`` weights transposed to
    ``[out, in]``, LayerNorm biases, learned positions, and the
    ``transformer.`` prefix of ``GPT2LMHeadModel`` (absent in a bare
    ``GPT2Model``'s state dict)."""
    pfx = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
    get = _getter(sd, dtype, device)
    d = cfg.hidden_dim
    out = {port: get(pfx + hf) for port, hf in _GPT2_TOP}
    for i in range(cfg.n_layers):
        for port, hf in _gpt2_layer(i):
            t = get(pfx + hf)
            out[f"layers.{i}.{port}"] = t.T.contiguous() if t.dim() == 2 else t
        w = get(pfx + f"h.{i}.attn.c_attn.weight")  # [d, 3d]
        b = get(pfx + f"h.{i}.attn.c_attn.bias")  # [3d]
        for j, name in enumerate(("wq", "wk", "wv")):
            out[f"layers.{i}.{name}.weight"] = \
                w[:, j * d:(j + 1) * d].T.contiguous()
            out[f"layers.{i}.{name}.bias"] = b[j * d:(j + 1) * d].contiguous()
    if cfg.is_critic:
        out["value_head.weight"] = _value_head(sd, cfg, get, dtype, device)
    return out


def _gpt2_to_sd(params: Mapping[str, torch.Tensor],
                cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`_gpt2_from_sd` (reference ``_gpt2_to_sd:341``),
    in ``GPT2LMHeadModel``'s names, each tensor in its own dtype."""
    sd = {"transformer." + hf: params[port].detach() for port, hf in _GPT2_TOP}
    for i in range(cfg.n_layers):
        lp = f"layers.{i}."
        for port, hf in _gpt2_layer(i):
            t = params[lp + port].detach()
            sd["transformer." + hf] = t.T.contiguous() if t.dim() == 2 else t
        sd[f"transformer.h.{i}.attn.c_attn.weight"] = torch.cat(
            [params[lp + f"{n}.weight"].detach().T for n in ("wq", "wk", "wv")],
            dim=1).contiguous()
        sd[f"transformer.h.{i}.attn.c_attn.bias"] = torch.cat(
            [params[lp + f"{n}.bias"].detach() for n in ("wq", "wk", "wv")])
    if cfg.is_critic:
        sd["score.weight"] = params["value_head.weight"].detach()
    return sd


def params_from_hf_state_dict(sd: Mapping[str, torch.Tensor],
                              cfg: TransformerConfig,
                              dtype: torch.dtype = torch.float32,
                              device=None) -> Dict[str, torch.Tensor]:
    """HF causal-LM state dict (torch tensors) → the port's ``Transformer``
    state dict in ``dtype`` on ``device`` (cuda unless the caller names one;
    reference ``params_from_hf_state_dict:372``)."""
    device = resolve_device(device)
    if _check_mapped(cfg) == "gpt2":
        return _gpt2_from_sd(sd, cfg, dtype, device)
    return _llama_from_sd(sd, cfg, dtype, device)


def params_to_hf_state_dict(params: Mapping[str, torch.Tensor],
                            cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """The port's state dict → HF names and layout (reference
    ``params_to_hf_state_dict:381``), each tensor in its own dtype."""
    if _check_mapped(cfg) == "gpt2":
        return _gpt2_to_sd(params, cfg)
    return _llama_to_sd(params, cfg)


def _hf_act(cfg: TransformerConfig) -> str:
    return {"gelu_tanh": "gelu_pytorch_tanh"}.get(cfg.hidden_act,
                                                  cfg.hidden_act)


def hf_config_dict(cfg: TransformerConfig) -> Dict[str, Any]:
    """A transformers-loadable ``config.json`` dict for ``cfg``'s family
    (reference ``hf_config_dict:404``)."""
    fam = _check_mapped(cfg)
    if fam == "gpt2":
        return {
            "model_type": "gpt2",
            "architectures": [_HF_ARCH["gpt2"]],
            "n_layer": cfg.n_layers,
            "n_embd": cfg.hidden_dim,
            "n_head": cfg.n_q_heads,
            "n_positions": cfg.max_position_embeddings,
            "n_ctx": cfg.max_position_embeddings,
            "n_inner": cfg.intermediate_dim,
            "vocab_size": cfg.vocab_size,
            "layer_norm_epsilon": cfg.rms_norm_eps,
            "activation_function": "gelu_new",
            "tie_word_embeddings": True,
        }
    d: Dict[str, Any] = {
        "model_type": fam,
        "architectures": [_HF_ARCH[fam]],
        "num_hidden_layers": cfg.n_layers,
        "hidden_size": cfg.hidden_dim,
        "num_attention_heads": cfg.n_q_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim,
        "intermediate_size": cfg.intermediate_dim,
        "vocab_size": cfg.vocab_size,
        "rope_theta": cfg.rotary_base,
        "rms_norm_eps": cfg.rms_norm_eps,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "max_position_embeddings": cfg.max_position_embeddings or 32768,
        "hidden_act": _hf_act(cfg) if fam == "gemma" else cfg.hidden_act,
        "torch_dtype": "float32",
    }
    if fam == "gemma":
        # the key the reference reads, beside the one transformers reads
        d["hidden_activation"] = _hf_act(cfg)
    if cfg.sliding_window is not None:
        d["sliding_window"] = cfg.sliding_window
    moe = cfg.moe
    if moe is not None:  # reference hf.py:445-459
        d["num_experts_per_tok"] = moe.top_k
        d["router_aux_loss_coef"] = moe.aux_loss_coeff
        if fam == "mixtral":
            d["num_local_experts"] = moe.num_experts
        else:
            d["num_experts"] = moe.num_experts
            d["moe_intermediate_size"] = (moe.routed_intermediate_dim
                                          or cfg.intermediate_dim)
            d["norm_topk_prob"] = moe.norm_topk_prob
            d["decoder_sparse_step"] = 1
            d["mlp_only_layers"] = []
    return d


def _config_from_dict(cd: Dict[str, Any]) -> TransformerConfig:
    cd = dict(cd)
    if cd.get("moe"):
        cd["moe"] = MoEConfig(**cd["moe"])
    return TransformerConfig(**cd)


# ---------------- sharded safetensors IO ----------------

SHARD_BYTES = 4 * 1024**3  # ~4GB per shard, HF convention
_IO_THREADS = 8


def save_hf_state_dict(sd: Mapping[str, torch.Tensor], save_dir: str,
                       shard_bytes: int = SHARD_BYTES) -> int:
    """Write ``sd`` as safetensors: one ``model.safetensors``, or shards of
    at most ``shard_bytes`` with an HF index (one writer thread per shard).
    Returns the bytes written."""
    os.makedirs(save_dir, exist_ok=True)
    shards: List[Dict[str, torch.Tensor]] = [{}]
    sizes = [0]
    for k, v in sd.items():
        nb = v.numel() * v.element_size()
        if sizes[-1] > 0 and sizes[-1] + nb > shard_bytes:
            shards.append({})
            sizes.append(0)
        shards[-1][k] = v
        sizes[-1] += nb
    n = len(shards)
    meta = {"format": "pt"}
    if n == 1:
        return sio.save_file(shards[0], os.path.join(save_dir,
                                                     "model.safetensors"), meta)
    names = [f"model-{i + 1:05d}-of-{n:05d}.safetensors" for i in range(n)]
    with ThreadPoolExecutor(max_workers=min(_IO_THREADS, n)) as ex:
        written = sum(ex.map(
            lambda i: sio.save_file(shards[i], os.path.join(save_dir, names[i]),
                                    meta), range(n)))
    index = {
        "metadata": {"total_size": int(sum(sizes))},
        "weight_map": {k: names[i] for i, shard in enumerate(shards)
                       for k in shard},
    }
    with open(os.path.join(save_dir, "model.safetensors.index.json"), "w") as f:
        json.dump(index, f)
    return written


def load_hf_state_dict(load_dir: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors checkpoint directory (sharded with an
    index, or one ``model.safetensors``), as CPU tensors."""
    index_path = os.path.join(load_dir, "model.safetensors.index.json")
    single = os.path.join(load_dir, "model.safetensors")
    if os.path.exists(index_path):
        with open(index_path) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
        out: Dict[str, torch.Tensor] = {}
        with ThreadPoolExecutor(max_workers=min(_IO_THREADS, len(files))) as ex:
            for d in ex.map(lambda fn: sio.load_file(os.path.join(load_dir, fn)),
                            files):
                out.update(d)
        return out
    if os.path.exists(single):
        return sio.load_file(single)
    raise FileNotFoundError(f"no model.safetensors[.index.json] in {load_dir}")


# ---------------- checkpoints ----------------

def load_hf_model(path, is_critic: bool = False, device=None
                  ) -> Tuple[TransformerConfig, Dict[str, torch.Tensor]]:
    """(config, float32 state dict on ``device``) from an HF model
    directory (``config.json`` + safetensors) or an in-memory model (any
    object with ``.config.to_dict()`` and ``.state_dict()``, such as a
    ``transformers`` model; reference ``load_hf_model:540``). ``device``:
    cuda unless named. The port has no tokenizer loader, so unlike the
    reference no tokenizer comes back."""
    device = resolve_device(device)
    if isinstance(path, (str, os.PathLike)):
        with open(os.path.join(path, "config.json")) as f:
            hf_cfg = json.load(f)
        sd = load_hf_state_dict(path)
    else:  # an in-memory model: its config's dict and its state dict
        hf_cfg, sd = path.config.to_dict(), path.state_dict()
    cfg = dataclasses.replace(config_from_hf(hf_cfg), is_critic=is_critic)
    return cfg, params_from_hf_state_dict(sd, cfg, torch.float32, device)


def save_hf_checkpoint(params: Mapping[str, torch.Tensor],
                       cfg: TransformerConfig, save_dir: str,
                       meta: Optional[dict] = None) -> int:
    """HF layout (sharded safetensors + a genuine ``config.json``, which
    ``transformers.AutoModelForCausalLM`` loads) plus
    ``areal_tpu_config.json`` for :func:`load_hf_checkpoint`. Tensors keep
    their dtype. Returns the bytes of the weight files."""
    os.makedirs(save_dir, exist_ok=True)
    n = save_hf_state_dict(params_to_hf_state_dict(params, cfg), save_dir)
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(hf_config_dict(cfg), f, indent=1)
    with open(os.path.join(save_dir, "areal_tpu_config.json"), "w") as f:
        json.dump({"areal_tpu_config": dataclasses.asdict(cfg),
                   "meta": meta or {}}, f)
    return n


def load_hf_checkpoint(load_dir: str, device=None
                       ) -> Tuple[TransformerConfig, Dict[str, torch.Tensor]]:
    """(config, state dict in the config's dtype on ``device``) from a
    directory :func:`save_hf_checkpoint` (or the reference's) wrote.
    ``device``: cuda unless named."""
    device = resolve_device(device)
    with open(os.path.join(load_dir, "areal_tpu_config.json")) as f:
        cfg = _config_from_dict(json.load(f)["areal_tpu_config"])
    params = params_from_hf_state_dict(load_hf_state_dict(load_dir), cfg,
                                       getattr(torch, cfg.dtype), device)
    return cfg, params


def save_native_checkpoint(params: Mapping[str, torch.Tensor],
                           cfg: TransformerConfig, save_dir: str,
                           meta: Optional[dict] = None) -> int:
    """The weight-sync layout: the reference's flattened names and stacked
    layers, dtype preserved (bf16 stays 2 bytes). ``areal_tpu_native.json``
    is written last: it marks the directory complete. Returns the bytes of
    the weight files."""
    os.makedirs(save_dir, exist_ok=True)
    n = save_hf_state_dict(convert.params_to_reference(params, cfg), save_dir)
    with open(os.path.join(save_dir, "areal_tpu_native.json"), "w") as f:
        json.dump({"areal_tpu_config": dataclasses.asdict(cfg),
                   "meta": meta or {}, "format": "native-pytree-v1"}, f)
    return n


def is_native_checkpoint(load_dir: str) -> bool:
    return os.path.exists(os.path.join(load_dir, "areal_tpu_native.json"))


def load_native_checkpoint(load_dir: str, device=None
                           ) -> Tuple[TransformerConfig, Dict[str, torch.Tensor]]:
    """(config, state dict in the stored dtypes on ``device``)."""
    device = resolve_device(device)
    with open(os.path.join(load_dir, "areal_tpu_native.json")) as f:
        cfg = _config_from_dict(json.load(f)["areal_tpu_config"])
    params = convert.params_from_jax(load_hf_state_dict(load_dir), cfg,
                                     device=device)
    return cfg, params


def load_checkpoint_auto(load_dir: str, device=None
                         ) -> Tuple[TransformerConfig, Dict[str, torch.Tensor]]:
    """Native if the directory is a weight-sync publish, else HF layout."""
    if is_native_checkpoint(load_dir):
        return load_native_checkpoint(load_dir, device)
    return load_hf_checkpoint(load_dir, device)
