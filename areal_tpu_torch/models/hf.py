"""HF ↔ port weight conversion and sharded safetensors checkpoints.

Counterpart of ``areal_tpu/models/hf.py`` for the llama-like families
(llama, qwen2 — Qwen2.5 —, qwen3, mistral): ``config_from_hf:145``,
``_llama_mapping:166``, ``_llama_from_sd:213``, ``_llama_to_sd:263`` (with
the critic's ``score.weight``), ``hf_config_dict:404``, the sharded
safetensors IO (``:468-534``), ``save_hf_checkpoint:561`` /
``load_hf_checkpoint:662``, the native weight-sync layout
(``save_native_checkpoint:618``, ``load_native_checkpoint:644``,
``load_checkpoint_auto:655``) and ``load_hf_model:540`` for a directory.

The port's state dict already holds HF's ``[out, in]`` linear layout, so the
HF mapping is a renaming. The native layout keeps the reference's flattened
names and stacked ``[in, out]`` layers (through ``models/convert.py``), so a
checkpoint published by either package loads in the other. Files go through
``base/safetensors_io.py``; ``config.json`` is read with ``json``. GPT-2,
Gemma and MoE mappings, and building from an in-memory ``transformers``
model, wait for a later slice.
"""

from __future__ import annotations

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from areal_tpu_torch import resolve_device
from areal_tpu_torch.base import safetensors_io as sio
from areal_tpu_torch.models import convert
from areal_tpu_torch.models.config import MoEConfig, TransformerConfig

LLAMA_FAMILIES = ("llama", "qwen2", "qwen3", "mistral")
_HF_ARCH = {
    "llama": "LlamaForCausalLM",
    "qwen2": "Qwen2ForCausalLM",
    "qwen3": "Qwen3ForCausalLM",
    "mistral": "MistralForCausalLM",
}


# What each family's ``transformers`` config class fills in for a key that
# ``config.json`` leaves out (``LlamaConfig``, ``Qwen2Config``,
# ``Qwen3Config``, ``MistralConfig`` as of transformers 4.57). ``None`` for
# ``num_key_value_heads`` / ``head_dim`` means "derived" (rules in
# ``config_from_hf``). Llama and Mistral have no ``use_sliding_window``: the
# reference reads its absence as True.
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
}


def config_from_hf(hf_config: Mapping[str, Any]) -> TransformerConfig:
    """A ``TransformerConfig`` from a llama-like ``config.json`` dict
    (reference ``config_from_hf:145`` over ``_base_kwargs:43`` and
    ``_llama_like:62``), with each family's defaults for the keys it leaves
    out, as ``transformers`` resolves them: a missing or null
    ``num_key_value_heads`` that the family leaves open is the q-head
    count, a null ``head_dim`` is hidden / heads, and a window counts only
    with ``use_sliding_window``."""
    mt = hf_config.get("model_type", "llama")
    if mt not in LLAMA_FAMILIES:
        raise NotImplementedError(f"HF model family {mt!r} is not ported yet")
    c = {**_HF_DEFAULTS[mt], **hf_config}
    return TransformerConfig(
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
        sliding_window=c["sliding_window"] if c["use_sliding_window"] else None,
        use_attention_bias=mt == "qwen2",
        use_qk_norm=mt == "qwen3",
        hf_family=mt,
    )


def _check_llama(cfg: TransformerConfig) -> None:
    fam = cfg.hf_family or "llama"
    if (fam not in LLAMA_FAMILIES or cfg.moe is not None
            or cfg.scale_embeddings or cfg.mlp_type != "gated"
            or cfg.norm_type != "rms" or cfg.pos_embedding != "rope"):
        raise NotImplementedError(
            f"only the llama-like HF layouts are ported ({fam!r} config)")


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
        ("w_gate.weight", p + "mlp.gate_proj.weight"),
        ("w_up.weight", p + "mlp.up_proj.weight"),
        ("w_down.weight", p + "mlp.down_proj.weight"),
    ]
    if cfg.use_attention_bias:
        m += [("wq.bias", p + "self_attn.q_proj.bias"),
              ("wk.bias", p + "self_attn.k_proj.bias"),
              ("wv.bias", p + "self_attn.v_proj.bias")]
    if cfg.use_qk_norm:
        m += [("q_norm.weight", p + "self_attn.q_norm.weight"),
              ("k_norm.weight", p + "self_attn.k_norm.weight")]
    return m


def _top_mapping(cfg: TransformerConfig) -> List[Tuple[str, str]]:
    m = [("embedding.weight", "model.embed_tokens.weight"),
         ("final_ln.weight", "model.norm.weight")]
    if cfg.is_critic:
        m.append(("value_head.weight", "score.weight"))
    elif not cfg.tie_word_embeddings:
        m.append(("lm_head.weight", "lm_head.weight"))
    return m


def _llama_from_sd(sd: Mapping[str, torch.Tensor], cfg: TransformerConfig,
                   dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """HF state dict → the port's ``Transformer`` state dict. A critic
    without ``score.weight`` gets a zero value head."""
    _check_llama(cfg)

    def get(name: str) -> torch.Tensor:
        if name not in sd:
            raise KeyError(f"missing HF weight {name}; have e.g. {list(sd)[:5]}")
        return sd[name].to(device=device, dtype=dtype)

    out: Dict[str, torch.Tensor] = {}
    for port, hf in _top_mapping(cfg):
        if port == "value_head.weight" and hf not in sd:
            out[port] = torch.zeros(1, cfg.hidden_dim, device=device,
                                    dtype=dtype)
        else:
            out[port] = get(hf)
    for i in range(cfg.n_layers):
        for port, hf in _llama_mapping(cfg):
            out[f"layers.{i}.{port}"] = get(hf.format(i=i))
    return out


def _llama_to_sd(params: Mapping[str, torch.Tensor],
                 cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """The port's state dict → HF names, each tensor as it is."""
    _check_llama(cfg)
    sd = {hf: params[port].detach() for port, hf in _top_mapping(cfg)}
    for i in range(cfg.n_layers):
        for port, hf in _llama_mapping(cfg):
            sd[hf.format(i=i)] = params[f"layers.{i}.{port}"].detach()
    return sd


def hf_config_dict(cfg: TransformerConfig) -> Dict[str, Any]:
    """A transformers-loadable ``config.json`` dict for ``cfg``'s family."""
    _check_llama(cfg)
    fam = cfg.hf_family or "llama"
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
        "hidden_act": cfg.hidden_act,
        "torch_dtype": "float32",
    }
    if cfg.sliding_window is not None:
        d["sliding_window"] = cfg.sliding_window
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

def load_hf_model(path: str, is_critic: bool = False, device=None
                  ) -> Tuple[TransformerConfig, Dict[str, torch.Tensor]]:
    """(config, float32 state dict on ``device``) from an HF model
    directory (``config.json`` + safetensors). ``device``: cuda unless
    named. The port has no tokenizer loader, so unlike the reference no
    tokenizer comes back."""
    device = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        cfg = dataclasses.replace(config_from_hf(json.load(f)),
                                  is_critic=is_critic)
    params = _llama_from_sd(load_hf_state_dict(path), cfg, torch.float32,
                            device)
    return cfg, params


def save_hf_checkpoint(params: Mapping[str, torch.Tensor],
                       cfg: TransformerConfig, save_dir: str,
                       meta: Optional[dict] = None) -> int:
    """HF layout (sharded safetensors + a genuine ``config.json``, which
    ``transformers.AutoModelForCausalLM`` loads) plus
    ``areal_tpu_config.json`` for :func:`load_hf_checkpoint`. Tensors keep
    their dtype. Returns the bytes of the weight files."""
    os.makedirs(save_dir, exist_ok=True)
    n = save_hf_state_dict(_llama_to_sd(params, cfg), save_dir)
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
    params = _llama_from_sd(load_hf_state_dict(load_dir), cfg,
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
