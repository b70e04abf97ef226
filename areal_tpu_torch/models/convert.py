"""Parameter layout conversion between the reference package and the port.

The one place that knows both layouts. The reference keeps parameters as a
pytree flattened (``areal_tpu/models/hf.py:579 flatten_pytree``) to
``/``-joined keys: ``embedding [V, d]``, ``final_ln [d]``, ``lm_head [d, V]``
and per-layer stacks ``layers/<key> [L, ...]`` with matrices as
``[in, out]``. The port's state dict holds ``nn.Linear`` weights as
``[out, in]`` under ``layers.<i>.<key>.weight`` / ``.bias``. A critic's
``value_head [d, 1]`` is the port's ``value_head.weight [1, d]``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from areal_tpu_torch import resolve_device
from areal_tpu_torch.models.config import TransformerConfig

# matrix key -> its bias key in the reference layout (None: no bias)
_LINEAR = {"wq": "bq", "wk": "bk", "wv": "bv", "wo": "bo",
           "w_gate": None, "w_up": "b_up", "w_down": "b_down"}
# norm scale key -> its shift key (LayerNorm only)
_NORMS = {"ln1": "ln1_b", "ln2": "ln2_b", "q_norm": None, "k_norm": None}


def _layer_key_map() -> Dict[str, str]:
    """reference layer key -> port parameter suffix."""
    out = {}
    for w, b in _LINEAR.items():
        out[w] = f"{w}.weight"
        if b:
            out[b] = f"{w}.bias"
    for w, b in _NORMS.items():
        out[w] = f"{w}.weight"
        if b:
            out[b] = f"{w}.bias"
    return out


_TOP = {"embedding": "embedding.weight", "final_ln": "final_ln.weight",
        "final_ln_b": "final_ln.bias", "lm_head": "lm_head.weight",
        "value_head": "value_head.weight"}
_TRANSPOSED = set(_LINEAR) | {"lm_head", "value_head"}


def params_from_jax(flat: Mapping[str, Union[np.ndarray, torch.Tensor]],
                    cfg: TransformerConfig, device=None,
                    dtype=None) -> Dict[str, torch.Tensor]:
    """Reference flat params (numpy arrays, or torch tensors such as a
    native checkpoint's bf16 ones) → the port's ``Transformer`` state dict
    on ``device`` (cuda unless the caller names one; in ``dtype``, or the
    arrays' own dtype)."""
    device = resolve_device(device)
    layer_map = _layer_key_map()
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, t: torch.Tensor, transpose: bool) -> None:
        if transpose:
            t = t.T
        out[name] = t.to(device=device, dtype=dtype).contiguous()

    for key, arr in flat.items():
        if not isinstance(arr, torch.Tensor):
            arr = torch.from_numpy(np.ascontiguousarray(arr))
        if key in _TOP:
            put(_TOP[key], arr, key in _TRANSPOSED)
        elif key.startswith("layers/") and key[7:] in layer_map:
            sub = key[7:]
            if arr.shape[0] != cfg.n_layers:
                raise ValueError(f"{key}: {arr.shape[0]} layers, config "
                                 f"has {cfg.n_layers}")
            for i in range(cfg.n_layers):
                put(f"layers.{i}.{layer_map[sub]}", arr[i], sub in _TRANSPOSED)
        else:
            raise KeyError(f"no port counterpart for parameter {key!r}")
    return out


def params_to_reference(params: Mapping[str, torch.Tensor],
                        cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`params_from_jax`: the port's state dict →
    reference flat params as torch tensors in their own dtype, on their
    device (the native checkpoint layout)."""
    inv_top = {v: k for k, v in _TOP.items()}
    inv_layer = {v: k for k, v in _layer_key_map().items()}
    per_layer: Dict[str, list] = {}
    out: Dict[str, torch.Tensor] = {}

    def arr(t: torch.Tensor, transpose: bool) -> torch.Tensor:
        t = t.detach()
        return t.T if transpose else t

    for name, t in params.items():
        if name in inv_top:
            key = inv_top[name]
            out[key] = arr(t, key in _TRANSPOSED).contiguous()
            continue
        _, idx, suffix = name.split(".", 2)
        key = inv_layer[suffix]
        per_layer.setdefault(key, [None] * cfg.n_layers)[int(idx)] = arr(
            t, key in _TRANSPOSED)
    for key, ts in per_layer.items():
        out[f"layers/{key}"] = torch.stack(ts)
    return out


def params_to_jax(params: Mapping[str, torch.Tensor],
                  cfg: TransformerConfig) -> Dict[str, np.ndarray]:
    """:func:`params_to_reference` as float32 numpy arrays."""
    return {k: v.to("cpu", torch.float32).numpy()
            for k, v in params_to_reference(params, cfg).items()}
