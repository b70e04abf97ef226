"""Analytic FLOPs / MFU accounting and experiment metric writers.

The port's copy of ``areal_tpu/base/monitor.py`` (reference
``realhf/base/monitor.py:288-330``, the llama-family FLOPs formulas behind
the master's TFLOP/s logs, and ``realhf/system/flops_counter.py``). One
difference: the peak table is NVIDIA's dense bf16 tensor-core rate per
card, looked up by ``torch.cuda.get_device_name()``, where the reference
has one per TPU generation.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

# Dense (no sparsity) bf16 tensor-core peak FLOP/s per card, from NVIDIA's
# data sheets: "NVIDIA H100 Tensor Core GPU" (H100 SXM 989 TFLOPS, H100 PCIe
# 756 TFLOPS; the sheet lists them with sparsity, twice these), "NVIDIA
# H200 Tensor Core GPU" (as H100 SXM) and "NVIDIA A100 Tensor Core GPU"
# (312 TFLOPS). Matched as lowercase substrings of the device name, the
# more specific first: an SXM H100 reports itself as "NVIDIA H100 80GB
# HBM3".
NVIDIA_PEAK_BF16 = (
    ("h100 pcie", 756e12),
    ("h100", 989e12),
    ("h200", 989e12),
    ("a100", 312e12),
)


def device_peak_flops(device_kind: Optional[str] = None) -> Optional[float]:
    """The card's dense bf16 peak, or None for a device not in the table
    (the CPU among them). Without ``device_kind``, CUDA device 0's name."""
    if device_kind is None:
        import torch

        if not torch.cuda.is_available():
            return None
        device_kind = torch.cuda.get_device_name()
    kind = device_kind.lower()
    return next((v for k, v in NVIDIA_PEAK_BF16 if k in kind), None)


def transformer_flops_per_token(
    n_layers: int,
    hidden_dim: int,
    q_dim: int,
    kv_dim: int,
    intermediate_dim: int,
    vocab_size: int,
    avg_seqlen: float,
    backward: bool = True,
    remat: bool = False,
    moe=None,
    mlp_matmuls: int = 3,
) -> float:
    """Analytic FLOPs per token (the llama formula family): matmul terms
    2·m·n·k plus the attention-score quadratic term; backward ≈ 2× forward,
    or 3× under activation rematerialization (the forward runs again in the
    backward). ``moe`` (anything with MoEConfig's fields) counts the
    activated MLP compute: top_k routed experts, the router and the shared
    expert. ``mlp_matmuls``: 3 for a gated MLP, 2 for GPT-2's plain one
    (the reference counts 3 for every dense model)."""
    d, f = hidden_dim, intermediate_dim
    attn_proj = 2 * d * (q_dim + 2 * kv_dim) + 2 * q_dim * d
    attn_score = 2 * 2 * q_dim * avg_seqlen  # QK^T and PV, causal avg ≈ L/2·2
    if moe is not None:
        fr = moe.routed_intermediate_dim or f
        mlp = moe.top_k * 3 * 2 * d * fr + 2 * d * moe.num_experts
        if moe.shared_intermediate_dim:
            mlp += 3 * 2 * d * moe.shared_intermediate_dim
    else:
        mlp = mlp_matmuls * 2 * d * f
    per_layer = attn_proj + attn_score + mlp
    head = 2 * d * vocab_size
    fwd = n_layers * per_layer + head
    if not backward:
        return fwd
    return fwd * (4.0 if remat else 3.0)


def train_flops_6nt(n_params: float, n_tokens: float) -> float:
    """The classic ``6·N·T`` train-FLOPs estimate (forward 2·N·T, backward
    4·N·T) over the parameter count alone."""
    return 6.0 * float(n_params) * float(n_tokens)


def model_flops_per_token(
    cfg, avg_seqlen: float, backward: bool = True, remat: bool = False
) -> float:
    """FLOPs/token from a TransformerConfig (or anything with its fields)."""
    return transformer_flops_per_token(
        cfg.n_layers, cfg.hidden_dim, cfg.q_dim, cfg.kv_dim,
        cfg.intermediate_dim, 1 if cfg.is_critic else cfg.vocab_size,
        avg_seqlen, backward=backward, remat=remat,
        moe=getattr(cfg, "moe", None),
        mlp_matmuls=2 if getattr(cfg, "mlp_type", "gated") == "plain" else 3,
    )


class FlopsCounter:
    """Per-step FLOPs sum over MFCs (reference flops_counter.py:15)."""

    def __init__(self):
        self.flops = 0.0

    def add_train(self, cfg, n_tokens: float, avg_seqlen: float,
                  remat: bool = False) -> None:
        self.flops += (model_flops_per_token(cfg, avg_seqlen, True,
                                             remat=remat) * n_tokens)

    def add_inf(self, cfg, n_tokens: float, avg_seqlen: float) -> None:
        self.flops += model_flops_per_token(cfg, avg_seqlen, False) * n_tokens

    def pop(self) -> float:
        f, self.flops = self.flops, 0.0
        return f


class MetricWriter:
    """Tensorboard (+ optional wandb) scalar writer for the master loop;
    either is skipped when its package is missing."""

    def __init__(self, tensorboard_path: Optional[str] = None,
                 wandb_mode: str = "disabled", wandb_kwargs=None):
        self._lock = threading.Lock()  # SummaryWriter is not thread-safe
        self._tb = None
        self._wandb = None
        if tensorboard_path:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=tensorboard_path)
            except Exception:  # noqa: BLE001 — tensorboard is optional
                pass
        if wandb_mode != "disabled":
            try:
                import wandb

                wandb.init(mode=wandb_mode, **(wandb_kwargs or {}))
                self._wandb = wandb
            except Exception:  # noqa: BLE001 — wandb is optional
                pass

    def write(self, stats: Dict[str, float], step: int) -> None:
        with self._lock:
            if self._tb is not None:
                for k, v in stats.items():
                    self._tb.add_scalar(k, v, step)
                self._tb.flush()
            if self._wandb is not None:
                self._wandb.log(stats, step=step)

    def close(self) -> None:
        with self._lock:
            if self._tb is not None:
                self._tb.close()
                self._tb = None
