"""Transformer configuration.

The port's own copy of ``areal_tpu/models/config.py`` (``MoEConfig``,
``TransformerConfig``, ``tiny_config``) plus :func:`qwen2_5_0_5b`, the
geometry the serving slice runs at full width. Families are expressed as
config differences (bias flags, qk-norm, tying), not separate classes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mirrors ReaLMoEConfig (reference model_api.py:294)."""

    num_experts: int = 8
    top_k: int = 2
    # Expert-buffer size multiplier: capacity per expert is
    # ceil(top_k * n_tokens * capacity_factor / num_experts); overflow
    # tokens are dropped (contribute nothing), mirroring the reference's
    # token_dispatcher capacity drop.
    capacity_factor: float = 2.0
    routed_intermediate_dim: Optional[int] = None
    # qwen-moe style always-on shared expert; None = no shared expert
    shared_intermediate_dim: Optional[int] = None
    aux_loss_coeff: float = 1e-3
    z_loss_coeff: float = 0.0
    input_jitter_eps: float = 0.0
    norm_topk_prob: bool = True


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    n_layers: int
    hidden_dim: int
    n_q_heads: int
    n_kv_heads: int
    head_dim: int
    intermediate_dim: int
    vocab_size: int
    rotary_base: float = 10000.0
    rms_norm_eps: float = 1e-6
    use_attention_bias: bool = False  # qwen2: True on qkv
    use_attn_output_bias: bool = False
    use_qk_norm: bool = False  # qwen3
    tie_word_embeddings: bool = False
    is_critic: bool = False  # scalar head instead of lm head
    moe: Optional[MoEConfig] = None
    # sliding window attention (mistral/gemma2); None = full attention
    sliding_window: Optional[int] = None
    # MLP activation: "silu" (llama family), "gelu_tanh" (gemma/gpt2),
    # "gelu" (exact)
    hidden_act: str = "silu"
    # "gated" = SwiGLU/GeGLU (w_gate/w_up/w_down); "plain" = act(x@w_up)@w_down
    # with biases (gpt2)
    mlp_type: str = "gated"
    norm_type: str = "rms"  # "rms" | "layer" (gpt2 LayerNorm with bias)
    # "rope" | "learned" (gpt2 absolute position table)
    pos_embedding: str = "rope"
    max_position_embeddings: Optional[int] = None  # learned-pos table size
    scale_embeddings: bool = False  # gemma: hidden *= sqrt(hidden_dim)
    # HF family tag driving weight-name mapping + config.json emission
    # (models/hf.py); None for fabricated test configs.
    hf_family: Optional[str] = None
    dtype: str = "float32"  # param dtype; compute dtype chosen at call site

    @property
    def q_dim(self) -> int:
        return self.n_q_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def group_size(self) -> int:
        assert self.n_q_heads % self.n_kv_heads == 0
        return self.n_q_heads // self.n_kv_heads


def tiny_config(
    vocab_size: int = 128,
    n_layers: int = 2,
    hidden_dim: int = 32,
    n_q_heads: int = 4,
    n_kv_heads: int = 2,
    is_critic: bool = False,
    **kw,
) -> TransformerConfig:
    """Small fabricated config for tests (reference testing.py:37-43).

    A ``moe`` kwarg may be a plain dict (the YAML/CLI ``actor.tiny.moe``
    form) — it is coerced to :class:`MoEConfig` here so every downstream
    consumer sees the dataclass.
    """
    if isinstance(kw.get("moe"), dict):
        kw["moe"] = MoEConfig(**kw["moe"])
    return TransformerConfig(
        n_layers=n_layers,
        hidden_dim=hidden_dim,
        n_q_heads=n_q_heads,
        n_kv_heads=n_kv_heads,
        head_dim=hidden_dim // n_q_heads,
        intermediate_dim=hidden_dim * 2,
        vocab_size=vocab_size,
        is_critic=is_critic,
        **kw,
    )


def qwen2_5_0_5b(**kw) -> TransformerConfig:
    """Qwen2.5-0.5B geometry, as the public ``Qwen/Qwen2.5-0.5B``
    ``config.json``: 24 layers, hidden 896, 14 query / 2 kv heads of 64,
    SwiGLU 4864, vocab 151936, rope base 1e6, RMSNorm eps 1e-6, QKV bias,
    tied embeddings."""
    base = dict(
        n_layers=24, hidden_dim=896, n_q_heads=14, n_kv_heads=2,
        head_dim=64, intermediate_dim=4864, vocab_size=151936,
        rotary_base=1000000.0, rms_norm_eps=1e-6, use_attention_bias=True,
        tie_word_embeddings=True, hf_family="qwen2", dtype="bfloat16",
    )
    base.update(kw)
    return TransformerConfig(**base)
