"""Transformer configuration.

The port's own copy of ``areal_tpu/models/config.py`` (``MoEConfig``,
``TransformerConfig``, ``tiny_config``) plus the published geometries the
card runs at full width: :func:`qwen2_5_0_5b`, :func:`gpt2_small`,
:func:`gemma_2b`, and the MoE ones :func:`qwen3_30b_a3b` and
:func:`mixtral_8x7b`. Families are expressed as config differences (bias flags,
qk-norm, tying, norm and MLP kinds, positions), not separate classes.
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


def gpt2_small(**kw) -> TransformerConfig:
    """GPT-2 (124M) geometry, as the public ``openai-community/gpt2``
    ``config.json``: 12 layers, hidden 768, 12 heads of 64, inner 3072
    (``n_inner`` null: 4 x 768), vocab 50257, 1024 learned positions,
    LayerNorm eps 1e-5 with biases, a plain MLP with biases, tanh GELU
    (``gelu_new``), tied embeddings; the fields ``models/hf.py``'s
    ``_gpt2_config`` reads from that file."""
    base = dict(
        n_layers=12, hidden_dim=768, n_q_heads=12, n_kv_heads=12,
        head_dim=64, intermediate_dim=3072, vocab_size=50257,
        rms_norm_eps=1e-5, tie_word_embeddings=True, use_attention_bias=True,
        use_attn_output_bias=True, hidden_act="gelu_tanh", mlp_type="plain",
        norm_type="layer", pos_embedding="learned",
        max_position_embeddings=1024, hf_family="gpt2", dtype="bfloat16",
    )
    base.update(kw)
    return TransformerConfig(**base)


def gemma_2b(**kw) -> TransformerConfig:
    """Gemma-2B geometry, as the public ``google/gemma-2b``
    ``config.json``: 18 layers, hidden 2048, 8 query heads over 1 kv head
    of 256, GeGLU 16384 (tanh GELU), vocab 256000, rope base 10000,
    RMSNorm eps 1e-6, tied and scaled embeddings; the fields
    ``models/hf.py``'s ``_gemma_config`` reads from that file."""
    base = dict(
        n_layers=18, hidden_dim=2048, n_q_heads=8, n_kv_heads=1,
        head_dim=256, intermediate_dim=16384, vocab_size=256000,
        rotary_base=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=True,
        hidden_act="gelu_tanh", scale_embeddings=True, hf_family="gemma",
        dtype="bfloat16",
    )
    base.update(kw)
    return TransformerConfig(**base)


def qwen3_30b_a3b(**kw) -> TransformerConfig:
    """Qwen3-30B-A3B geometry, as the public ``Qwen/Qwen3-30B-A3B``
    ``config.json``: 48 layers, hidden 2048, 32 query / 4 kv heads of 128
    with qk-norm, every layer an MoE of 128 experts of 768
    (``moe_intermediate_size``) with top-8 routing and ``norm_topk_prob``,
    ``intermediate_size`` 6144 (no dense layer uses it), vocab 151936, rope
    base 1e6, RMSNorm eps 1e-6, untied embeddings; the router aux
    coefficient 1e-3 (``router_aux_loss_coef``) and the reference's
    capacity factor."""
    base = dict(
        n_layers=48, hidden_dim=2048, n_q_heads=32, n_kv_heads=4,
        head_dim=128, intermediate_dim=6144, vocab_size=151936,
        rotary_base=1000000.0, rms_norm_eps=1e-6, use_qk_norm=True,
        tie_word_embeddings=False, hf_family="qwen3_moe", dtype="bfloat16",
        moe=MoEConfig(num_experts=128, top_k=8, routed_intermediate_dim=768,
                      aux_loss_coeff=1e-3, norm_topk_prob=True),
    )
    base.update(kw)
    return TransformerConfig(**base)


def mixtral_8x7b(**kw) -> TransformerConfig:
    """Mixtral-8x7B geometry, as the public ``mistralai/Mixtral-8x7B-v0.1``
    ``config.json``: 32 layers, hidden 4096, 32 query / 8 kv heads of 128,
    8 experts of 14336 (``intermediate_size``) with top-2 routing, vocab
    32000, rope base 1e6, RMSNorm eps 1e-5, untied, no sliding window;
    ``router_aux_loss_coef`` 0.02."""
    base = dict(
        n_layers=32, hidden_dim=4096, n_q_heads=32, n_kv_heads=8,
        head_dim=128, intermediate_dim=14336, vocab_size=32000,
        rotary_base=1000000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
        hf_family="mixtral", dtype="bfloat16",
        moe=MoEConfig(num_experts=8, top_k=2, aux_loss_coeff=0.02,
                      norm_topk_prob=True),
    )
    base.update(kw)
    return TransformerConfig(**base)
