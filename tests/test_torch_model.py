"""Port transformer (areal_tpu_torch/models) against the reference package.

Weights come from one numpy seed in the reference's flat layout
(``flatten_pytree`` keys, stacked ``[L, ...]``); ``params_from_jax`` loads
them into the port. Logits and K/V of ``forward`` must match the reference's
``transformer.forward`` in float32 at atol 1e-4, in packed mode and in cache
mode (per-row single-token writes, multi-token extension, a scalar slot).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.models import config as jconfig
from areal_tpu.models import hf as jhf
from areal_tpu.models import transformer as jtf
from areal_tpu_torch.models import config as tconfig
from areal_tpu_torch.models.convert import params_from_jax, params_to_jax
from areal_tpu_torch.models.transformer import Transformer, init_params

CONFIGS = {
    "qwen2": dict(use_attention_bias=True, tie_word_embeddings=True),
    "qwen3": dict(use_qk_norm=True, rotary_base=1e6),
    "layer_plain": dict(norm_type="layer", mlp_type="plain",
                        hidden_act="gelu_tanh", use_attn_output_bias=True),
}
NORM_SCALES = {"ln1", "ln2", "final_ln", "q_norm", "k_norm"}


def make_model(name, seed=0, **over):
    """(reference cfg, port cfg, flat numpy params, port model)."""
    kw = dict(vocab_size=97, n_layers=2, hidden_dim=32, n_q_heads=4,
              n_kv_heads=2, **CONFIGS[name], **over)
    jcfg = jconfig.tiny_config(**kw)
    tcfg = tconfig.tiny_config(**kw)
    # Shapes from the reference init; values (incl. biases and norm scales,
    # which the init leaves at 0/1) from one numpy seed.
    shapes = jhf.flatten_pytree(jax.eval_shape(
        lambda: jtf.init_params(jcfg, jax.random.PRNGKey(0))))
    rng = np.random.RandomState(seed)
    flat = {}
    for key, a in shapes.items():
        is_scale = key.split("/")[-1] in NORM_SCALES
        flat[key] = ((1.0 if is_scale else 0.0)
                     + 0.1 * rng.randn(*a.shape)).astype(np.float32)
    model = Transformer.from_params(tcfg, params_from_jax(flat, tcfg,
                                                     device="cpu"))
    return jcfg, tcfg, flat, model


def _jparams(flat):
    return jax_tree(jhf.unflatten_pytree(flat))


def jax_tree(tree):
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def test_params_round_trip():
    _, tcfg, flat, model = make_model("qwen2")
    back = params_to_jax(model.state_dict(), tcfg)
    assert set(back) == set(flat)
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key], err_msg=key)
    # the port's own init produces exactly the state dict the model holds
    own = init_params(tcfg, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_packed_forward_matches_reference(name):
    jcfg, _, flat, model = make_model(name)
    rng = np.random.RandomState(1)
    B, T = 2, 24
    tokens = rng.randint(0, 97, (B, T)).astype(np.int32)
    seg = np.zeros((B, T), np.int32)
    pos = np.zeros((B, T), np.int32)
    for b, lens in enumerate([(10, 9), (20,)]):  # two docs + pad; one doc + pad
        col = 0
        for i, n in enumerate(lens):
            seg[b, col:col + n] = i + 1
            pos[b, col:col + n] = np.arange(n)
            col += n
    jl, jkv = jtf.forward(_jparams(flat), jcfg, jnp.asarray(tokens),
                          jnp.asarray(pos), segment_ids=jnp.asarray(seg))
    with torch.no_grad():
        tl, tkv = model(torch.from_numpy(tokens), torch.from_numpy(pos),
                        segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(tkv[key].numpy(), np.asarray(jkv[key]),
                                   atol=1e-4)


@pytest.mark.parametrize("mode", ["rows_t1", "rows_extend", "scalar"])
def test_cache_forward_matches_reference(mode):
    jcfg, tcfg, flat, model = make_model("qwen2", seed=2)
    rng = np.random.RandomState(3)
    B, S = 3, 16
    shape = (tcfg.n_layers, B, S, tcfg.n_kv_heads, tcfg.head_dim)
    kc = rng.randn(*shape).astype(np.float32)
    vc = rng.randn(*shape).astype(np.float32)
    cur = np.array([2, 7, 11])
    T = {"rows_t1": 1, "rows_extend": 4, "scalar": 2}[mode]
    tokens = rng.randint(0, 97, (B, T)).astype(np.int32)
    if mode == "scalar":
        write = 5
        pos = np.broadcast_to(write + np.arange(T), (B, T)).astype(np.int32)
        valid = np.arange(S)[None, :] < write + T
        jwrite, twrite = write, write
    else:
        pos = (cur[:, None] + np.arange(T)[None, :]).astype(np.int32)
        valid = (np.arange(S)[None, None, :] <= pos[:, :, None])
        if T == 1:
            valid = valid[:, 0]
        jwrite, twrite = jnp.asarray(cur), torch.from_numpy(cur)
    jl, jkv = jtf.forward(
        _jparams(flat), jcfg, jnp.asarray(tokens), jnp.asarray(pos),
        kv_cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        cache_write_index=jwrite, kv_valid=jnp.asarray(valid))
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    with torch.no_grad():
        tl, tkv = model(torch.from_numpy(tokens), torch.from_numpy(pos),
                        kv_cache=cache, cache_write_index=twrite,
                        kv_valid=torch.from_numpy(valid))
    assert tkv["k"] is cache["k"]  # written in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(tkv[key].numpy(), np.asarray(jkv[key]),
                                   atol=1e-4)


def test_qwen2_5_0_5b_geometry():
    cfg = tconfig.qwen2_5_0_5b()
    assert (cfg.n_layers, cfg.hidden_dim, cfg.n_q_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.intermediate_dim, cfg.vocab_size) == (
        24, 896, 14, 2, 64, 4864, 151936)
    assert cfg.rotary_base == 1e6 and cfg.rms_norm_eps == 1e-6
    assert cfg.use_attention_bias and cfg.tie_word_embeddings
    meta = Transformer(cfg, device="meta")
    n = sum(p.numel() for p in meta.parameters())
    assert n == jtf.param_count(jconfig.TransformerConfig(
        **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})) + 24 * (
        cfg.q_dim + 2 * cfg.kv_dim)  # the reference count leaves out biases


def test_unported_features_raise():
    """MoE and learned positions still raise (the critic head is ported:
    tests/test_torch_critic.py); a parameter with no port counterpart is a
    KeyError."""
    for kw in (dict(moe=dict(num_experts=4, top_k=2)),
               dict(pos_embedding="learned", max_position_embeddings=64)):
        with pytest.raises(NotImplementedError):
            Transformer(tconfig.tiny_config(**kw), device="meta")
    with pytest.raises(KeyError):
        params_from_jax({"layers/router": np.zeros((2, 32, 4), np.float32)},
                        tconfig.tiny_config(), device="cpu")
