"""MoE models in the port (areal_tpu_torch/models/transformer.py, generate.py,
hf.py, backend/torch_train.py) against the reference package and
``transformers``, in float32 on the CPU at ``tiny_config`` size.

The same numpy-seeded weights (``params_from_jax``) go through both
packages: the packed forward with its aux for each dispatch and the
cache-mode forward at 1e-4 on logits and K/V and 1e-5 on the aux; greedy
generation token for token; one train step of each engine (SFT through
``train_batch``, PPO through ``train_uniform``) at the tolerances of
tests/test_torch_train.py (1e-5 relative on stats, masters at atol 2e-6 /
rtol 2e-5). Tiny Mixtral and Qwen3-MoE models of ``transformers`` load
through the port's codecs with a capacity factor of E / top_k (no drops:
HF's layers are dropless) and give their logits at atol 2e-4 / rtol 2e-3.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from areal_tpu.algorithms import ppo as jppo
from areal_tpu.algorithms import sft as jsft
from areal_tpu.api.data import MicroBatchSpec as JSpec
from areal_tpu.api.model import GenerationHyperparameters as JGen
from areal_tpu.models import config as jconfig
from areal_tpu.models import generate as jgen
from areal_tpu.models import hf as jhf
from areal_tpu.models import transformer as jtf
from areal_tpu_torch.algorithms import ppo as tppo
from areal_tpu_torch.algorithms import sft as tsft
from areal_tpu_torch.api.data import MicroBatchSpec as TSpec
from areal_tpu_torch.api.model import GenerationHyperparameters as TGen
from areal_tpu_torch.backend import torch_train as ttrain
from areal_tpu_torch.models import config as tconfig
from areal_tpu_torch.models import generate as tgen
from areal_tpu_torch.models import hf as thf
from areal_tpu_torch.models.convert import params_from_jax, params_to_jax
from areal_tpu_torch.models.transformer import (
    Transformer,
    activated_param_count,
    param_count,
)
from test_torch_model import _jparams, make_model
from test_torch_train import (
    SPEC,
    _assert_masters_match,
    _assert_stats_match,
    _thp,
    _tsample,
)
from test_torch_trainer import model_pair
from test_uniform_prep import _make_batch

# the trainer's tiny MoE config (vocab 128, test_torch_trainer.CFG): 4
# experts of top-2 at a capacity factor that drops, a shared expert
TRAIN_MOE = dict(moe=dict(num_experts=4, top_k=2, capacity_factor=1.0,
                          shared_intermediate_dim=16, aux_loss_coeff=1e-2,
                          z_loss_coeff=1e-3))
MOE_STATS = {"moe_aux_total", "moe_load_balance_loss", "moe_z_loss",
             "moe_dropped_frac", "moe_expert_load_ratio"}


@pytest.fixture(scope="module")
def moe_model():
    return make_model("moe", seed=11)


def _packed():
    rng = np.random.RandomState(12)
    B, T = 2, 24
    tokens = rng.randint(0, 97, (B, T)).astype(np.int32)
    seg = np.zeros((B, T), np.int32)
    pos = np.zeros((B, T), np.int32)
    for b, lens in enumerate([(10, 9), (20,)]):  # documents, then pad
        col = 0
        for i, n in enumerate(lens):
            seg[b, col:col + n] = i + 1
            pos[b, col:col + n] = np.arange(n)
            col += n
    return tokens, pos, seg


@pytest.mark.parametrize("dispatch", ["grouped", "einsum"])
def test_packed_forward_with_aux_matches_reference(moe_model, dispatch,
                                                   monkeypatch):
    """Logits, K/V and the six aux values (``aux_total`` summed over the
    layers, the rest layer means) with AREAL_MOE_DISPATCH set for both
    packages."""
    monkeypatch.setenv("AREAL_MOE_DISPATCH", dispatch)
    jcfg, _, flat, model = moe_model
    tokens, pos, seg = _packed()
    jl, jkv, jaux = jtf.forward(_jparams(flat), jcfg, jnp.asarray(tokens),
                                jnp.asarray(pos), segment_ids=jnp.asarray(seg),
                                return_aux=True)
    with torch.no_grad():
        tl, tkv, taux = model(torch.from_numpy(tokens), torch.from_numpy(pos),
                              segment_ids=torch.from_numpy(seg),
                              return_aux=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(tkv[key].numpy(), np.asarray(jkv[key]),
                                   atol=1e-4)
    assert set(taux) == set(jaux) and len(taux) == 6
    for key, v in jaux.items():
        np.testing.assert_allclose(taux[key].numpy(), np.asarray(v),
                                   atol=1e-5, err_msg=key)
    assert taux["expert_load"].shape == (4,)
    assert float(taux["dropped_frac"]) > 0  # capacity factor 1.0 drops here
    # a dense model's aux is empty
    _, _, _, dense = make_model("qwen2")
    with torch.no_grad():
        assert dense(torch.from_numpy(tokens), torch.from_numpy(pos),
                     segment_ids=torch.from_numpy(seg),
                     return_aux=True)[2] == {}


@pytest.mark.parametrize("mode", ["rows_t1", "rows_extend", "scalar"])
def test_cache_forward_matches_reference(moe_model, mode):
    """Cache mode (decode and suffix extension): every row routed, pads
    included, as in the reference (mask None)."""
    jcfg, tcfg, flat, model = moe_model
    rng = np.random.RandomState(13)
    B, S = 3, 16
    shape = (tcfg.n_layers, B, S, tcfg.n_kv_heads, tcfg.head_dim)
    kc = rng.randn(*shape).astype(np.float32)
    vc = rng.randn(*shape).astype(np.float32)
    cur = np.array([2, 7, 11])
    T = {"rows_t1": 1, "rows_extend": 4, "scalar": 2}[mode]
    tokens = rng.randint(0, 97, (B, T)).astype(np.int32)
    if mode == "scalar":
        pos = np.broadcast_to(5 + np.arange(T), (B, T)).astype(np.int32)
        valid = np.arange(S)[None, :] < 5 + T
        jwrite = twrite = 5
    else:
        pos = (cur[:, None] + np.arange(T)[None, :]).astype(np.int32)
        valid = np.arange(S)[None, None, :] <= pos[:, :, None]
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
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(tkv[key].numpy(), np.asarray(jkv[key]),
                                   atol=1e-4)


def test_generate_batch_greedy_matches_reference(moe_model):
    """Prefill and KV-cache decode through the MoE blocks: the greedy
    tokens equal the reference's, their logprobs within 1e-4."""
    jcfg, _, flat, model = moe_model
    rng = np.random.RandomState(14)
    prompts = [rng.randint(2, 97, n).tolist() for n in (5, 11, 3)]
    padded, plens = tgen.pad_prompts(prompts, 0, bucket=16)
    N = 8
    ref = jgen.generate_batch(
        _jparams(flat), jcfg, jnp.asarray(padded), jnp.asarray(plens),
        jax.random.PRNGKey(0), JGen(greedy=True), max_new_tokens=N,
        eos_token_id=97, pad_token_id=0)
    out = tgen.generate_batch(model, torch.from_numpy(padded),
                              torch.from_numpy(plens), None, TGen(greedy=True),
                              N, eos_token_id=97, pad_token_id=0)
    for key in ("output_ids", "output_lens"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))
    for key in ("output_logprobs", "prompt_logprobs"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-4, err_msg=key)


def _loss_and_grads(model, remat, seed=None, eps=0.0):
    """Loss (logits' mean square + aux_total), aux and grads of the port's
    training forward; with ``seed`` a jitter generator seeded by it."""
    params = {n: p.detach().clone().requires_grad_()
              for n, p in model.state_dict().items()}
    cfg = model.cfg
    if eps:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, input_jitter_eps=eps))
    net = Transformer(cfg, device="meta")
    tokens, pos, seg = _packed()
    rng = None if seed is None else torch.Generator().manual_seed(seed)
    out, _, aux = torch.func.functional_call(
        net, params, (torch.from_numpy(tokens), torch.from_numpy(pos)),
        dict(segment_ids=torch.from_numpy(seg), remat=remat, return_kv=False,
             return_aux=True, rng=rng))
    loss = (out ** 2).mean() + aux["aux_total"]
    loss.backward()
    return float(loss), aux, {n: p.grad for n, p in params.items()}


@pytest.mark.parametrize("eps", [0.0, 0.2])
def test_remat_recomputes_the_same_routing(moe_model, eps):
    """Under "full" and "dots" remat the layer's routing (the segment
    sizes read on the host, the jitter drawn from its per-layer seed) is
    recomputed as the forward ran it: loss, aux and every grad equal the
    run without remat."""
    model = moe_model[3]
    seed = 3 if eps else None
    base = _loss_and_grads(model, False, seed, eps)
    for remat in ("full", "dots"):
        got = _loss_and_grads(model, remat, seed, eps)
        assert got[0] == pytest.approx(base[0], rel=1e-6)
        for key in base[1]:
            torch.testing.assert_close(got[1][key], base[1][key])
        for name, g in base[2].items():
            torch.testing.assert_close(got[2][name], g, atol=1e-6, rtol=1e-5,
                                       msg=name)
    if eps:  # another seed jitters the router otherwise
        other = _loss_and_grads(model, False, 4, eps)
        assert other[0] != base[0]


@pytest.mark.parametrize("scope", ["global", "mb"])
def test_sft_train_batch_matches_reference(scope):
    """One SFT step (``train_batch``): the loss includes aux_total scaled
    per the normalize scope, the moe_* stats (per-micro-batch means) and
    the updated masters equal the reference's."""
    jm, tm = model_pair(remat="dots", logprob_chunk=8, cfg_kw=TRAIN_MOE)
    batch = _make_batch(seed=22)
    want = jsft.SFTInterface(scope).train_step(jm, batch, JSpec(**SPEC))
    got = tsft.SFTInterface(scope).train_step(tm, _tsample(batch),
                                              TSpec(**SPEC))
    assert set(got) == set(want) and MOE_STATS <= set(got)
    assert "moe_expert_load" not in got  # observed as a distribution
    _assert_stats_match(got, want)
    assert got["grad_norm"] > 0
    _assert_masters_match(jm.module, tm.module, tm.module.cfg)


def test_ppo_train_uniform_matches_reference(monkeypatch):
    """The PPO actor's uniform path (``train_uniform``): its moe_* stats
    pass through the actor's result, equal to the reference's; the gauges
    and the expert-load distribution are published."""
    jm, tm = model_pair(cfg_kw=TRAIN_MOE)
    hp = jppo.PPOHyperparameters(ppo_n_minibatches=2, kl_ctl=0.1,
                                 adv_norm=True, disable_value=True)
    batch = _make_batch(seed=23)
    gauges, observed = {}, []
    monkeypatch.setattr(ttrain.telemetry, "set_gauge",
                        lambda name, v: gauges.__setitem__(name, v))
    monkeypatch.setattr(ttrain.telemetry, "observe",
                        lambda name, v, buckets=None: observed.append(
                            (name, v)))
    want = jppo.PPOActorInterface(hp).train_step(jm, batch, JSpec(**SPEC))
    got = tppo.PPOActorInterface(_thp(hp)).train_step(tm, _tsample(batch),
                                                      TSpec(**SPEC))
    assert MOE_STATS <= set(got) and MOE_STATS <= set(want)
    _assert_stats_match(got, want, keys=sorted(MOE_STATS) + ["actor_loss"])
    _assert_masters_match(jm.module, tm.module, tm.module.cfg)
    assert gauges["train/moe_ep_engaged"] == 0.0
    assert gauges["train/moe_dropped_frac"] >= 0.0
    assert gauges["train/moe_expert_load_ratio"] >= 1.0
    shares = [v for name, v in observed if name == "train/moe_expert_load_dist"]
    assert len(shares) == 4 * 2  # E shares per optimizer step
    assert sum(shares) == pytest.approx(2.0, abs=1e-5)


def test_train_step_with_router_jitter():
    """input_jitter_eps > 0 trains in both packages (finite loss, the
    router moves); the port's draws repeat for the same optimizer step and
    micro-batch, so two engines on the same weights stay equal, and the
    jitter changes the step against a model without it."""
    kw = dict(moe=dict(TRAIN_MOE["moe"], input_jitter_eps=0.1))
    batch = _make_batch(seed=24)
    jm, tm = model_pair(cfg_kw=kw)
    _, tm2 = model_pair(cfg_kw=kw)
    _, tm0 = model_pair(cfg_kw=TRAIN_MOE)
    want = jsft.SFTInterface().train_step(jm, batch, JSpec(**SPEC))
    assert np.isfinite(want["loss"])
    before = tm.module.params["layers.0.router.weight"].detach().clone()
    stats = [tsft.SFTInterface().train_step(m, _tsample(batch), TSpec(**SPEC))
             for m in (tm, tm2, tm0)]
    assert np.isfinite(stats[0]["loss"]) and stats[0] == stats[1]
    assert stats[0]["loss"] != stats[2]["loss"]
    assert not torch.equal(before, tm.module.params["layers.0.router.weight"])
    for name, p in tm.module.params.items():
        assert torch.equal(p, tm2.module.params[name]), name


# ---------------- HF layouts: Mixtral and Qwen3-MoE ----------------

VOCAB = 97
HF_CONFIGS = {
    "mixtral": lambda **kw: transformers.MixtralConfig(
        vocab_size=VOCAB, hidden_size=32, intermediate_size=48,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2, rope_theta=1e6,
        max_position_embeddings=64, **kw),
    # head_dim 16 != hidden / heads (8), as Qwen3-30B-A3B's 128 != 2048 / 32
    "qwen3_moe": lambda **kw: transformers.Qwen3MoeConfig(
        vocab_size=VOCAB, hidden_size=32, intermediate_size=64,
        moe_intermediate_size=24, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=16, num_experts=8,
        num_experts_per_tok=2, norm_topk_prob=True,
        max_position_embeddings=64, **kw),
}


def hf_moe_model(family, seed=0, scale=0.1):
    """A tiny ``transformers`` MoE model whose every parameter is its init
    plus seeded noise."""
    torch.manual_seed(seed)
    model = transformers.AutoModelForCausalLM.from_config(
        HF_CONFIGS[family]()).eval()
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for _, p in sorted(model.named_parameters()):
            p.add_(torch.from_numpy(
                scale * rng.randn(*p.shape).astype(np.float32)))
    return model


def _dropless(cfg):
    """The config with capacity E / top_k: every expert can take every
    token, so nothing drops (HF's MoE layers are dropless)."""
    moe = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.top_k))


@pytest.mark.parametrize("family", ["mixtral", "qwen3_moe"])
def test_hf_moe_codecs_match_transformers(family, tmp_path):
    """A ``transformers`` model through ``params_from_hf_state_dict``: its
    logits at atol 2e-4 / rtol 2e-3, nothing dropped; the port's
    state-dict round trip is exact; the reference reads the same config
    and weights; the port's HF directory loads in ``transformers`` with
    the same logits and its config.json is the reference's."""
    model = hf_moe_model(family)
    cfg = _dropless(thf.config_from_hf(model.config.to_dict()))
    jcfg, jparams, _ = jhf.load_hf_model(model)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(dataclasses.replace(
        jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=4.0 if
                                      family == "qwen3_moe" else 2.0)))
    sd = model.state_dict()
    params = thf.params_from_hf_state_dict(sd, cfg, device="cpu")
    back = thf.params_to_hf_state_dict(params, cfg)
    assert set(back) == set(sd)
    for name, t in sd.items():
        assert torch.equal(back[name], t), name
    want = params_to_jax(params, cfg)
    got = jhf.flatten_pytree(jparams, as_numpy=True)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    ids = np.random.RandomState(1).randint(0, VOCAB, (2, 20))
    pos = torch.arange(20).expand(2, 20)
    with torch.no_grad():
        port, _, aux = Transformer.from_params(cfg, params)(
            torch.from_numpy(ids), pos,
            segment_ids=torch.ones(2, 20, dtype=torch.int32),
            return_aux=True)
        theirs = model(input_ids=torch.from_numpy(ids)).logits.numpy()
    assert float(aux["dropped_frac"]) == 0.0
    np.testing.assert_allclose(port.numpy(), theirs, atol=2e-4, rtol=2e-3)
    out = str(tmp_path / "port")
    thf.save_hf_checkpoint(params, cfg, out)
    with open(f"{out}/config.json") as f:
        assert json.load(f) == jhf.hf_config_dict(jcfg)
    again = transformers.AutoModelForCausalLM.from_pretrained(out).eval()
    with torch.no_grad():
        np.testing.assert_allclose(
            again(input_ids=torch.from_numpy(ids)).logits.numpy(), theirs,
            atol=1e-6)
    lcfg, lparams = thf.load_hf_model(out, device="cpu")
    assert lcfg == dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=2.0))
    for name, t in params.items():
        assert torch.equal(lparams[name], t), name


_MOE_FULL = {
    "mixtral": dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
                    num_key_value_heads=2, intermediate_size=48,
                    vocab_size=97, rope_theta=5e5, rms_norm_eps=1e-6,
                    tie_word_embeddings=True, sliding_window=24,
                    num_local_experts=4, num_experts_per_tok=1,
                    router_aux_loss_coef=0.02),
    "qwen3_moe": dict(num_hidden_layers=2, hidden_size=32,
                      num_attention_heads=4, num_key_value_heads=2,
                      head_dim=16, intermediate_size=64, vocab_size=97,
                      rope_theta=1e6, rms_norm_eps=1e-5,
                      tie_word_embeddings=True, moe_intermediate_size=24,
                      num_experts=8, num_experts_per_tok=2,
                      norm_topk_prob=True, router_aux_loss_coef=0.01),
}
_LEFT_OUT = [(fam, k) for fam, full in _MOE_FULL.items()
             for k in ("nothing", *full, "null num_key_value_heads")]


@pytest.mark.parametrize("fam,left_out", _LEFT_OUT)
def test_config_from_hf_defaults_match_the_reference(fam, left_out):
    """A Mixtral or Qwen3-MoE ``config.json`` that leaves a key out (or
    sets one null): the port fills in what ``MixtralConfig`` /
    ``Qwen3MoeConfig`` does (Qwen3-MoE: no ``head_dim`` attribute, and
    ``norm_topk_prob`` False), so every field equals the reference's
    ``config_from_hf`` over ``AutoConfig.for_model``."""
    d = dict(_MOE_FULL[fam])
    if left_out.startswith("null "):
        d[left_out[5:]] = None
    elif left_out != "nothing":
        del d[left_out]
    ref = jhf.config_from_hf(transformers.AutoConfig.for_model(fam, **d))
    port = thf.config_from_hf({"model_type": fam, **d})
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_presets_have_the_published_geometry():
    """Qwen3-30B-A3B (30.53 B parameters, 3.35 B activated) and Mixtral-8x7B
    (46.70 B, 12.88 B activated) as their published config.json files read
    through config_from_hf; the counts equal the reference's and the
    module's own parameters."""
    q = tconfig.qwen3_30b_a3b()
    assert q == dataclasses.replace(thf.config_from_hf({
        "model_type": "qwen3_moe", "num_hidden_layers": 48,
        "hidden_size": 2048, "num_attention_heads": 32,
        "num_key_value_heads": 4, "head_dim": 128, "intermediate_size": 6144,
        "moe_intermediate_size": 768, "num_experts": 128,
        "num_experts_per_tok": 8, "norm_topk_prob": True,
        "vocab_size": 151936, "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
        "tie_word_embeddings": False, "router_aux_loss_coef": 0.001,
        "sliding_window": None, "use_sliding_window": False}),
        dtype="bfloat16")
    m = tconfig.mixtral_8x7b()
    assert m == dataclasses.replace(thf.config_from_hf({
        "model_type": "mixtral", "num_hidden_layers": 32, "hidden_size": 4096,
        "num_attention_heads": 32, "num_key_value_heads": 8,
        "intermediate_size": 14336, "num_local_experts": 8,
        "num_experts_per_tok": 2, "vocab_size": 32000,
        "rope_theta": 1000000.0, "rms_norm_eps": 1e-5,
        "tie_word_embeddings": False, "router_aux_loss_coef": 0.02,
        "sliding_window": None}), dtype="bfloat16")
    # the reference's count leaves the qk-norm scales out (48 x 2 x 128)
    for cfg, total, active, norms in (
            (q, 30_532_110_336, 3_353_020_416, 12_288),
            (m, 46_702_792_704, 12_879_925_248, 0)):
        jcfg = jconfig.TransformerConfig(**{
            **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__},
            "moe": jconfig.MoEConfig(**dataclasses.asdict(cfg.moe))})
        assert param_count(cfg) == jtf.param_count(jcfg) == total
        assert activated_param_count(cfg) == \
            jtf.activated_param_count(jcfg) == active
        assert sum(p.numel() for p in Transformer(
            cfg, device="meta").parameters()) == total + norms


# ---------------- weight sync and the config checks ----------------

def test_moe_weights_through_disk_and_stream_publish(tmp_path):
    """A tiny MoE model's 3-D expert stacks through the port's weight
    sync: a native checkpoint over ``disk`` and a stream publish, each
    applied by ``/update_weights``, leave the server holding the published
    tensors bit for bit and generating their greedy tokens."""
    from areal_tpu_torch.base import name_resolve
    from test_torch_weight_sync import _post, _publish, _server

    old = name_resolve.DEFAULT_REPO
    name_resolve.DEFAULT_REPO = name_resolve.NfsNameRecordRepo(
        str(tmp_path / "nr"))
    try:
        _, tcfg, flat, _ = make_model("moe", seed=15)
        live = params_from_jax(flat, tcfg, device="cpu")
        new = {k: v * 1.5 for k, v in live.items()}
        fresh, fresh_url = _server((tcfg, new))
        try:
            want = _post(fresh_url, {"prompt_ids": [5, 9, 17, 33],
                                     "gconfig": {"greedy": True},
                                     "max_tokens": 4})[1]["output_ids"]
        finally:
            fresh.stop()
        disk = str(tmp_path / "v1")
        thf.save_native_checkpoint(new, tcfg, disk)
        pub = _publish(new, tcfg, 2)
        for body in ({"path": disk, "version": 1},
                     {"endpoint": pub.endpoint, "version": 2}):
            server, url = _server((tcfg, live))
            try:
                status, reply = _post(url, body, path="/update_weights")
                assert status == 200, reply
                got = server.model.state_dict()
                assert tuple(got["layers.0.e_gate"].shape) == (4, 32, 24)
                for k, v in new.items():
                    assert torch.equal(got[k], v), k
                assert _post(url, {"prompt_ids": [5, 9, 17, 33],
                                   "gconfig": {"greedy": True},
                                   "max_tokens": 4})[1]["output_ids"] == want
            finally:
                server.stop()
        pub.close()
    finally:
        name_resolve.DEFAULT_REPO = old


def test_trainer_model_info_carries_the_moe_block():
    """The trainer's model info for the master's FLOPs: the role's ``moe``
    block, and the total and activated parameter counts of the
    reference."""
    from areal_tpu_torch.system.trainer_worker import (
        TrainerWorker,
        TrainerWorkerConfig,
    )
    from test_torch_trainer import CFG

    jm, tm = model_pair(train=False, cfg_kw=TRAIN_MOE)
    w = TrainerWorker(TrainerWorkerConfig())
    w.models["actor"] = tm  # setup()-free: the bookkeeping half only
    w.device = torch.device("cpu")
    try:
        role = w._handle_model_info()["roles"]["actor"]
    finally:
        w.close()
    assert role["moe"] == {"num_experts": 4, "top_k": 2,
                           "routed_intermediate_dim": None,
                           "shared_intermediate_dim": 16}
    jcfg = jconfig.tiny_config(**CFG, **TRAIN_MOE)
    assert role["n_params"] == jtf.param_count(jcfg)
    assert role["n_params_activated"] == jtf.activated_param_count(jcfg) \
        < role["n_params"]


def test_validate_config_checks_the_capacity_factor():
    from areal_tpu_torch.api.cli_args import ConfigError, validate_config
    from areal_tpu_torch.experiments.ppo_math_exp import PPOMATHConfig

    cfg = PPOMATHConfig()
    cfg.actor.tiny = {"moe": {"num_experts": 4, "capacity_factor": 0.0}}
    with pytest.raises(ConfigError, match="capacity_factor"):
        validate_config(cfg)
    cfg.actor.tiny = {"moe": {"num_experts": 4, "capacity_factor": 1.5}}
    validate_config(cfg)
