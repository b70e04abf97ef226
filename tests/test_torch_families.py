"""GPT-2 and Gemma in the port (areal_tpu_torch/models/hf.py's families,
transformer.py's learned positions, generate.py, the server's 413 rule)
against the reference package and ``transformers``, in float32 on the CPU at
tiny size.

Tolerances: logits through ``transformers`` at atol 2e-4 / rtol 2e-3
(tests/test_model_parity.py's: another attention and summation order), the
port against the reference at 1e-4 (same arithmetic); greedy tokens equal
and their logprobs within 1e-4; one SFT step's stats at 1e-5 relative and
its updated masters at atol 2e-6 / rtol 2e-5 (tests/test_torch_train.py's);
checkpoint weights bit for bit; head_dim 256 attention at 1e-5 against the
reference's attention and 2e-2 against the interpreted Pallas kernel (the
reference's own tolerance).

Two faults of the reference are pinned here (ROADMAP Queue 3): positions
past GPT-2's learned table are clamped silently, and Gemma's activation is
read from ``hidden_activation``, where ``transformers`` reads
``hidden_act``.
"""

import dataclasses
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from areal_tpu.algorithms import sft as jsft
from areal_tpu.api.data import MicroBatchSpec as JSpec
from areal_tpu.api.model import GenerationHyperparameters as JGen
from areal_tpu.models import generate as jgen
from areal_tpu.models import hf as jhf
from areal_tpu.models import transformer as jtf
from areal_tpu.ops import attention as jattn
from areal_tpu.ops import sampling as jsamp
from areal_tpu.ops.pallas import flash_attention as jfa
from areal_tpu_torch.algorithms import sft as tsft
from areal_tpu_torch.api.data import MicroBatchSpec as TSpec
from areal_tpu_torch.api.model import GenerationHyperparameters as TGen
from areal_tpu_torch.models import config as tconfig
from areal_tpu_torch.models import generate as tgen
from areal_tpu_torch.models import hf as thf
from areal_tpu_torch.models.convert import params_from_jax, params_to_jax
from areal_tpu_torch.models.transformer import Transformer
from areal_tpu_torch.ops import flash_attention as tfa
from areal_tpu_torch.ops import sampling as tsamp
from areal_tpu_torch.system.generation_server import (
    GenerationServer,
    GenerationServerConfig,
)
from test_torch_attention import _case
from test_torch_flash_backward import _reference_grads
from test_torch_model import _jparams, jax_tree, make_model
from test_torch_train import (
    SPEC,
    _assert_masters_match,
    _assert_stats_match,
    _tsample,
)
from test_torch_trainer import model_pair
from test_uniform_prep import _make_batch

VOCAB = 97
HF_CONFIGS = {
    "gpt2": lambda **kw: transformers.GPT2Config(
        vocab_size=VOCAB, n_positions=32, n_embd=32, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, **kw),
    # head_dim 16 != hidden / heads (8), as Gemma-7B's 256 != 3072 / 16
    "gemma": lambda **kw: transformers.GemmaConfig(
        vocab_size=VOCAB, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1,
        head_dim=16, max_position_embeddings=64, **kw),
}
# the trainer's tiny configs (vocab 128, test_torch_trainer.CFG)
TRAIN_KW = {
    "gpt2": dict(hf_family="gpt2", n_kv_heads=4, norm_type="layer",
                 mlp_type="plain", hidden_act="gelu_tanh",
                 use_attention_bias=True, use_attn_output_bias=True,
                 pos_embedding="learned", max_position_embeddings=32),
    "gemma": dict(hf_family="gemma", n_kv_heads=1, use_attention_bias=False,
                  hidden_act="gelu_tanh", scale_embeddings=True),
}


def hf_model(family, seed=0, scale=0.1, **kw):
    """A tiny ``transformers`` model of ``family`` whose every parameter
    (norm scales and biases too) is its init plus seeded noise."""
    torch.manual_seed(seed)
    model = transformers.AutoModelForCausalLM.from_config(
        HF_CONFIGS[family](**kw)).eval()
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for _, p in sorted(model.named_parameters()):
            p.add_(torch.from_numpy(
                scale * rng.randn(*p.shape).astype(np.float32)))
    return model


def _hf_logits(model, ids):
    with torch.no_grad():
        return model(input_ids=torch.from_numpy(ids)).logits.numpy()


def _port_logits(cfg, params, ids):
    B, T = ids.shape
    pos = torch.arange(T).expand(B, T)
    with torch.no_grad():
        out, _ = Transformer.from_params(cfg, params)(
            torch.from_numpy(ids), pos,
            segment_ids=torch.ones(B, T, dtype=torch.int32))
    return out.numpy()


def _ref_logits(jcfg, jparams, ids):
    B, T = ids.shape
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    out, _ = jtf.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos),
                         segment_ids=jnp.ones((B, T), jnp.int32))
    return np.asarray(out)


@pytest.fixture(scope="module", params=["gpt2", "gemma"])
def family(request):
    """(family, transformers model, reference cfg and params, port cfg and
    params), both packages loading the same in-memory model."""
    model = hf_model(request.param)
    jcfg, jparams, _ = jhf.load_hf_model(model)
    cfg, params = thf.load_hf_model(model, device="cpu")
    return request.param, model, jcfg, jax_tree(jparams), cfg, params


def test_logits_match_reference_and_transformers(family):
    name, model, jcfg, jparams, cfg, params = family
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.hf_family == name
    ids = np.random.RandomState(1).randint(0, VOCAB, (2, 20))
    port = _port_logits(cfg, params, ids)
    np.testing.assert_allclose(port, _ref_logits(jcfg, jparams, ids),
                               atol=1e-4)
    np.testing.assert_allclose(port, _hf_logits(model, ids), atol=2e-4,
                               rtol=2e-3)


def test_greedy_generation_through_the_kv_cache(family):
    _, _, jcfg, jparams, cfg, params = family
    rng = np.random.RandomState(2)
    prompts = [rng.randint(2, VOCAB, n).tolist() for n in (5, 11, 3)]
    padded, plens = tgen.pad_prompts(prompts, 0, bucket=16)
    N = 10  # positions up to 15 + 10: inside GPT-2's 32-row table
    ref = jgen.generate_batch(
        jparams, jcfg, jnp.asarray(padded), jnp.asarray(plens),
        jax.random.PRNGKey(0), JGen(greedy=True), max_new_tokens=N,
        eos_token_id=VOCAB, pad_token_id=0)
    out = tgen.generate_batch(
        Transformer.from_params(cfg, params), torch.from_numpy(padded),
        torch.from_numpy(plens), None, TGen(greedy=True), N,
        eos_token_id=VOCAB, pad_token_id=0)
    for key in ("output_ids", "output_lens"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))
    for key in ("output_logprobs", "prompt_logprobs"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-4, err_msg=key)


def test_hf_checkpoints_cross_packages_and_transformers(family, tmp_path):
    """The port's HF directory loads in ``transformers`` (same logits) and
    in the reference (same weights, bit for bit); the reference's loads in
    the port; each package's copy of the other's equals its own."""
    name, model, jcfg, jparams, cfg, params = family
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    thf.save_hf_checkpoint(params, cfg, port_dir)
    with open(f"{port_dir}/config.json") as f:
        assert json.load(f) == jhf.hf_config_dict(jcfg)
    theirs = transformers.AutoModelForCausalLM.from_pretrained(port_dir).eval()
    ids = np.random.RandomState(3).randint(0, VOCAB, (2, 12))
    np.testing.assert_allclose(_hf_logits(theirs, ids), _hf_logits(model, ids),
                               atol=2e-4, rtol=2e-3)
    jcfg2, jp2 = jhf.load_hf_checkpoint(port_dir)
    cfg2, p2 = thf.load_hf_checkpoint(port_dir, device="cpu")
    assert dataclasses.asdict(jcfg2) == dataclasses.asdict(cfg2)
    want = jhf.flatten_pytree(jp2, as_numpy=True)
    got = params_to_jax(p2, cfg2)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jhf.save_hf_checkpoint(jparams, jcfg, ref_dir)
    cfg3, p3 = thf.load_hf_checkpoint(ref_dir, device="cpu")
    assert cfg3 == cfg2
    for k, t in p2.items():
        assert torch.equal(p3[k], t), k
    # the (w - 1) fold of Gemma's norms is undone to within one f32 rounding
    for k, t in params.items():
        np.testing.assert_allclose(p2[k].numpy(), t.numpy(), atol=1e-7,
                                   rtol=0, err_msg=k)


def test_native_checkpoints_cross_packages(family, tmp_path):
    _, _, jcfg, jparams, cfg, params = family
    thf.save_native_checkpoint(params, cfg, str(tmp_path / "port"))
    jcfg2, jp2 = jhf.load_checkpoint_auto(str(tmp_path / "port"))
    assert dataclasses.asdict(jcfg2) == dataclasses.asdict(cfg)
    want = params_to_jax(params, cfg)
    got = jhf.flatten_pytree(jp2, as_numpy=True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jhf.save_native_checkpoint(jparams, jcfg, str(tmp_path / "ref"))
    cfg3, p3 = thf.load_checkpoint_auto(str(tmp_path / "ref"), device="cpu")
    assert cfg3 == cfg
    for k, t in params.items():
        assert torch.equal(p3[k], t), k


@pytest.mark.parametrize("name", ["gpt2", "gemma"])
def test_sft_step_matches_reference(name):
    jm, tm = model_pair(remat="dots", logprob_chunk=8, cfg_kw=TRAIN_KW[name])
    batch = _make_batch(seed=21)
    want = jsft.SFTInterface("global").train_step(jm, batch, JSpec(**SPEC))
    got = tsft.SFTInterface("global").train_step(tm, _tsample(batch),
                                                 TSpec(**SPEC))
    assert set(got) == set(want) and got["grad_norm"] > 0
    _assert_stats_match(got, want)
    _assert_masters_match(jm.module, tm.module, tm.module.cfg)
    if name == "gpt2":  # the learned table took a step
        assert "pos_embedding.weight" in tm.module.params


_GEMMA_FULL = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
                   num_key_value_heads=1, head_dim=16, intermediate_size=64,
                   vocab_size=97, rope_theta=1e6, rms_norm_eps=1e-5,
                   tie_word_embeddings=False, hidden_activation="gelu")
_GPT2_FULL = dict(n_layer=2, n_embd=32, n_head=4, n_inner=48, vocab_size=97,
                  layer_norm_epsilon=1e-6, n_positions=48)
_LEFT_OUT = [("gemma", k) for k in ("nothing", *_GEMMA_FULL, "null head_dim",
                                    "null num_key_value_heads")] + \
    [("gpt2", k) for k in ("nothing", *_GPT2_FULL, "null n_inner")]


@pytest.mark.parametrize("fam,left_out", _LEFT_OUT)
def test_config_from_hf_defaults_match_the_reference(fam, left_out):
    """A ``config.json`` that leaves a key out (or sets it null): the port
    fills in what ``GemmaConfig`` / ``GPT2Config`` does, so every field
    equals the reference's ``config_from_hf`` over ``AutoConfig.for_model``."""
    d = dict(_GEMMA_FULL if fam == "gemma" else _GPT2_FULL)
    if left_out.startswith("null "):
        d[left_out[5:]] = None
    elif left_out != "nothing":
        del d[left_out]
    ref = jhf.config_from_hf(transformers.AutoConfig.for_model(fam, **d))
    port = thf.config_from_hf({"model_type": fam, **d})
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_presets_have_the_published_geometry():
    g = tconfig.gpt2_small()
    assert (g.n_layers, g.hidden_dim, g.n_q_heads, g.head_dim,
            g.intermediate_dim, g.vocab_size, g.max_position_embeddings,
            g.rms_norm_eps) == (12, 768, 12, 64, 3072, 50257, 1024, 1e-5)
    assert dataclasses.replace(g, dtype="float32") == thf.config_from_hf(
        {"model_type": "gpt2"})  # GPT2Config's defaults are GPT-2 small's
    m = tconfig.gemma_2b()
    assert (m.n_layers, m.hidden_dim, m.n_q_heads, m.n_kv_heads, m.head_dim,
            m.intermediate_dim, m.vocab_size) == (18, 2048, 8, 1, 256, 16384,
                                                  256000)
    assert dataclasses.replace(m, dtype="float32") == thf.config_from_hf(
        {"model_type": "gemma", "num_hidden_layers": 18, "hidden_size": 2048,
         "intermediate_size": 16384, "num_attention_heads": 8,
         "num_key_value_heads": 1, "head_dim": 256})
    assert sum(p.numel() for p in Transformer(m, device="meta").parameters()) \
        == 2_506_172_416


# ---------------- fault 1: positions past the learned table ----------------

def _gpt2_16():
    """A tiny GPT-2 (reference and port) with a 16-row position table."""
    return make_model("gpt2", seed=9, max_position_embeddings=16)


def test_reference_clamps_positions_past_the_table_and_port_refuses():
    """The reference's ``forward`` indexes ``pos_embedding[positions]``
    (areal_tpu/models/transformer.py:430-431), which jax clamps: one token
    at positions 16-19 of a 16-row table gives exactly the logits of
    position 15. The port raises, naming the limit."""
    jcfg, tcfg, flat, model = _gpt2_16()
    tokens = np.full((5, 1), 7, np.int32)
    pos = np.arange(15, 20, dtype=np.int32)[:, None]
    seg = np.ones((5, 1), np.int32)
    ref = np.asarray(jtf.forward(_jparams(flat), jcfg, jnp.asarray(tokens),
                                 jnp.asarray(pos),
                                 segment_ids=jnp.asarray(seg))[0])
    for row in range(1, 5):
        np.testing.assert_array_equal(ref[row], ref[0])
    with torch.no_grad():
        ok, _ = model(torch.from_numpy(tokens[:1]), torch.from_numpy(pos[:1]),
                      segment_ids=torch.from_numpy(seg[:1]))
        np.testing.assert_allclose(ok.numpy(), ref[:1], atol=1e-4)
        with pytest.raises(ValueError, match="max_position_embeddings=16"):
            model(torch.from_numpy(tokens), torch.from_numpy(pos),
                  segment_ids=torch.from_numpy(seg))
        # cache mode: every row is kept
        cache = {"k": torch.zeros(2, 1, 20, 4, 8),
                 "v": torch.zeros(2, 1, 20, 4, 8)}
        with pytest.raises(ValueError, match="max_position_embeddings=16"):
            model(torch.tensor([[7]]), torch.tensor([[16]]), kv_cache=cache,
                  cache_write_index=16,
                  kv_valid=torch.arange(20)[None] <= 16)


def test_pad_columns_past_the_table_equal_the_reference():
    """A row padded past the table (its pad columns at positions 16-23,
    segment 0): the port clamps them as the reference does, so every logit,
    pad columns included, equals the reference's."""
    jcfg, tcfg, flat, model = _gpt2_16()
    tokens = np.random.RandomState(4).randint(0, VOCAB, (2, 24)).astype(
        np.int32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    seg = np.zeros((2, 24), np.int32)
    seg[0, :16], seg[1, :9] = 1, 1
    ref = np.asarray(jtf.forward(_jparams(flat), jcfg, jnp.asarray(tokens),
                                 jnp.asarray(pos),
                                 segment_ids=jnp.asarray(seg))[0])
    with torch.no_grad():
        got, _ = model(torch.from_numpy(tokens), torch.from_numpy(pos),
                       segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_generation_to_the_table_end_and_the_server_413():
    """Greedy decode up to the table's last row matches the reference: row
    0's last live token sits at position 15, row 1 uses its budget at 15
    and runs its remaining pad steps at position 16, which the port clamps
    as the reference does. The server refuses a prompt plus budget past
    the table with 413 ``prompt_too_long`` before any prefill, and keeps
    serving."""
    jcfg, tcfg, flat, model = _gpt2_16()
    padded, plens = tgen.pad_prompts([[5, 9, 11, 3], [8, 2, 4, 4, 6, 1, 2,
                                                      9]], 0, bucket=8)
    budget = np.array([12, 8], np.int32)
    sampling = [JGen(greedy=True)] * 2
    jst = jgen.prefill_state(_jparams(flat), jcfg, jnp.asarray(padded),
                             jnp.asarray(plens), S=24)
    _, ref = jgen.decode_chunk_rows(
        _jparams(flat), jcfg, jst, jnp.zeros(2, jnp.int32),
        jax.random.PRNGKey(0), jsamp.sampling_from_gconfigs(sampling),
        n_tokens=12, eos_token_id=VOCAB, pad_token_id=0,
        row_budget=jnp.asarray(budget))
    tst = tgen.prefill_state(model, *map(torch.from_numpy, (padded, plens)),
                             S=24)
    _, out = tgen.decode_chunk_rows(
        model, tst, torch.zeros(2, dtype=torch.int32), None,
        tsamp.sampling_from_gconfigs([TGen(greedy=True)] * 2), 12,
        eos_token_id=VOCAB, pad_token_id=0,
        row_budget=torch.from_numpy(budget))
    for key in ("output_ids", "output_lens"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))
    np.testing.assert_allclose(out["output_logprobs"].numpy(),
                               np.asarray(ref["output_logprobs"]), atol=1e-4)
    server = GenerationServer(
        GenerationServerConfig(chunk_tokens=8, prompt_bucket=8, kv_bucket=32,
                               eos_token_id=VOCAB, batch_window_ms=5),
        tcfg, params_from_jax(flat, tcfg, device="cpu"), device="cpu")
    url = server.start()
    try:
        def post(body):
            req = urllib.request.Request(
                url + "/generate", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        greedy = {"greedy": True}
        code, body = post({"prompt_ids": [5] * 10, "max_tokens": 7,
                           "gconfig": greedy})
        assert code == 413 and body == {"ok": False,
                                        "reason": "prompt_too_long",
                                        "needed_slots": 17, "max_slots": 16}
        code, body = post({"prompt_ids": [5] * 10, "max_tokens": 4,
                           "budget_total": 8, "gconfig": greedy})
        assert code == 413 and body["needed_slots"] == 18
        assert server.stats()["prefill_calls"] == 0
        code, body = post({"prompt_ids": [5] * 10, "max_tokens": 6,
                           "gconfig": greedy})
        assert code == 200 and len(body["output_ids"]) == 6
    finally:
        server.stop()


# ---------------- fault 2: Gemma's activation key ----------------

def test_gemma_activation_is_read_from_hidden_activation():
    """``transformers`` builds Gemma's MLP from ``hidden_act``; the
    reference reads ``hidden_activation`` (absent: tanh GELU). With
    ``hidden_act="gelu"`` and no ``hidden_activation`` the two part by more
    than the parity tolerance; with the default ``gelu_pytorch_tanh`` they
    agree. The port reads the reference's key: its logits equal the
    reference's in both cases."""
    ids = np.random.RandomState(6).randint(0, VOCAB, (2, 16))
    for act, parts in (("gelu", True), ("gelu_pytorch_tanh", False)):
        model = hf_model("gemma", seed=7, scale=0.5, hidden_act=act)
        assert model.config.hidden_activation is None
        jcfg, jparams, _ = jhf.load_hf_model(model)
        cfg, params = thf.load_hf_model(model, device="cpu")
        assert jcfg.hidden_act == cfg.hidden_act == "gelu_tanh"
        ref = _ref_logits(jcfg, jax_tree(jparams), ids)
        np.testing.assert_allclose(_port_logits(cfg, params, ids), ref,
                                   atol=1e-4, rtol=1e-5)
        agree = np.allclose(_hf_logits(model, ids), ref, atol=2e-4, rtol=2e-3)
        assert agree != parts, act


# ---------------- K1-K3's function at head_dim 256 ----------------

@pytest.mark.parametrize("seqlens,row_len", [([60, 68], None),
                                             ([90, 70, 30], 200)])
def test_head_dim_256_matches_reference_attention(seqlens, row_len):
    """The plain versions of K1 and of K2/K3 (what the kernels are held to
    on the card) at Gemma's head_dim 256 with 8 q heads over one kv head,
    against the reference's attention and its ``jax.vjp``; through
    ``FlashAttention`` too."""
    q, k, v, seg, pos = _case(seqlens, row_len, Hq=8, Hkv=1, D=256, seed=11)
    ref = jattn.packed_attention(*map(jnp.asarray, (q, k, v, seg, seg)),
                                 q_positions=jnp.asarray(pos),
                                 kv_positions=jnp.asarray(pos),
                                 impl="reference")
    dout = np.random.RandomState(12).randn(*q.shape).astype(np.float32)
    want = _reference_grads(q, k, v, seg, pos, dout)
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ts = torch.from_numpy(seg)
    out = tfa.FlashAttention.apply(*xs, ts, ts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    out.backward(torch.from_numpy(dout))
    for name, x, g in zip("qkv", xs, want):
        np.testing.assert_allclose(x.grad.numpy(), g, atol=1e-5,
                                   err_msg=name)
        assert (x.grad.numpy()[seg == 0] == 0).all(), name


def test_head_dim_256_matches_pallas_interpreted():
    ctx = jfa.interpret_mode()
    if ctx is None:
        pytest.skip("this jax cannot interpret the Pallas TPU flash kernel")
    q, k, v, seg, _ = _case([96, 32], None, Hq=8, Hkv=1, D=256, seed=13)

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, jnp.asarray(seg), jnp.asarray(seg))
        return jnp.sum(o * o), o

    with ctx:
        (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(
            *map(jnp.asarray, (q, k, v)))
        o = np.asarray(jax.block_until_ready(o))
        grads = [np.asarray(g) for g in grads]
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ts = torch.from_numpy(seg)
    out = tfa.FlashAttention.apply(*xs, ts, ts)
    np.testing.assert_allclose(out.detach().numpy(), o, atol=2e-2)
    (out * out).sum().backward()
    for name, x, g in zip("qkv", xs, grads):
        np.testing.assert_allclose(x.grad.numpy(), g, atol=2e-2,
                                   err_msg=f"grad mismatch for {name}")
