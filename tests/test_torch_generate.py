"""Port generation (areal_tpu_torch/models/generate.py, ops/sampling.py,
ops/xent.py) against the reference package on the same weights.

Greedy tokens must be identical and logprobs within 1e-4 (float32, same
arithmetic, different summation order). Sampled draws are not compared: the
two random generators differ; the warped distributions are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import _jparams, make_model

from areal_tpu.api.model import GenerationHyperparameters as JGen
from areal_tpu.models import generate as jgen
from areal_tpu.ops import sampling as jsamp
from areal_tpu.ops import xent as jxent
from areal_tpu_torch.api.model import GenerationHyperparameters as TGen
from areal_tpu_torch.models import generate as tgen
from areal_tpu_torch.ops import sampling as tsamp
from areal_tpu_torch.ops import xent as txent


@pytest.fixture(scope="module")
def model():
    return make_model("qwen2", seed=4)


def _prompts(lens=(5, 9, 3, 12)):
    rng = np.random.RandomState(3)
    prompts = [rng.randint(2, 90, n).tolist() for n in lens]
    padded, plens = tgen.pad_prompts(prompts, 0, bucket=16)
    jp, jl = jgen.pad_prompts(prompts, 0, bucket=16)
    np.testing.assert_array_equal(padded, jp)
    np.testing.assert_array_equal(plens, jl)
    return padded, plens


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def test_generate_batch_greedy_matches_reference(model):
    jcfg, _, flat, m = model
    padded, plens = _prompts()
    N = 10
    kw = dict(greedy=True, min_new_tokens=1)
    # Probe with an EOS that never occurs, then make EOS a token some row
    # first emits after step 0: that row then finishes early (blocking a
    # non-argmax token at step 0 does not change its greedy path).
    probe = tgen.generate_batch(m, *_t(padded, plens), None, TGen(**kw), N,
                                eos_token_id=97, pad_token_id=0)
    ids = probe["output_ids"].tolist()
    eos = next(t for row in ids for s, t in enumerate(row)
               if s > 0 and t not in row[:s])
    ref = jgen.generate_batch(
        _jparams(flat), jcfg, jnp.asarray(padded), jnp.asarray(plens),
        jax.random.PRNGKey(0), JGen(**kw), max_new_tokens=N,
        eos_token_id=eos, pad_token_id=0,
    )
    out = tgen.generate_batch(m, *_t(padded, plens), None, TGen(**kw), N,
                              eos_token_id=eos, pad_token_id=0)
    assert (np.asarray(ref["output_lens"]) < N).any()
    for key in ("output_ids", "gen_mask", "output_lens"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    for key in ("output_logprobs", "prompt_logprobs"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-4, err_msg=key)


def test_chunked_decode_matches_one_shot(model):
    """prefill_state + 3 decode chunks == generate_batch, and decoding a
    stacked copy never touches the state it was stacked from."""
    _, _, _, m = model
    padded, plens = _prompts()
    g = TGen(greedy=True)
    ref = tgen.generate_batch(m, *_t(padded, plens), None, g, 24,
                              eos_token_id=1, pad_token_id=0)
    state = tgen.prefill_state(m, *_t(padded, plens), S=64)
    row0 = tgen.slice_state(state, 0)
    row0_k = row0["kv_k"].clone()
    tgen.decode_chunk(m, tgen.stack_states([row0]), torch.zeros(1, dtype=torch.int32),
                      None, g, 8, eos_token_id=1, pad_token_id=0)
    assert torch.equal(row0["kv_k"], row0_k)

    toks, lps = [], []
    done = torch.zeros(len(plens), dtype=torch.int32)
    for _ in range(3):
        state, out = tgen.decode_chunk(m, state, done, None, g, 8,
                                       eos_token_id=1, pad_token_id=0)
        toks.append(out["output_ids"])
        lps.append(out["output_logprobs"])
        done = done + out["gen_mask"].sum(dim=1).to(torch.int32)
    mask = ref["gen_mask"]
    assert torch.equal(torch.cat(toks, 1)[mask], ref["output_ids"][mask])
    np.testing.assert_allclose(torch.cat(lps, 1)[mask].numpy(),
                               ref["output_logprobs"][mask].numpy(), atol=1e-4)
    assert torch.equal(done, ref["output_lens"])


def test_decode_chunk_rows_matches_reference(model):
    """Mixed per-row sampling params (all greedy, so the draws are
    deterministic), min_new_tokens, EOS and row_budget: tokens, logprobs and
    the carried state (cur_len, frozen last_logits) match the reference."""
    jcfg, _, flat, m = model
    padded, plens = _prompts()
    rows = [dict(greedy=True, temperature=0.7, top_k=5),
            dict(greedy=True, top_p=0.5),
            dict(greedy=True, temperature=1.3, top_k=3, top_p=0.8,
                 min_new_tokens=4),
            dict(greedy=True)]
    budget = np.array([6, 3, 6, 6], np.int32)
    done = np.array([0, 2, 0, 1], np.int32)
    probe = tgen.prefill_state(m, *_t(padded, plens), S=32)
    _, pout = tgen.decode_chunk_rows(
        m, probe, *_t(done), None,
        tsamp.sampling_from_gconfigs([TGen(**r) for r in rows]), 6,
        eos_token_id=97, pad_token_id=0)
    eos = int(pout["output_ids"][3, 2])

    jst = jgen.prefill_state(_jparams(flat), jcfg, jnp.asarray(padded),
                             jnp.asarray(plens), S=32)
    jst, jout = jgen.decode_chunk_rows(
        _jparams(flat), jcfg, jst, jnp.asarray(done), jax.random.PRNGKey(0),
        jsamp.sampling_from_gconfigs([JGen(**r) for r in rows]), n_tokens=6,
        eos_token_id=eos, pad_token_id=0, row_budget=jnp.asarray(budget))
    tst = tgen.prefill_state(m, *_t(padded, plens), S=32)
    tst, tout = tgen.decode_chunk_rows(
        m, tst, *_t(done), None,
        tsamp.sampling_from_gconfigs([TGen(**r) for r in rows]), 6,
        eos_token_id=eos, pad_token_id=0, row_budget=torch.from_numpy(budget))
    assert int(tout["output_lens"][3]) <= 3  # row 3 ended on EOS
    for key in ("output_ids", "gen_mask", "output_lens"):
        np.testing.assert_array_equal(tout[key].numpy(), np.asarray(jout[key]),
                                      err_msg=key)
    np.testing.assert_allclose(tout["output_logprobs"].numpy(),
                               np.asarray(jout["output_logprobs"]), atol=1e-4)
    np.testing.assert_array_equal(tst["cur_len"].numpy(),
                                  np.asarray(jst["cur_len"]))
    np.testing.assert_allclose(tst["last_logits"].numpy(),
                               np.asarray(jst["last_logits"]), atol=1e-4)


def test_extend_state_matches_full_prefill(model):
    jcfg, _, flat, m = model
    rng = np.random.RandomState(11)
    common = rng.randint(2, 90, 10).tolist()
    full = common + rng.randint(2, 90, 5).tolist()
    g = TGen(greedy=True)

    padded, plens = tgen.pad_prompts([full], 0, bucket=16)
    ref = tgen.prefill_state(m, *_t(padded, plens), S=64)
    _, ref_out = tgen.decode_chunk(m, ref, torch.zeros(1, dtype=torch.int32),
                                   None, g, 12, eos_token_id=1, pad_token_id=0)

    pc, lc = tgen.pad_prompts([common], 0, bucket=16)
    donor = tgen.prefill_state(m, *_t(pc, lc), S=64)
    donor_k = donor["kv_k"].clone()
    suffix = np.zeros((1, 8), np.int32)  # 5 real + 3 pad tokens
    suffix[0, :5] = full[10:]
    st = tgen.extend_state(m, tgen.clone_prefix(donor, len(common)),
                           *_t(suffix, [5]))
    assert torch.equal(donor["kv_k"], donor_k)  # the clone owns its KV
    assert int(st["cur_len"][0]) == len(full)

    jdonor = jgen.prefill_state(_jparams(flat), jcfg, jnp.asarray(pc),
                                jnp.asarray(lc), S=64)
    jst = jgen.extend_state(_jparams(flat), jcfg,
                            jgen.clone_prefix(jdonor, len(common)),
                            jnp.asarray(suffix), jnp.asarray([5], jnp.int32))
    np.testing.assert_allclose(st["last_logits"].numpy(),
                               np.asarray(jst["last_logits"]), atol=1e-4)
    np.testing.assert_allclose(st["kv_k"].numpy()[:, :, :len(full)],
                               np.asarray(jst["kv_k"])[:, :, :len(full)],
                               atol=1e-4)

    _, out = tgen.decode_chunk(m, st, torch.zeros(1, dtype=torch.int32), None,
                               g, 12, eos_token_id=1, pad_token_id=0)
    assert torch.equal(out["output_ids"], ref_out["output_ids"])
    np.testing.assert_allclose(out["output_logprobs"].numpy(),
                               ref_out["output_logprobs"].numpy(), atol=1e-4)


def test_grow_state_and_capacity_check(model):
    _, _, _, m = model
    padded, plens = _prompts()
    st = tgen.prefill_state(m, *_t(padded, plens), S=20)
    with pytest.raises(ValueError):  # 12 + 16 > 20: a write would land past S
        tgen.decode_chunk(m, st, torch.zeros(4, dtype=torch.int32), None,
                          TGen(greedy=True), 16, eos_token_id=1, pad_token_id=0)
    grown = tgen.grow_state(st, 32)
    assert grown["kv_k"].shape[2] == 32
    assert torch.equal(grown["kv_k"][:, :, :20], st["kv_k"])
    assert tgen.grow_state(st, 16) is st


def test_warp_logits_rows_matches_reference():
    rng = np.random.RandomState(7)
    logits = (rng.randn(5, 50) * 2).astype(np.float32)
    temperature = np.array([0.7, 1.0, 1.3, 2.0, 1e-9], np.float32)
    top_k = np.array([0, 5, 10, 0, 3], np.int32)
    top_p = np.array([1.0, 0.9, 0.5, 0.3, 0.95], np.float32)
    ref = jsamp.warp_logits_rows(*map(jnp.asarray,
                                      (logits, temperature, top_k, top_p)))
    out = tsamp.warp_logits_rows(*_t(logits, temperature, top_k, top_p))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)
    for g in (dict(temperature=0.5, top_k=4), dict(top_p=0.6),
              dict(temperature=1.5, top_k=20, top_p=0.7)):
        ref = jsamp.warp_logits(jnp.asarray(logits), JGen(**g))
        out = tsamp.warp_logits(torch.from_numpy(logits), TGen(**g))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)


def test_sampled_tokens_stay_in_the_warped_support():
    rng = np.random.RandomState(8)
    logits = torch.from_numpy(rng.randn(3, 40).astype(np.float32))
    g = [TGen(top_k=3), TGen(top_p=0.2), TGen(temperature=0.5)]
    sampling = tsamp.sampling_from_gconfigs(g)
    warped = tsamp.warp_logits_rows(logits, sampling["temperature"],
                                    sampling["top_k"], sampling["top_p"])
    gen = torch.Generator().manual_seed(0)
    seen = [set() for _ in g]
    for _ in range(200):
        tok, lp = tsamp.sample_token_rows(logits, gen, sampling)
        assert (lp <= 0).all()
        for i, t in enumerate(tok.tolist()):
            assert warped[i, t] > -1e29
            seen[i].add(t)
    assert len(seen[0]) == 3 and len(seen[2]) > 3


def test_gather_logprobs_matches_reference(monkeypatch):
    rng = np.random.RandomState(9)
    logits = (rng.randn(2, 7, 33) * 3).astype(np.float32)
    labels = rng.randint(0, 33, (2, 7)).astype(np.int32)
    ref = jxent.gather_logprobs(jnp.asarray(logits), jnp.asarray(labels))
    monkeypatch.setattr(txent, "_CHUNK_BYTES", 3 * 4 * 33)  # 3-row chunks
    out = txent.gather_logprobs(*_t(logits, labels))
    assert out.dtype == torch.float32 and out.shape == (2, 7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
