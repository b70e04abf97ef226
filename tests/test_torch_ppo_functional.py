"""The port's PPO math (areal_tpu_torch/algorithms/ppo_functional.py, and
ops/xent.py's gather_logprobs with its hand-written backward) against the
reference's ``areal_tpu/algorithms/ppo_functional.py`` on seeded numpy
inputs, in float32 on the CPU. Tolerances: exact for masks and shifts, 1e-6
for elementwise math and losses, 1e-5 for GAE (the port's doubling scan and
the reference's associative scan combine in different orders) and against
the float64 numpy oracle ``gae_packed_np`` at 1e-4 (the reference's own
test tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.algorithms import ppo_functional as J
from areal_tpu.models import packing
from areal_tpu_torch.algorithms import ppo_functional as T


def _grid(seed=0, B=3, L=40, V=50):
    """A packed grid: segment ids with several docs and pad tails, tokens,
    a prompt mask, logits and per-token floats."""
    rng = np.random.RandomState(seed)
    layout = packing.plan_packing([11, 7, 15, 3, 9, 20, 6], row_len=L)
    seg = packing.make_grid(layout)["segment_ids"][:B]
    tokens = rng.randint(0, V, seg.shape).astype(np.int32)
    prompt = (rng.rand(*seg.shape) < 0.3).astype(np.int32)
    logits = rng.randn(*seg.shape, V).astype(np.float32)
    floats = [rng.randn(*seg.shape).astype(np.float32) for _ in range(4)]
    return seg, tokens, prompt, logits, floats


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_labels_shift_and_logprobs_match_reference():
    seg, tokens, _, logits, (s, *_) = _grid()
    np.testing.assert_array_equal(
        T.next_token_labels(_t(tokens)).numpy(),
        np.asarray(J.next_token_labels(jnp.asarray(tokens))))
    np.testing.assert_allclose(
        T.shift_mask_scores(_t(s), _t(seg)).numpy(),
        np.asarray(J.shift_mask_scores(jnp.asarray(s), jnp.asarray(seg))),
        atol=0)
    np.testing.assert_allclose(
        T.token_logprobs_from_logits(_t(logits), _t(tokens), _t(seg)).numpy(),
        np.asarray(J.token_logprobs_from_logits(
            jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(seg))),
        atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_gather_logprobs_backward_matches_reference(dtype):
    """The hand-written backward of the chunked log-prob head against
    jax.vjp of the reference's fused reduction, in float32 and bfloat16
    (bf16: the same rounding points, so agreement to one bf16 ulp)."""
    _, tokens, _, logits, (g, *_) = _grid(seed=1)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    jl = jnp.asarray(logits).astype(jdt)
    out, vjp = jax.vjp(lambda x: J.gather_logprobs(x, jnp.asarray(tokens)), jl)
    (want,) = vjp(jnp.asarray(g))
    tl = _t(logits).to(tdt).requires_grad_()
    got = T.gather_logprobs(tl, _t(tokens))
    got.backward(_t(g))
    tol = 1e-6 if dtype is np.float32 else 2 ** -8
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=tol * 20)
    np.testing.assert_allclose(tl.grad.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol * np.abs(g).max())


def test_masks_match_reference_for_numpy_and_torch():
    seg, _, prompt, _, (x, *_) = _grid()
    want_mask = np.asarray(J.action_token_mask(jnp.asarray(seg), jnp.asarray(prompt)))
    np.testing.assert_array_equal(T.action_token_mask(seg, prompt), want_mask)
    np.testing.assert_array_equal(
        T.action_token_mask(_t(seg), _t(prompt)).numpy(), want_mask)
    want = np.asarray(J.shift_right_in_doc(jnp.asarray(x), jnp.asarray(seg)))
    np.testing.assert_array_equal(T.shift_right_in_doc(x, seg), want)
    np.testing.assert_array_equal(T.shift_right_in_doc(_t(x), _t(seg)).numpy(), want)


def test_masked_normalization_matches_reference():
    seg, _, prompt, _, (x, *_) = _grid()
    mask = np.asarray(J.action_token_mask(jnp.asarray(seg), jnp.asarray(prompt)))
    np.testing.assert_allclose(
        T.masked_normalization(_t(x), _t(mask)).numpy(),
        np.asarray(J.masked_normalization(jnp.asarray(x), jnp.asarray(mask))),
        atol=1e-6)


@pytest.mark.parametrize("gamma,lam,boot", [(1.0, 1.0, False), (0.99, 0.95, True)])
def test_gae_grid_matches_reference_and_numpy_oracle(gamma, lam, boot):
    rng = np.random.RandomState(2)
    seqlens = [5, 9, 3, 14, 1, 30, 7]
    layout = packing.plan_packing(seqlens, row_len=40)
    seg = packing.make_grid(layout)["segment_ids"]
    total = sum(seqlens)
    rewards = rng.randn(total).astype(np.float32)
    values = rng.randn(total).astype(np.float32)
    bs = rng.rand(len(seqlens)).astype(np.float32) if boot else None
    r_g = packing.batch_from_packed(rewards, layout)
    v_g = packing.batch_from_packed(values, layout)
    b_g = None
    if boot:
        b_g = np.zeros(layout.shape, np.float32)
        for i, ((row, col), n) in enumerate(zip(layout.placements, layout.seqlens)):
            b_g[row, col + n - 1] = bs[i]
    adv, ret = T.gae_grid(_t(r_g), _t(v_g), _t(seg),
                          bootstrap=None if b_g is None else _t(b_g),
                          gamma=gamma, lam=lam)
    j_adv, j_ret = J.gae_grid(jnp.asarray(r_g), jnp.asarray(v_g), jnp.asarray(seg),
                              bootstrap=None if b_g is None else jnp.asarray(b_g),
                              gamma=gamma, lam=lam)
    np.testing.assert_allclose(adv.numpy(), np.asarray(j_adv), atol=1e-5)
    np.testing.assert_allclose(ret.numpy(), np.asarray(j_ret), atol=1e-5)
    o_adv, o_ret = T.gae_packed_np(rewards, values, seqlens, bootstrap=bs,
                                   gamma=gamma, lam=lam)
    w_adv, w_ret = J.gae_packed_np(rewards, values, seqlens, bootstrap=bs,
                                   gamma=gamma, lam=lam)
    np.testing.assert_array_equal(o_adv, w_adv)
    np.testing.assert_array_equal(o_ret, w_ret)
    np.testing.assert_allclose(packing.packed_from_batch(adv.numpy(), layout),
                               o_adv, atol=1e-4)
    np.testing.assert_allclose(packing.packed_from_batch(ret.numpy(), layout),
                               o_ret, atol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(c_clip=3.0),
    dict(proximal=True, behav_imp_weight_cap=1.5),
    dict(proximal=True, loss_scale=1.0),
])
def test_actor_loss_matches_reference(kw):
    seg, _, prompt, _, (lp, old, adv, prox) = _grid(seed=3)
    lp, old, prox = -np.abs(lp), -np.abs(old), -np.abs(prox)
    mask = np.asarray(J.action_token_mask(jnp.asarray(seg), jnp.asarray(prompt)))
    kw = dict(kw)
    use_prox = kw.pop("proximal", False)
    jl, jst = J.actor_loss(*map(jnp.asarray, (lp, old, adv, mask)),
                           proximal_logprobs=jnp.asarray(prox) if use_prox else None,
                           **kw)
    tl, tst = T.actor_loss(*map(_t, (lp, old, adv, mask)),
                           proximal_logprobs=_t(prox) if use_prox else None, **kw)
    assert float(tl) == pytest.approx(float(jl), rel=1e-6, abs=1e-7)
    assert set(tst) == set(jst)
    for key in jst:
        assert float(tst[key]) == pytest.approx(float(jst[key]), rel=1e-6,
                                                abs=1e-7), key


def test_kl_controllers_match_reference():
    jf, tf = J.FixedKLController(0.2), T.FixedKLController(0.2)
    ja, ta = (m.AdaptiveKLController(0.1, 6.0, 100.0) for m in (J, T))
    for kl in (3.0, 9.0, 6.0, 0.5):
        for j, t in ((jf, tf), (ja, ta)):
            j.update(kl, n_steps=4)
            t.update(kl, n_steps=4)
            assert t.value == j.value
