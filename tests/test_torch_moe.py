"""The port's MoE layer (areal_tpu_torch/models/moe.py) against the
reference's (areal_tpu/models/moe.py), in float32 on the CPU.

The same numpy-seeded inputs and weights go through both packages'
``moe_mlp`` for each dispatch: outputs and all six aux values within 1e-5,
the gradients of the input and of every weight within 1e-4 relative to
their largest magnitude. Within the port, the grouped dispatch equals the
einsum oracle (drops and padding included) with equal keep masks. The
router jitter is held in distribution only (the port's generator does not
draw the reference's PRNG numbers). The reference's decode drop (ROADMAP.md
Queue 3 item 11) is pinned on both packages.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.models import moe as jmoe
from areal_tpu.models.config import MoEConfig as JMoE
from areal_tpu_torch.models import moe as tmoe
from areal_tpu_torch.models.config import MoEConfig as TMoE

AUX_SCALARS = ("aux_total", "load_balance_loss", "z_loss", "dropped_frac",
               "expert_load_ratio")
# (experts, top_k, capacity_factor, shared expert, norm_topk_prob, z-loss):
# no drop, a heavy drop (cf 0.5), k=1 and k=4, with and without the shared
# expert and the renorm; every case with a padded tail.
CASES = {
    "e4k2_shared": (4, 2, 1.0, 24, True, 1e-3),
    "e8k2_no_renorm": (8, 2, 2.0, None, False, 1e-3),
    "e8k1_drop": (8, 1, 0.5, 24, True, 1e-3),
    "e16k4_no_zloss": (16, 4, 1.5, None, True, 0.0),
}
D, F, B, T = 16, 32, 4, 16


def _case(name, seed=None):
    """(moe kwargs, x [B, T, D], mask [B, T], reference-layout weights)."""
    E, k, cf, shared, norm, z = CASES[name]
    rng = np.random.RandomState(E * 10 + k if seed is None else seed)
    lp = {"router": rng.randn(D, E) * 0.5, "e_gate": rng.randn(E, D, F) * 0.1,
          "e_up": rng.randn(E, D, F) * 0.1, "e_down": rng.randn(E, F, D) * 0.1}
    if shared:
        lp.update(s_gate=rng.randn(D, shared) * 0.1,
                  s_up=rng.randn(D, shared) * 0.1,
                  s_down=rng.randn(shared, D) * 0.1)
    lp = {key: v.astype(np.float32) for key, v in lp.items()}
    x = rng.randn(B, T, D).astype(np.float32)
    mask = (np.arange(T)[None, :] < int(T * 0.8)).repeat(B, 0)
    kw = dict(num_experts=E, top_k=k, capacity_factor=cf, aux_loss_coeff=1e-2,
              z_loss_coeff=z, shared_intermediate_dim=shared,
              norm_topk_prob=norm)
    return kw, x, mask, lp


# router and shared-expert weights are linears in the port: [out, in]
_TRANSPOSED = {"router", "s_gate", "s_up", "s_down"}


def _port_lp(lp, requires_grad=False):
    return {key: torch.tensor(v.T.copy() if key in _TRANSPOSED else v,
                              requires_grad=requires_grad)
            for key, v in lp.items()}


def _port_grad(key, g):
    """A port gradient in the reference's layout."""
    g = g.numpy()
    return g.T if key in _TRANSPOSED else g


def _ref_run(kw, x, mask, lp, dispatch):
    def loss(lp_, x_):
        y, aux = jmoe.moe_mlp(x_, lp_, JMoE(**kw), mask=jnp.asarray(mask),
                              dispatch=dispatch)
        return jnp.sum(y * y) + aux["aux_total"], (y, aux)

    (l, (y, aux)), (glp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
        {key: jnp.asarray(v) for key, v in lp.items()}, jnp.asarray(x))
    return float(l), np.asarray(y), aux, {**glp, "x": gx}


def _port_run(kw, x, mask, lp, dispatch):
    tlp = _port_lp(lp, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    y, aux, keep = tmoe.moe_mlp(tx, tlp, TMoE(**kw),
                                mask=torch.from_numpy(mask),
                                dispatch=dispatch, return_keep=True)
    loss = (y * y).sum() + aux["aux_total"]
    loss.backward()
    grads = {key: _port_grad(key, t.grad) for key, t in tlp.items()}
    grads["x"] = tx.grad.numpy()
    return float(loss), y.detach().numpy(), aux, grads, keep


def _assert_grads_close(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[key], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=key)


@pytest.mark.parametrize("dispatch", ["grouped", "einsum"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_mlp_matches_reference(case, dispatch):
    """Output, the six aux values and every gradient against the
    reference's moe_mlp with the same dispatch."""
    kw, x, mask, lp = _case(case)
    jl, jy, jaux, jg = _ref_run(kw, x, mask, lp, dispatch)
    tl, ty, taux, tg, _ = _port_run(kw, x, mask, lp, dispatch)
    np.testing.assert_allclose(ty, jy, atol=1e-5)
    assert tl == pytest.approx(jl, rel=1e-5)
    assert set(taux) == set(jaux) == {*AUX_SCALARS, "expert_load"}
    for key in AUX_SCALARS:
        assert float(taux[key]) == pytest.approx(float(jaux[key]),
                                                 abs=1e-5), key
    np.testing.assert_allclose(taux["expert_load"].detach().numpy(),
                               np.asarray(jaux["expert_load"]), atol=1e-5)
    if kw["capacity_factor"] <= 0.5:
        assert float(taux["dropped_frac"]) > 0.0
    _assert_grads_close(tg, jg)


@pytest.mark.parametrize("case", sorted(CASES))
def test_grouped_equals_einsum_in_the_port(case):
    """The grouped dispatch against the port's own einsum oracle: loss,
    gradients, the drop fraction and the keep masks; pad rows come out as
    the shared expert alone (0 without one)."""
    kw, x, mask, lp = _case(case)
    gl, gy, gaux, gg, gkeep = _port_run(kw, x, mask, lp, "grouped")
    el, ey, eaux, eg, ekeep = _port_run(kw, x, mask, lp, "einsum")
    assert gl == pytest.approx(el, rel=1e-5)
    np.testing.assert_allclose(gy, ey, atol=1e-5)
    assert torch.equal(gkeep, ekeep)
    assert float(gaux["dropped_frac"]) == float(eaux["dropped_frac"])
    assert not gkeep.reshape(B, T, -1)[~torch.from_numpy(mask)].any()
    if not kw["shared_intermediate_dim"]:
        assert not gy[~mask].any()
    _assert_grads_close(gg, eg)


def test_grouped_matmul_rows_past_the_groups_are_zero():
    """Rows past sum(group_sizes) come out as exact zeros with a zero
    gradient; each segment multiplies its own group's matrix."""
    rng = np.random.RandomState(0)
    xs = torch.tensor(rng.randn(10, 4).astype(np.float32), requires_grad=True)
    w = torch.tensor(rng.randn(3, 4, 5).astype(np.float32), requires_grad=True)
    out = tmoe.grouped_matmul(xs, w, [3, 0, 4])
    assert out.shape == (10, 5) and not out[7:].any()
    torch.testing.assert_close(out[:3], xs[:3] @ w[0])
    torch.testing.assert_close(out[3:7], xs[3:7] @ w[2])
    out.sum().backward()
    assert not xs.grad[7:].any() and not w.grad[1].any()
    ref = jax.lax.ragged_dot(jnp.asarray(xs.detach().numpy()),
                             jnp.asarray(w.detach().numpy()),
                             jnp.asarray([3, 0, 4], jnp.int32))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-6)


def test_single_expert_matches_dense():
    """E=1, k=1, ample capacity: the layer is the dense silu MLP."""
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(2, 12, 16).astype(np.float32))
    wg, wu = (torch.tensor(rng.randn(16, 32).astype(np.float32) * 0.1)
              for _ in range(2))
    wd = torch.tensor(rng.randn(32, 16).astype(np.float32) * 0.1)
    lp = {"router": torch.zeros(1, 16), "e_gate": wg[None], "e_up": wu[None],
          "e_down": wd[None]}
    y, aux = tmoe.moe_mlp(x, lp, TMoE(num_experts=1, top_k=1,
                                      capacity_factor=1.0))
    dense = (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd
    torch.testing.assert_close(y, dense, atol=1e-5, rtol=0)
    assert float(aux["dropped_frac"]) == 0.0


def test_routing_health_aux():
    """expert_load sums to 1 over the experts and the ratio is its max over
    its mean, in [1, E]."""
    kw, x, mask, lp = _case("e8k2_no_renorm", seed=3)
    _, aux = tmoe.moe_mlp(torch.from_numpy(x), _port_lp(lp), TMoE(**kw),
                          mask=torch.from_numpy(mask))
    load = aux["expert_load"]
    assert load.shape == (8,)
    assert float(load.sum()) == pytest.approx(1.0, abs=1e-6)
    ratio = float(aux["expert_load_ratio"])
    assert 1.0 <= ratio <= 8.0
    assert ratio == pytest.approx(float(load.max() / load.mean()), rel=1e-6)


@pytest.mark.parametrize("n", [1, 7, 64, 4096])
def test_capacity_and_dispatch_resolution_match_the_reference(n, monkeypatch):
    """capacity over the whole grid as the reference counts it; the
    dispatch from the argument, then AREAL_MOE_DISPATCH, then "grouped";
    the expert-parallel path never engages on one device."""
    for kw in (dict(num_experts=128, top_k=8), dict(num_experts=8, top_k=2,
                                                    capacity_factor=0.5)):
        assert tmoe.capacity(n, TMoE(**kw)) == jmoe.capacity(n, JMoE(**kw))
    assert tmoe.capacity(n, TMoE(num_experts=8, top_k=2,
                                 capacity_factor=4.0)) == math.ceil(n)
    monkeypatch.delenv("AREAL_MOE_DISPATCH", raising=False)
    assert tmoe.resolve_dispatch(None) == "grouped"
    monkeypatch.setenv("AREAL_MOE_DISPATCH", "einsum")
    assert tmoe.resolve_dispatch(None) == "einsum"
    assert jmoe.resolve_dispatch(None) == "einsum"
    assert tmoe.resolve_dispatch("grouped") == "grouped"
    with pytest.raises(ValueError, match="unknown MoE dispatch"):
        tmoe.resolve_dispatch("scatter")
    assert not tmoe.ep_eligible(None, TMoE(), n, 1)


def test_router_jitter_in_distribution(monkeypatch):
    """With a generator the router sees x times a factor in [1 - eps,
    1 + eps] (uniform: its mean near 1, not constant); without one it sees
    x itself; the expert inputs are never jittered."""
    eps = 0.2
    kw, x, mask, lp = _case("e8k2_no_renorm", seed=5)
    kw["input_jitter_eps"] = eps
    seen = []
    linear = torch.nn.functional.linear

    def spy(inp, weight, *a):
        if weight.shape == (8, D):  # the router
            seen.append(inp.detach().clone())
        return linear(inp, weight, *a)

    monkeypatch.setattr(tmoe.F, "linear", spy)
    tx = torch.from_numpy(x)
    gen = torch.Generator().manual_seed(0)
    y_j, _ = tmoe.moe_mlp(tx, _port_lp(lp), TMoE(**kw), rng=gen)
    y_c, _ = tmoe.moe_mlp(tx, _port_lp(lp), TMoE(**kw))
    factor = seen[0] / tx.reshape(-1, D)
    assert float(factor.min()) >= 1 - eps - 1e-6
    assert float(factor.max()) <= 1 + eps + 1e-6
    assert abs(float(factor.mean()) - 1.0) < 0.02
    assert float(factor.std()) > 0.05
    assert torch.equal(seen[1], tx.reshape(-1, D))
    y_c2, _ = tmoe.moe_mlp(tx, _port_lp(lp), TMoE(**kw))
    assert torch.equal(y_c, y_c2)
    gen2 = torch.Generator().manual_seed(0)
    y_j2, _ = tmoe.moe_mlp(tx, _port_lp(lp), TMoE(**kw), rng=gen2)
    assert torch.equal(y_j, y_j2)  # a generator's draws are reproducible


def _decode_drop_inputs():
    """Decode rows [64, 1, 32] and one layer of 128 experts of 16 (top-8),
    drawn in this order from numpy's default_rng(0): x N(0, 1), the expert
    stacks N(0, 0.1), the router N(0, 0.5)."""
    E, d, f = 128, 32, 16
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 1, d))
    lp = {"e_gate": rng.normal(0, 0.1, (E, d, f)),
          "e_up": rng.normal(0, 0.1, (E, d, f)),
          "e_down": rng.normal(0, 0.1, (E, f, d)),
          "router": rng.normal(0, 0.5, (d, E))}
    kw = dict(num_experts=E, top_k=8, routed_intermediate_dim=f)
    return kw, x.astype(np.float32), {k: v.astype(np.float32)
                                      for k, v in lp.items()}


@pytest.mark.parametrize("rows,cap,dropped,delta", [
    (1, 1, 0.0, 0.0), (8, 1, 0.171875, 0.0865), (64, 8, 0.021484375, 0.00465)])
def test_reference_decode_drops_depend_on_the_batch(rows, cap, dropped, delta):
    """ROADMAP.md Queue 3 item 11, pinned on both packages: in cache mode
    every row of a decode batch is routed (mask None) under the capacity
    rule, so the last row's output depends on the rows before it. Both
    packages give the same drop fraction and the same difference from
    that row decoded alone (HF's Mixtral and Qwen3-MoE are dropless)."""
    kw, x, lp = _decode_drop_inputs()
    assert tmoe.capacity(rows, TMoE(**kw)) == cap
    jlp = {k: jnp.asarray(v) for k, v in lp.items()}
    jy, jaux = jmoe.moe_mlp(jnp.asarray(x[:rows]), jlp, JMoE(**kw))
    jy1, _ = jmoe.moe_mlp(jnp.asarray(x[rows - 1:rows]), jlp, JMoE(**kw))
    ty, taux = tmoe.moe_mlp(torch.from_numpy(x[:rows]), _port_lp(lp),
                            TMoE(**kw))
    ty1, _ = tmoe.moe_mlp(torch.from_numpy(x[rows - 1:rows]), _port_lp(lp),
                          TMoE(**kw))
    assert float(jaux["dropped_frac"]) == dropped
    assert float(taux["dropped_frac"]) == dropped
    jd = float(jnp.abs(jy[rows - 1] - jy1[0]).max())
    td = float((ty[rows - 1] - ty1[0]).abs().max())
    assert td == pytest.approx(jd, abs=1e-5)
    assert td == pytest.approx(delta, abs=5e-5)
