"""The port's ring attention against the JAX package's.

Twin of ``tests/test_ring_attention.py``. The reference rings over its
virtual 8-device CPU mesh (``s4``, ``d2s2t2``, ``s8``); the port's
one-process ring runs ``n`` = 2, 4 and 8 ranks in this process, and its
P2P ring runs one rank per process over gloo (``s2``, ``s4``, spawned once
per world size for the module). The same numpy-seeded inputs go through
both; everything is float32 on the CPU, where the ring's blocks run K1-K3's
plain versions.
"""

import numpy as np
import pytest
import torch

from areal_tpu_torch.parallel import distributed as D
from areal_tpu_torch.parallel import ring as tring

pytestmark = pytest.mark.ring

SPECS = {2: "d2s2t2", 4: "s4", 8: "s8"}  # the reference's mesh per ring size


def _case(seqlens, Hq, Hkv, D_, row_len, seed=0):
    from areal_tpu.models import packing

    rng = np.random.RandomState(seed)
    layout = packing.plan_packing(seqlens, row_len=row_len, min_rows=2)
    grid = packing.make_grid(layout)
    B, L = layout.shape
    q = (rng.randn(B, L, Hq, D_) * 0.3).astype(np.float32)
    k = (rng.randn(B, L, Hkv, D_) * 0.3).astype(np.float32)
    v = (rng.randn(B, L, Hkv, D_) * 0.3).astype(np.float32)
    return grid, q, k, v


def _ref_ring(q, k, v, seg, n, schedule, grad=False):
    import jax
    import jax.numpy as jnp

    from areal_tpu.parallel import mesh as jmesh
    from areal_tpu.parallel import ring as jring

    mesh = jmesh.make_mesh(jmesh.ParallelSpec.parse(SPECS[n]))
    seg = jnp.asarray(seg)
    fn = jax.jit(lambda q, k, v: jring.ring_attention(
        q, k, v, seg, mesh, schedule=schedule))
    if not grad:
        return np.asarray(fn(q, k, v))
    g = jax.jit(jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) ** 2),
                         argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(x) for x in g]


def _port_ring(q, k, v, seg, n, schedule, grad=False):
    q, k, v = (torch.from_numpy(x).requires_grad_(grad) for x in (q, k, v))
    out = tring.ring_attention(q, k, v, torch.from_numpy(seg), n,
                               schedule=schedule)
    if not grad:
        return out.detach().numpy()
    return [g.numpy() for g in torch.autograd.grad((out ** 2).sum(),
                                                   (q, k, v))]


@pytest.mark.parametrize("schedule", ["zigzag", "naive"])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("seqlens,row_len", [([32], 32), ([20, 9, 3], 32)])
def test_ring_matches_reference(n, seqlens, row_len, schedule):
    """The one-process ring of ``n`` ranks equals the reference's ring on
    its ``sp``-``n`` mesh and its plain packed attention, at the
    reference's 2e-5."""
    from areal_tpu.ops import attention as jattn

    grid, q, k, v = _case(seqlens, Hq=4, Hkv=2, D_=16, row_len=row_len)
    seg = grid["segment_ids"].astype(np.int32)
    pos = grid["positions"]
    plain = np.asarray(jattn.packed_attention(
        q, k, v, seg, seg, q_positions=pos, kv_positions=pos,
        impl="reference"))
    ref = _ref_ring(q, k, v, seg, n, schedule)
    got = _port_ring(q, k, v, seg, n, schedule)
    np.testing.assert_allclose(got, ref, atol=2e-5)
    np.testing.assert_allclose(got, plain, atol=2e-5)


@pytest.mark.parametrize("schedule", ["zigzag", "naive"])
def test_ring_gradients_match_reference(schedule):
    """dq, dk, dv through the ring's K3/K2 tiles (dk/dv returned to the
    block's owner) equal ``jax.grad`` of the reference's ring."""
    grid, q, k, v = _case([16, 12], Hq=2, Hkv=2, D_=8, row_len=32)
    seg = grid["segment_ids"].astype(np.int32)
    ref = _ref_ring(q, k, v, seg, 4, schedule, grad=True)
    got = _port_ring(q, k, v, seg, 4, schedule, grad=True)
    for a, b, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=f"grad {name}")


def test_zigzag_permutation_roundtrip():
    from areal_tpu.parallel import ring as jring

    for T, n in [(16, 2), (32, 4), (64, 8)]:
        fwd = tring.zigzag_permutation(T, n)
        inv = tring.inverse_permutation(fwd)
        np.testing.assert_array_equal(fwd, jring.zigzag_permutation(T, n))
        np.testing.assert_array_equal(inv, jring.inverse_permutation(fwd))
        np.testing.assert_array_equal(fwd[inv], np.arange(T))
        c = T // (2 * n)
        chunk_of = fwd.reshape(n, 2, c) // c
        for r in range(n):
            assert chunk_of[r, 0, 0] == r
            assert chunk_of[r, 1, 0] == 2 * n - 1 - r
        # shard_sequence takes rank r's chunk pair; a one-process ring's
        # layout is undone by unshard_sequence
        x = torch.arange(T)[None].repeat(2, 1)
        for r in range(n):
            got = tring.shard_sequence(x, tring.RingCtx(n, r, group=object()))
            assert got[0].tolist() == fwd[r * 2 * c:(r + 1) * 2 * c].tolist()
        one = tring.RingCtx(n)
        assert torch.equal(tring.unshard_sequence(
            tring.shard_sequence(x, one), one), x)


def test_zigzag_matches_naive_oracle():
    """The balanced schedule and the contiguous oracle agree to float
    round-off on packed multi-document rows, as the reference's do."""
    grid, q, k, v = _case([20, 9, 3], Hq=4, Hkv=2, D_=16, row_len=32)
    seg = grid["segment_ids"].astype(np.int32)
    zz = _port_ring(q, k, v, seg, 4, "zigzag")
    nv = _port_ring(q, k, v, seg, 4, "naive")
    np.testing.assert_allclose(zz, nv, atol=1e-6)
    np.testing.assert_allclose(zz, _ref_ring(q, k, v, seg, 4, "zigzag"),
                               atol=2e-5)


def test_resolve_schedule_env_and_downgrades(monkeypatch):
    from areal_tpu.parallel import ring as jring

    cases = [(None, 32, 4, True), ("zigzag", 30, 4, True),
             ("zigzag", 32, 4, False), ("zigzag", 32, 1, True),
             ("naive", 32, 4, True), ("zigzag", 32, 8, True)]
    for env in ("naive", "zigzag", None):
        if env is None:
            monkeypatch.delenv("AREAL_RING_SCHEDULE", raising=False)
        else:
            monkeypatch.setenv("AREAL_RING_SCHEDULE", env)
        for case in cases:
            assert tring.resolve_schedule(*case) == \
                jring.resolve_schedule(*case), (env, case)
    with pytest.raises(ValueError):
        tring.resolve_schedule("bogus", 32, 4)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_zigzag_skip_ratio_matches_reference(n):
    """The structural counters: the reference traces one rank's body, the
    port runs all n, so the port's areas are n times the reference's;
    the skip ratio is (n+1)/2n in both, and K1 runs n + 2n(n-1) times a
    forward (one causal call a rank where the reference makes two
    half-height blocks)."""
    import jax
    import jax.numpy as jnp

    from areal_tpu.parallel import mesh as jmesh
    from areal_tpu.parallel import ring as jring

    grid, q, k, v = _case([32], Hq=2, Hkv=2, D_=8, row_len=32)
    seg = grid["segment_ids"].astype(np.int32)
    mesh = jmesh.make_mesh(jmesh.ParallelSpec.parse(SPECS[n]))
    jring.reset_ring_counters()
    jax.jit(lambda q, k, v: jring.ring_attention(
        q, k, v, jnp.asarray(seg), mesh, schedule="zigzag"))(q, k, v)
    ref = jring.ring_counters()
    tring.reset_ring_counters()
    _port_ring(q, k, v, seg, n, "zigzag")
    got = tring.ring_counters()
    assert got["naive_area"] == n * ref["naive_area"] > 0
    assert got["executed_area"] == n * ref["executed_area"]
    assert got["block_calls"] == n * (ref["block_calls"] - 1) \
        == n + 2 * n * (n - 1)
    assert tring.ring_skip_ratio() == pytest.approx((n + 1) / (2 * n))
    assert tring.ring_skip_ratio() == pytest.approx(jring.ring_skip_ratio())


def test_rows_with_no_visible_key_stay_zero():
    """Pad rows (segment 0), and rows whose chunk pairs meet only other
    documents in a tile, merge to exact zeros and finite logsumexps, and
    take zero gradients, with no NaN anywhere."""
    grid, q, k, v = _case([7, 5], Hq=4, Hkv=2, D_=16, row_len=32)
    seg = grid["segment_ids"].astype(np.int32)
    assert (seg == 0).any()
    for schedule in ("zigzag", "naive"):
        out = _port_ring(q, k, v, seg, 4, schedule)
        dq, dk, dv = _port_ring(q, k, v, seg, 4, schedule, grad=True)
        for x in (out, dq, dk, dv):
            assert np.isfinite(x).all()
        pad = seg == 0
        assert (out[pad] == 0).all() and (dq[pad] == 0).all()
        assert (dk[pad] == 0).all() and (dv[pad] == 0).all()


def test_transformer_forward_with_sp_mesh():
    """The model's forward through a one-process ring (the zig-zag layout
    applied at its boundary) equals the reference's forward on its
    ``d2s2t2`` mesh, which dispatches to its ring, and its unsharded one."""
    import jax

    from areal_tpu.models import config as jconfig
    from areal_tpu.models import hf as jhf
    from areal_tpu.models import transformer as jtf
    from areal_tpu.parallel import mesh as jmesh
    from areal_tpu.parallel import sharding as jsh
    from areal_tpu_torch.models import config as tconfig
    from areal_tpu_torch.models.convert import params_from_jax
    from areal_tpu_torch.models.transformer import Transformer

    kw = dict(n_layers=2, hidden_dim=32, n_q_heads=4, n_kv_heads=2)
    jcfg = jconfig.tiny_config(**kw)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    B, T = 2, 32
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    positions = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    seg = np.ones((B, T), np.int32)
    ref, _ = jtf.forward(params, jcfg, tokens, positions, segment_ids=seg)
    mesh = jmesh.make_mesh(jmesh.ParallelSpec.parse("d2s2t2"))
    sharded = jsh.shard_params(params, mesh, jcfg)

    def fwd(p, t, pos, s):
        with jsh.activation_sharding(mesh):
            return jtf.forward(p, jcfg, t, pos, segment_ids=s)[0]

    ref_sp = np.asarray(jax.jit(fwd)(sharded, tokens, positions, seg))
    cfg = tconfig.tiny_config(**kw)
    model = Transformer.from_params(cfg, params_from_jax(
        jhf.flatten_pytree(params, as_numpy=True), cfg, device="cpu"))
    t = [torch.from_numpy(a) for a in (tokens, positions, seg)]
    for schedule in ("zigzag", "naive"):
        with torch.no_grad():
            out, _ = model(*t, ring=tring.RingCtx(2, schedule=schedule),
                           return_kv=False)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)
        np.testing.assert_allclose(out.numpy(), ref_sp, atol=2e-4)


# ---------------- the P2P ring, one rank per process ----------------


def _p2p_cases(rank, world, q, k, v, seg):
    """This rank's shard through the P2P ring over the world group, both
    schedules: its output and dq/dk/dv shards."""
    import torch.distributed as dist

    res = {}
    for schedule in ("zigzag", "naive"):
        ctx = tring.RingCtx(world, rank, schedule, group=dist.group.WORLD)
        parts = [tring.shard_sequence(torch.from_numpy(x), ctx).contiguous()
                 .requires_grad_(x.dtype == np.float32)
                 for x in (q, k, v, seg)]
        out = tring.ring_attention_inline(*parts[:3], parts[3], ctx)
        grads = torch.autograd.grad((out ** 2).sum(), parts[:3])
        res[schedule] = [t.detach().numpy() for t in (out, *grads)]
    return res


@pytest.fixture(scope="module")
def p2p_case():
    return _case([20, 9, 3], Hq=4, Hkv=2, D_=16, row_len=32)


@pytest.fixture(scope="module")
def p2p_runs(p2p_case):
    grid, q, k, v = p2p_case
    seg = grid["segment_ids"].astype(np.int32)
    return {n: D.run_ranks(_p2p_cases, n, q, k, v, seg, timeout=180)
            for n in (2, 4)}


@pytest.mark.parametrize("schedule", ["zigzag", "naive"])
@pytest.mark.parametrize("n", [2, 4])
def test_p2p_ring_matches_one_process_ring(p2p_case, p2p_runs, n, schedule):
    """``n`` processes over gloo (batch_isend_irecv rotations, dk/dv hopping
    home) give each rank the shard of the one-process ring's output and
    gradients, and with it the reference's."""
    grid, q, k, v = p2p_case
    seg = grid["segment_ids"].astype(np.int32)
    want = [_port_ring(q, k, v, seg, n, schedule)] + \
        _port_ring(q, k, v, seg, n, schedule, grad=True)
    np.testing.assert_allclose(want[0], _ref_ring(q, k, v, seg, n, schedule),
                               atol=2e-5)
    for rank, res in enumerate(p2p_runs[n]):
        ctx = tring.RingCtx(n, rank, schedule, group=object())
        for got, whole, name in zip(res[schedule], want,
                                    ("out", "dq", "dk", "dv")):
            shard = tring.shard_sequence(torch.from_numpy(whole), ctx)
            np.testing.assert_allclose(got, shard.numpy(), atol=1e-5,
                                       err_msg=f"rank {rank} {name}")
