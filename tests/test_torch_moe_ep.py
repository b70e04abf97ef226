"""Expert parallelism in the port (``models/moe.py dispatch_ep``, the
engine over ``ep``) against the JAX package, in float32 on the CPU.

The layer: the reference's ``moe_mlp(mesh=)`` on its 8 virtual CPU
devices against the port's expert-parallel dispatch on the same numpy
inputs, without drops (capacity factor E/k) and under drops (capacity
factor 1.0): one process holding every source (the reference's row
slices), and gloo ranks each given the reference's slice of the rows (and,
under ``sp``, its zig-zag shard of the columns). A gloo data rank holds its
micro-batch, so its balancing statistics and drops are its own rows': it is
held against the reference's outputs on the whole batch and the
reference's statistics on its slice. Drops equal, ``sum(y²) + aux_total``
within 1e-5 relative, gradients within ``rtol=2e-4, atol=1e-6``, as the
reference's ``test_ep_matches_replicated``.

The engine: one PPO step of a tiny MoE model on meshes with ``ep``, and
with MoE under ``tp``, ``sp`` and ``pp``, equal to one rank's step within
``tests/test_torch_parallel.py``'s limits (no drops: the port's data ranks
hold micro-batches of their own, so its sources differ from the
reference's under drops, ROADMAP.md's accepted differences). Each gloo world
is spawned once for the module and runs every case of its size.
"""

import functools

import numpy as np
import pytest
import torch

from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.models import config as tconfig
from areal_tpu_torch.models import moe as tmoe
from areal_tpu_torch.models.config import MoEConfig as TMoE
from areal_tpu_torch.parallel import distributed as Dist
from areal_tpu_torch.parallel import mesh as pmesh

D, F, E, K, B, T = 16, 32, 4, 2, 8, 8
NO_DROP, DROPS = 8.0, 1.0
ONE_PROCESS = ("e2", "d2e2", "e4t2", "d1f1e2", "s2e2")
LAYER_WORLD2 = ("e2", "s2")
LAYER_WORLD4 = ("d2e2", "e2t2", "s2e2")
ENGINE_WORLD2 = ("e2", "t2", "s2")
ENGINE_WORLD4 = ("d2e2", "e2t2", "p2e2", "s2e2")
_TRANSPOSED = {"router"}  # an nn.Linear weight in the port: [out, in]


def _layer_inputs(seed=7):
    rng = np.random.RandomState(seed)
    lp = {"router": rng.randn(D, E) * 0.5, "e_gate": rng.randn(E, D, F) * 0.1,
          "e_up": rng.randn(E, D, F) * 0.1, "e_down": rng.randn(E, F, D) * 0.1}
    lp = {k: v.astype(np.float32) for k, v in lp.items()}
    return lp, rng.randn(B, T, D).astype(np.float32)


def _moe_kw(cf):
    return dict(num_experts=E, top_k=K, capacity_factor=cf,
                aux_loss_coeff=1e-2, z_loss_coeff=1e-3)


@functools.lru_cache(maxsize=None)
def _reference(spec, cf):
    """The reference's ``moe_mlp(mesh=)``, jitted: (loss, dropped_frac,
    grads)."""
    import jax
    import jax.numpy as jnp

    from areal_tpu.models import moe as jmoe
    from areal_tpu.models.config import MoEConfig as JMoE
    from areal_tpu.parallel import mesh as jmesh

    lp, x = _layer_inputs()
    mesh = jmesh.make_mesh(jmesh.ParallelSpec.parse(spec))
    moe = JMoE(**_moe_kw(cf))

    def loss(p):
        y, aux = jmoe.moe_mlp(jnp.asarray(x), p, moe, mesh=mesh)
        return jnp.sum(y * y) + aux["aux_total"], aux

    (val, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in lp.items()})
    return (float(val), float(aux["dropped_frac"]),
            {k: np.asarray(g) for k, g in grads.items()})


def _assert_layer(got, want):
    loss, dropped, grads = got
    w_loss, w_dropped, w_grads = want
    assert dropped == w_dropped
    assert loss == pytest.approx(w_loss, rel=1e-5)
    for k in w_grads:
        np.testing.assert_allclose(grads[k], w_grads[k], rtol=2e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("cf", [NO_DROP, DROPS])
@pytest.mark.parametrize("spec", ONE_PROCESS)
def test_one_process_ep_matches_reference(spec, cf):
    """One process holds every source: the micro-batch's rows split into the
    reference's ``dp·fsdp·ep`` row blocks (and, under ``sp``, a one-process
    ring's natural-order column chunks), the exchange a re-indexing."""
    from areal_tpu_torch.parallel import ring as ring_mod

    s = pmesh.ParallelSpec.parse(spec)
    lp, x = _layer_inputs()
    leaves = {k: torch.tensor(v.T.copy() if k in _TRANSPOSED else v,
                              requires_grad=True) for k, v in lp.items()}
    ring = ring_mod.RingCtx(n=s.sp) if s.sp > 1 else None
    xt = torch.from_numpy(x)
    if ring is not None:
        xt = ring_mod.shard_sequence(xt, ring)
    y, aux = tmoe.moe_mlp(xt, leaves, TMoE(**_moe_kw(cf)),
                          ep=tmoe.ExpertCtx(ep=s.data_degree), ring=ring)
    loss = (y * y).sum() + aux["aux_total"]
    loss.backward()
    got = (float(loss), float(aux["dropped_frac"]),
           {k: (t.grad.numpy().T if k in _TRANSPOSED else t.grad.numpy())
            for k, t in leaves.items()})
    want = _reference(spec, cf)
    if cf == DROPS:
        assert want[1] > 0, "the dropping case dropped nothing"
    _assert_layer(got, want)


def test_one_process_ep_matches_grouped_without_drops():
    """In the no-drop regime the exchange changes nothing: one-process EP
    equals the grouped dispatch on the whole micro-batch."""
    lp, x = _layer_inputs(11)
    tlp = {k: torch.from_numpy(v.T.copy() if k in _TRANSPOSED else v)
           for k, v in lp.items()}
    moe = TMoE(**_moe_kw(NO_DROP))
    want, wa = tmoe.moe_mlp(torch.from_numpy(x), tlp, moe)
    for ep in (2, 4, 8):
        got, ga = tmoe.moe_mlp(torch.from_numpy(x), tlp, moe,
                               ep=tmoe.ExpertCtx(ep=ep))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        assert float(ga["dropped_frac"]) == 0.0
        torch.testing.assert_close(ga["aux_total"], wa["aux_total"])


# ---------------- the gloo ranks ----------------

def _groups(spec, rank):
    """This rank's groups on ``spec``'s mesh: the mesh, the ``ep`` group and
    the ``sp`` ring."""
    from areal_tpu_torch.parallel import ring as ring_mod
    from areal_tpu_torch.parallel import sharding as psh

    s = pmesh.ParallelSpec.parse(spec)
    mesh = pmesh.make_mesh(s)
    coords = {a: psh.mesh_coord(mesh, a) for a in pmesh.AXIS_ORDER}
    ep = tmoe.ExpertCtx(ep=s.ep, rank=coords["ep"], group=mesh.get_group("ep")
                        ) if s.ep > 1 else None
    ring = ring_mod.RingCtx(n=s.sp, my=coords["sp"],
                            group=mesh.get_group("sp")) if s.sp > 1 else None
    return s, mesh, coords, ep, ring


def _data_rank(s, c):
    """Which block of the micro-batch's rows a rank at coordinates ``c``
    holds (the reference's row slices)."""
    return (c["dp"] * s.fsdp + c["fsdp"]) * s.ep + c["ep"]


def _layer_rank(rank, spec, cf):
    """This rank's share of the layer: its rows (and zig-zag columns), its
    experts and their tp columns; returns its sum of y² (on its tp==0
    rank), its aux_total and drop fraction (its data rank's own tokens')
    and its local gradients."""
    from areal_tpu_torch.parallel import ring as ring_mod
    from areal_tpu_torch.parallel import sharding as psh

    s, mesh, c, ep, ring = _groups(spec, rank)
    lp, x = _layer_inputs()
    d = _data_rank(s, c)
    rows = B // s.data_degree
    xt = torch.from_numpy(x[d * rows:(d + 1) * rows])
    if ring is not None:
        xt = ring_mod.shard_sequence(xt, ring)
    El, Ft = E // s.ep, F // s.tp
    e, t = slice(c["ep"] * El, (c["ep"] + 1) * El), slice(c["tp"] * Ft,
                                                         (c["tp"] + 1) * Ft)
    local = {"router": lp["router"].T.copy(), "e_gate": lp["e_gate"][e, :, t],
             "e_up": lp["e_up"][e, :, t], "e_down": lp["e_down"][e, t, :]}
    leaves = {k: torch.tensor(np.ascontiguousarray(v), requires_grad=True)
              for k, v in local.items()}
    with psh.activation_sharding(mesh):
        y, aux = tmoe.moe_mlp(xt, leaves, TMoE(**_moe_kw(cf)), ep=ep,
                              ring=ring)
        ((y * y).sum() + aux["aux_total"]).backward()
    first = c["tp"] == 0
    return {"coords": c, "loss": float((y * y).sum()) if first else 0.0,
            "aux_total": float(aux["aux_total"]),
            "dropped": float(aux["dropped_frac"]),
            "grads": {k: v.grad.numpy() for k, v in leaves.items()}}


def _assemble(spec, ranks):
    """The ranks' shares → (loss, kept assignments, whole gradients): the
    router's summed over the token-holding ranks, each expert shard summed
    over its data replicas and put in place; each data rank's aux_total
    counted once, its kept count read back from its drop fraction."""
    s = pmesh.ParallelSpec.parse(spec)
    El, Ft = E // s.ep, F // s.tp
    grads = {"router": np.zeros((E, D), np.float32),
             "e_gate": np.zeros((E, D, F), np.float32),
             "e_up": np.zeros((E, D, F), np.float32),
             "e_down": np.zeros((E, F, D), np.float32)}
    per_data = {}
    for r in ranks:
        c, g = r["coords"], r["grads"]
        e, t = slice(c["ep"] * El, (c["ep"] + 1) * El), slice(
            c["tp"] * Ft, (c["tp"] + 1) * Ft)
        if c["tp"] == 0:
            grads["router"] += g["router"]
        grads["e_gate"][e, :, t] += g["e_gate"]
        grads["e_up"][e, :, t] += g["e_up"]
        grads["e_down"][e, t, :] += g["e_down"]
        per_data.setdefault(_data_rank(s, c), []).append(
            (r["aux_total"], r["dropped"]))
    # the tp and sp ranks of one data rank agree on its statistics
    for v in per_data.values():
        auxes, dropped = {a for a, _ in v}, {d for _, d in v}
        assert len(dropped) == 1, dropped
        assert max(auxes) - min(auxes) <= 1e-7 * max(auxes), auxes
    stats = [v[0] for v in per_data.values()]
    n_tokens = B // s.data_degree * T * K
    kept = sum(round((1.0 - dropped) * n_tokens) for _, dropped in stats)
    loss = sum(r["loss"] for r in ranks) + sum(a for a, _ in stats)
    grads["router"] = grads["router"].T
    return loss, kept, grads


@functools.lru_cache(maxsize=None)
def _reference_per_data_rank(spec, cf):
    """The reference under the port's multi-rank sources: each data rank
    holds its micro-batch, so its balancing statistics and drops are its
    own rows'. The outputs come from the reference's ``moe_mlp(mesh=)``
    on the whole batch (a source's outputs depend on its tokens alone);
    each data rank's aux_total from the reference's ``moe_mlp`` on its row
    slice. Returns (sum(y²) + Σ aux_total, kept assignments, grads)."""
    import jax
    import jax.numpy as jnp

    from areal_tpu.models import moe as jmoe
    from areal_tpu.models.config import MoEConfig as JMoE
    from areal_tpu.parallel import mesh as jmesh

    lp, x = _layer_inputs()
    s = jmesh.ParallelSpec.parse(spec)
    mesh = jmesh.make_mesh(s)
    moe = JMoE(**_moe_kw(cf))
    rows = B // (s.dp * s.fsdp * s.ep)

    def loss(p):
        y, aux = jmoe.moe_mlp(jnp.asarray(x), p, moe, mesh=mesh)
        total = jnp.sum(y * y)
        for d in range(B // rows):
            _, a = jmoe.moe_mlp(jnp.asarray(x[d * rows:(d + 1) * rows]), p,
                                moe)
            total = total + a["aux_total"]
        return total, aux

    (val, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in lp.items()})
    kept = round((1.0 - float(aux["dropped_frac"])) * B * T * K)
    return float(val), kept, {k: np.asarray(g) for k, g in grads.items()}


# ---------------- the engine ----------------

CFG = dict(n_layers=2, hidden_dim=32, n_q_heads=4, n_kv_heads=2,
           vocab_size=128, use_attention_bias=True,
           moe=dict(num_experts=4, top_k=2, routed_intermediate_dim=16,
                    capacity_factor=2.0))  # E/k: no drops


def _batch(n_seq=24, seed=5):
    rng = np.random.RandomState(seed)
    plens, glens = rng.randint(2, 6, n_seq), rng.randint(4, 12, n_seq)
    seqlens = (plens + glens).astype(int)
    total = int(seqlens.sum())
    pmask = np.concatenate([np.r_[np.ones(p, np.int32), np.zeros(g, np.int32)]
                            for p, g in zip(plens, glens)])
    data = {
        "packed_input_ids": rng.randint(2, CFG["vocab_size"], total
                                        ).astype(np.int32),
        "prompt_mask": pmask,
        "packed_logprobs": np.where(pmask == 0, -rng.rand(total), 0.0
                                    ).astype(np.float32),
        "rewards": rng.randn(n_seq).astype(np.float32),
        "seq_no_eos_mask": (rng.rand(n_seq) < 0.3).astype(np.float32),
    }
    return SequenceSample.from_default(ids=[f"s{i}" for i in range(n_seq)],
                                       data=data, seqlens=seqlens.tolist())


def _engine(spec, train=True, compute_dtype="float32", ep=1, pp=1):
    from areal_tpu_torch.api.train_config import OptimizerConfig
    from areal_tpu_torch.backend.torch_train import TorchTrainEngine
    from areal_tpu_torch.models.transformer import init_params

    cfg = tconfig.tiny_config(**CFG)
    mesh = None if spec is None else pmesh.make_mesh(
        pmesh.ParallelSpec.parse(spec))
    eng = TorchTrainEngine(
        cfg, init_params(cfg, 3, device="cpu"),
        OptimizerConfig(lr=1e-3, lr_scheduler_type="constant")
        if train else None, device="cpu", compute_dtype=compute_dtype,
        length_bucket=16, rows_bucket=4, seqs_bucket=4, mesh=mesh)
    if ep > 1 or pp > 1:  # one process: every source, every stage
        eng._spec = pmesh.ParallelSpec(ep=ep, pp=pp)
    return eng


def _step(eng, n_seq=24, max_tokens=96):
    """One PPO step (three micro-batches of three rows by default): stats,
    gauges, the masters after."""
    from areal_tpu_torch.algorithms import ppo as tppo
    from areal_tpu_torch.backend import torch_train as ttrain

    hp = tppo.PPOHyperparameters(adv_norm=False, kl_ctl=0.0,
                                 disable_value=True)
    gauges = {}
    set_gauge = ttrain.telemetry.set_gauge
    ttrain.telemetry.set_gauge = lambda k, v: gauges.__setitem__(k, v)
    try:
        ub = eng.upload_uniform(_batch(n_seq),
                                MicroBatchSpec(max_tokens_per_mb=max_tokens))
    finally:
        ttrain.telemetry.set_gauge = set_gauge
    eng.run_prep(ub, tppo.make_advantage_prep(hp),
                 scalars={"kl_coef": hp.kl_ctl})
    stats = eng.train_uniform(
        ub, tppo.PPOActorInterface(hp)._loss_fn,
        lambda mb: float(tppo._action_token_weight(mb)))
    return stats, gauges, {n: t.numpy() for n, t in eng.full_params().items()}


def _published(rank, tmp):
    """What an ``e2`` trainer publishes and checkpoints before any step:
    the compute-dtype weights (every transport's payload) and an HF
    checkpoint written by rank 0."""
    from areal_tpu_torch.models import hf

    eng = _engine("e2", compute_dtype="bfloat16")
    pub = {n: t.float().numpy() for n, t in
           eng.full_params(eng.compute_dtype).items()}
    params = eng.full_params()
    if rank == 0:
        hf.save_hf_checkpoint(params, eng.cfg, f"{tmp}/e2_hf")
    return pub


def _rank_cases(rank, world, layer_specs, engine_specs, tmp):
    res = {"layer": {}, "engine": {}}
    for spec in layer_specs:
        for cf in (NO_DROP, DROPS):
            res["layer"][spec, cf] = _layer_rank(rank, spec, cf)
    for spec in engine_specs:
        stats, gauges, masters = _step(_engine(spec))
        res["engine"][spec] = (stats, gauges,
                               masters if rank == 0 else None)
    if world == 2:
        res["published"] = _published(rank, tmp)
    return res


@pytest.fixture(scope="module")
def hf_tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ep_hf"))


@pytest.fixture(scope="module")
def world2(hf_tmp):
    return Dist.run_ranks(_rank_cases, 2, LAYER_WORLD2, ENGINE_WORLD2,
                          hf_tmp, timeout=240)


@pytest.fixture(scope="module")
def world4(hf_tmp):
    return Dist.run_ranks(_rank_cases, 4, LAYER_WORLD4, ENGINE_WORLD4,
                          hf_tmp, timeout=240)


@pytest.fixture(scope="module")
def one_rank():
    """One rank's step; with ``pp``, the same stages in one process (the
    pipeline's micro-batches take their own balancing statistics, as the
    reference's do)."""
    return {pp: _step(_engine(None, pp=pp)) for pp in (1, 2)}


def _world(request, spec, specs2):
    return request.getfixturevalue("world2" if spec in specs2 else "world4")


@pytest.mark.parametrize("cf", [NO_DROP, DROPS])
@pytest.mark.parametrize("spec", LAYER_WORLD2 + LAYER_WORLD4)
def test_gloo_ep_layer_matches_reference(request, spec, cf):
    """Gloo ranks, each with the reference's slice of the rows (its zig-zag
    shard of the columns under ``sp``) and its owner's experts (their tp
    columns): the exchange over the ``ep`` group, each data rank's
    statistics and drop counts over its own rows (summed over the ``sp``
    ring). The kept assignments summed over the data ranks equal the
    reference's exactly."""
    ranks = _world(request, spec, LAYER_WORLD2)
    loss, kept, grads = _assemble(spec, [r["layer"][spec, cf] for r in ranks])
    w_loss, w_kept, w_grads = _reference_per_data_rank(spec, cf)
    if cf == DROPS:
        assert w_kept < B * T * K, "the dropping case dropped nothing"
    assert kept == w_kept
    assert loss == pytest.approx(w_loss, rel=1e-5)
    for k in w_grads:
        np.testing.assert_allclose(grads[k], w_grads[k], rtol=2e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("spec", ENGINE_WORLD2 + ENGINE_WORLD4)
def test_moe_engine_step_matches_one_rank(request, one_rank, spec):
    """A PPO step of the MoE model on the mesh equals one rank's: loss,
    grad norm and every moe_* stat within 1e-5, masters within 1e-6; the
    expert-parallel gauge reads 1 where the dispatch runs over ``ep``, 0
    under ``pp`` and without ``ep``."""
    s = pmesh.ParallelSpec.parse(spec)
    want, want_gauges, want_masters = one_rank[s.pp]
    ranks = _world(request, spec, ENGINE_WORLD2)
    stats, _, masters = ranks[0]["engine"][spec]
    keys = ["loss", "grad_norm"] + [k for k in want if k.startswith("moe_")]
    assert "moe_aux_total" in keys
    for key in keys:
        assert stats[key] == pytest.approx(want[key], rel=1e-5, abs=1e-7), key
    assert set(masters) == set(want_masters)
    for n in want_masters:
        np.testing.assert_allclose(masters[n], want_masters[n], atol=1e-6,
                                   err_msg=n)
    for r in ranks:
        gauges = r["engine"][spec][1]
        assert gauges["train/moe_ep_engaged"] == float(s.ep > 1
                                                       and s.pp == 1)
    assert want_gauges["train/moe_ep_engaged"] == 0.0


def test_one_process_ep_engine_step_matches_plain():
    """The card's way: one process with ``_spec.ep = 2`` runs every source
    and owner (micro-batches of four rows, two a source); its step equals
    the plain engine's and the gauge reads 1."""
    want, _, want_masters = _step(_engine(None), n_seq=32, max_tokens=128)
    stats, gauges, masters = _step(_engine(None, ep=2), n_seq=32,
                                   max_tokens=128)
    for key in ["loss", "grad_norm"] + [k for k in want
                                        if k.startswith("moe_")]:
        assert stats[key] == pytest.approx(want[key], rel=1e-5, abs=1e-7), key
    for n in want_masters:
        np.testing.assert_allclose(masters[n], want_masters[n], atol=1e-6,
                                   err_msg=n)
    assert gauges["train/moe_ep_engaged"] == 1.0


def test_e2_publication_and_checkpoint_are_whole_experts(world2, hf_tmp,
                                                        tmp_path):
    """An ``e2`` trainer's publication (the compute-dtype weights every
    transport sends) and its HF checkpoint equal the one-rank trainer's,
    bit for bit: every expert gathered whole."""
    from areal_tpu_torch.base import safetensors_io as sio
    from areal_tpu_torch.models import hf

    eng = _engine(None, compute_dtype="bfloat16")
    want = {n: t.float().numpy() for n, t in
            eng.full_params(eng.compute_dtype).items()}
    for r in world2:
        got = r["published"]
        assert set(got) == set(want)
        for n in want:
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    hf.save_hf_checkpoint(eng.full_params(), eng.cfg, str(tmp_path / "hf"))

    def tensors(d):
        import glob
        import os

        out = {}
        for f in sorted(glob.glob(os.path.join(d, "*.safetensors"))):
            out.update(sio.load_file(f))
        return out

    got, want_hf = tensors(f"{hf_tmp}/e2_hf"), tensors(str(tmp_path / "hf"))
    assert set(got) == set(want_hf) and any(".experts." in n for n in got)
    for n in want_hf:
        assert torch.equal(got[n], want_hf[n]), n


# ---------------- the gate and the configuration rules ----------------

def test_ep_eligible_gates():
    """The reference's answers, on a ``ParallelSpec`` (the port's
    ``DeviceMesh`` gives the same degrees)."""
    moe = TMoE(num_experts=4, top_k=2)
    spec = pmesh.ParallelSpec(ep=2)
    assert tmoe.ep_eligible(spec, moe, 4, 8)
    assert not tmoe.ep_eligible(spec, TMoE(num_experts=3, top_k=1), 4, 8)
    assert not tmoe.ep_eligible(spec, moe, 3, 8)
    assert not tmoe.ep_eligible(None, moe, 4, 8)
    assert not tmoe.ep_eligible(spec, None, 4, 8)
    assert not tmoe.ep_eligible(pmesh.ParallelSpec(dp=2), moe, 4, 8)
    assert not tmoe.ep_eligible(pmesh.ParallelSpec(ep=2, sp=2), moe, 4, 7)
    from areal_tpu.models import moe as jmoe

    assert jmoe.ep_eligible(None, moe, 4, 8) is False


def test_validate_config_rejects_bad_ep():
    from areal_tpu_torch.api.cli_args import ConfigError, validate_config

    class _NS:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    def cfg(alloc, moe=None):
        tiny = {"moe": moe} if moe is not None else {}
        return _NS(mode="local", allocation_mode=alloc, n_nodes=1,
                   n_gpus_per_node=8, actor=_NS(tiny=tiny))

    with pytest.raises(ConfigError, match="ep"):
        validate_config(cfg("gen.e2+train.d2",
                            moe={"num_experts": 4, "top_k": 2}))
    with pytest.raises(ConfigError, match="dense"):
        validate_config(cfg("e2"))
    with pytest.raises(ConfigError, match="num_experts"):
        validate_config(cfg("e2", moe={"num_experts": 3, "top_k": 1}))
    with pytest.raises(ConfigError, match="capacity_factor"):
        validate_config(cfg("d2", moe={"num_experts": 4, "top_k": 2,
                                       "capacity_factor": 0.0}))
    validate_config(cfg("e2", moe={"num_experts": 4, "top_k": 2}))
    validate_config(cfg("d2f2t2"))


def test_ep_enters_the_allocation():
    """``ep`` is a trainer axis like any other: an ``e2`` allocation
    resolves to a world of two ranks."""
    from areal_tpu_torch.api.cli_args import BaseExperimentConfig
    from areal_tpu_torch.experiments import common as C

    cfg = BaseExperimentConfig(backend="cpu", allocation_mode="d2e2",
                               n_gpus_per_node=4)
    am = C.resolve_allocation(cfg)
    assert C.trainer_world(am) == 4 and am.global_spec.ep == 2


def test_expert_placements_keep_the_ep_shard_where_ep_runs():
    from torch.distributed.tensor import Partial, Replicate, Shard

    from areal_tpu_torch.parallel import sharding as psh

    cfg = tconfig.tiny_config(**CFG)
    lay = psh.param_layouts(cfg)
    name = "layers.0.e_gate"
    ep = pmesh.AXIS_ORDER.index("ep")
    assert psh.compute_placements(name, lay[name])[ep] == Replicate()
    assert psh.compute_placements(name, lay[name], True)[ep] == Shard(0)
    assert psh.grad_placements(name, lay[name], cfg, 1)[ep] == Partial()
    assert psh.grad_placements(name, lay[name], cfg, 1, True)[ep] == Shard(0)
    router = "layers.0.router.weight"
    assert psh.compute_placements(router, lay[router], True)[ep] == Replicate()
