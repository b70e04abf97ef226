"""The port's meshes and parameter sharding against the JAX package.

Twin of ``tests/test_parallel.py``. The reference shards on a virtual
8-device CPU mesh inside one process; the port runs one process per rank,
so each world size is spawned once for the module (gloo over localhost,
``parallel/distributed.py run_ranks``) and runs every case of that size;
the tests below read its results. Weights come from one numpy seed, in
the reference's layout, through ``convert.params_from_jax``; everything is
float32 on the CPU.
"""

import numpy as np
import pytest
import torch

from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.models import config as tconfig
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.parallel import distributed as D
from areal_tpu_torch.parallel import mesh as pmesh
from areal_tpu_torch.parallel import sharding as psh

CFG = dict(n_layers=2, hidden_dim=32, n_q_heads=4, n_kv_heads=2,
           vocab_size=128, use_attention_bias=True)
WORLD2 = ("f2", "t2")
WORLD4 = ("d2f2", "f2t2", "t4")
B, T = 4, 16


def _flat(seed=0):
    """Reference-layout weights from a numpy seed (norm scales around 1)."""
    import jax

    from areal_tpu.models import config as jconfig
    from areal_tpu.models import hf as jhf
    from areal_tpu.models import transformer as jtf

    jcfg = jconfig.tiny_config(**CFG)
    shapes = jhf.flatten_pytree(jax.eval_shape(
        lambda: jtf.init_params(jcfg, jax.random.PRNGKey(0))))
    rng = np.random.RandomState(seed)
    out = {}
    for key, a in shapes.items():
        base = 1.0 if key.split("/")[-1] in ("ln1", "ln2", "final_ln") else 0.0
        out[key] = (base + 0.1 * rng.randn(*a.shape)).astype(np.float32)
    return out


def _inputs(seed=1):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, CFG["vocab_size"], (B, T)).astype(np.int32)
    positions = np.concatenate([np.arange(10), np.arange(T - 10)])
    positions = np.tile(positions.astype(np.int32), (B, 1))
    seg = np.concatenate([np.full(10, 1), np.full(T - 10, 2)])
    seg = np.tile(seg.astype(np.int32), (B, 1))
    seg[-1, -3:] = 0  # a pad tail
    return tokens, positions, seg


def _batch(n_seq=24, seed=5):
    """A PPO actor batch in the port's types."""
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
        "packed_ref_logprobs": np.where(pmask == 0, -rng.rand(total), 0.0
                                        ).astype(np.float32),
    }
    return SequenceSample.from_default(ids=[f"s{i}" for i in range(n_seq)],
                                       data=data, seqlens=seqlens.tolist())


def _engine(flat, spec, train):
    from areal_tpu_torch.api.train_config import OptimizerConfig
    from areal_tpu_torch.backend.torch_train import TorchTrainEngine

    cfg = tconfig.tiny_config(**CFG)
    mesh = None if spec is None else pmesh.make_mesh(
        pmesh.ParallelSpec.parse(spec))
    return TorchTrainEngine(
        cfg, params_from_jax(flat, cfg, device="cpu"),
        OptimizerConfig(lr=1e-3, lr_scheduler_type="constant")
        if train else None, device="cpu", compute_dtype="float32",
        length_bucket=16, rows_bucket=2, seqs_bucket=4, mesh=mesh)


def _logits(eng, inputs):
    tokens, positions, seg = (torch.from_numpy(a) for a in inputs)
    with torch.no_grad(), eng._mesh_ctx():
        out = eng._hidden_or_logits(
            eng._cast(), {"tokens": tokens, "positions": positions,
                          "segment_ids": seg}, return_hidden=False,
            remat=False)
    return out.numpy()


def _grads(eng):
    """The masters' gradients of one PPO actor loss over every micro-batch
    of :func:`_batch`, whole."""
    from areal_tpu_torch.algorithms import ppo as tppo

    hp = tppo.PPOHyperparameters(adv_norm=False, kl_ctl=0.1,
                                 disable_value=True)
    ub = eng.upload_uniform(_batch(), MicroBatchSpec(max_tokens_per_mb=32))
    eng.run_prep(ub, tppo.make_advantage_prep(hp),
                 scalars={"kl_coef": hp.kl_ctl})
    idxs = list(range(ub.n_mbs))
    weights = [float(tppo._action_token_weight(ub.mbs[i])) for i in idxs]
    eng.accumulate_grads(ub, tppo.PPOActorInterface(hp)._loss_fn, idxs,
                         weights)
    return ({name: eng._whole(name, loc.grad).numpy()
             for name, loc in zip(eng.params, eng._local_params())},
            ub.n_mbs)


def _rank_cases(rank, world, flat, inputs, specs):
    """Every case of one world size, on one rank."""
    res = {"mesh": {}, "forward": {}, "grads": {}, "later": {}}
    for spec in specs:
        m = pmesh.make_mesh(pmesh.ParallelSpec.parse(spec))
        res["mesh"][spec] = (tuple(m.mesh_dim_names), tuple(m.shape),
                             m.device_type)
        res["forward"][spec] = _logits(_engine(flat, spec, train=False),
                                       inputs)
        if rank == 0:
            res["grads"][spec] = _grads(_engine(flat, spec, train=True))
        else:
            _grads(_engine(flat, spec, train=True))
    if world == 2:
        from areal_tpu_torch.backend.torch_train import TorchTrainEngine
        from areal_tpu_torch.models.transformer import init_params

        cfg = tconfig.tiny_config(**CFG)
        for axis in ("sp", "pp", "ep"):
            try:
                m = pmesh.make_mesh(pmesh.ParallelSpec(**{axis: 2}))
                TorchTrainEngine(cfg, params_from_jax(flat, cfg,
                                                      device="cpu"),
                                 device="cpu", mesh=m)
                res["later"][axis] = None
            except NotImplementedError as e:
                res["later"][axis] = str(e)
        try:
            pmesh.make_mesh(pmesh.ParallelSpec(tp=4))
            res["later"]["world"] = None
        except ValueError as e:
            res["later"]["world"] = str(e)
        moe = tconfig.tiny_config(**dict(CFG, moe=dict(
            num_experts=4, top_k=2, routed_intermediate_dim=16)))
        try:
            TorchTrainEngine(moe, init_params(moe, 0, device="cpu"),
                             device="cpu",
                             mesh=pmesh.make_mesh(pmesh.ParallelSpec(tp=2)))
            res["later"]["moe_tp"] = None
        except NotImplementedError as e:
            res["later"]["moe_tp"] = str(e)
    return res


@pytest.fixture(scope="module")
def flat():
    return _flat()


@pytest.fixture(scope="module")
def reference(flat):
    """The JAX package's single-device logits, and the port's grads on one
    device (no mesh)."""
    import jax

    from areal_tpu.models import config as jconfig
    from areal_tpu.models import hf as jhf
    from areal_tpu.models import transformer as jtf

    jcfg = jconfig.tiny_config(**CFG)
    tokens, positions, seg = _inputs()
    logits, _ = jtf.forward(jhf.unflatten_pytree(
        {k: jax.numpy.asarray(v) for k, v in flat.items()}), jcfg, tokens,
        positions, segment_ids=seg)
    return {"logits": np.asarray(logits),
            "grads": _grads(_engine(flat, None, train=True))[0]}


def _run(world, specs, flat):
    return D.run_ranks(_rank_cases, world, flat, _inputs(), specs,
                       timeout=240)


@pytest.fixture(scope="module")
def world2(flat):
    return _run(2, WORLD2, flat)


@pytest.fixture(scope="module")
def world4(flat):
    return _run(4, WORLD4, flat)


def _world(request, spec):
    return request.getfixturevalue("world2" if spec in WORLD2 else "world4")


# ---------------- specs, meshes, allocations ----------------


def test_parallel_spec_parse_and_mesh_shape():
    s = pmesh.ParallelSpec.parse("d2f2s2t1")
    assert (s.dp, s.fsdp, s.sp, s.tp) == (2, 2, 2, 1)
    assert s.mesh_shape() == (2, 2, 1, 1, 2, 1)
    assert s.data_degree == 4 and s.world_size == 8
    assert pmesh.ParallelSpec.parse("d4p2m2").tp == 2
    assert pmesh.ParallelSpec(ep=2, dp=2).data_degree == 4
    with pytest.raises(ValueError):
        pmesh.ParallelSpec.parse("d2d4")
    assert pmesh.AXIS_ORDER == ("dp", "fsdp", "ep", "pp", "sp", "tp")
    assert pmesh.DATA_AXES == ("dp", "fsdp", "ep")


def test_allocation_mode_decoupled():
    assert not pmesh.AllocationMode.parse("d2t2").decoupled
    am = pmesh.AllocationMode.parse("gen.d4+train.d2t2")
    assert am.decoupled and am.gen_spec.dp == 4 and am.global_spec.tp == 2
    am = pmesh.AllocationMode.parse("actor_gen:d4t2,actor_train:f4t2")
    assert am.decoupled and am.global_spec.fsdp == 4


def test_spec_for_role_resolution():
    from areal_tpu_torch.experiments import common as C

    am = pmesh.AllocationMode.parse("actor_train:f2t2,ref_inf:d2")
    assert str(C.spec_for_role(am, "actor")) == "f2t2"
    assert str(C.spec_for_role(am, "ref")) == "d2"
    assert str(C.spec_for_role(am, "critic")) == "f2t2"
    am = pmesh.AllocationMode.parse("actor_inf:d4,actor_train:f2t2")
    assert str(C.spec_for_role(am, "actor")) == "f2t2"


@pytest.mark.parametrize("spec", WORLD2 + WORLD4)
def test_make_mesh_axes(request, spec):
    names, shape, dev = _world(request, spec)[0]["mesh"][spec]
    assert names == pmesh.AXIS_ORDER and dev == "cpu"
    assert shape == pmesh.ParallelSpec.parse(spec).mesh_shape()


def test_make_mesh_refuses_another_world(world2):
    assert "needs a world of 4 ranks, the process group has 2" in \
        world2[0]["later"]["world"]


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="needs a process group"):
        pmesh.make_mesh(pmesh.ParallelSpec())


# ---------------- the sharded forward and grads ----------------


@pytest.mark.parametrize("spec", WORLD2 + WORLD4)
def test_sharded_forward_matches_single_device(request, reference, spec):
    """Every rank's logits equal the JAX package's single-device forward
    (t4: 2 kv heads for 4 ranks, so wk/wv stay whole on every rank)."""
    for rank_res in _world(request, spec):
        np.testing.assert_allclose(rank_res["forward"][spec],
                                   reference["logits"], atol=2e-4)


@pytest.mark.parametrize("spec", WORLD2 + WORLD4)
def test_sharded_grads_match_one_device(request, reference, spec):
    """The masters' gradients of a PPO loss over several micro-batches (the
    data ranks split them), reduced into their placements and gathered,
    equal one device's."""
    grads, n_mbs = _world(request, spec)[0]["grads"][spec]
    assert n_mbs > 2
    want = reference["grads"]
    assert set(grads) == set(want)
    for name in want:
        assert np.isfinite(grads[name]).all(), name
        np.testing.assert_allclose(grads[name], want[name], atol=1e-5,
                                   rtol=1e-5, err_msg=name)


# ---------------- the placements table ----------------

FAMILIES = {
    "qwen2": dict(use_attention_bias=True),
    "gpt2": dict(norm_type="layer", pos_embedding="learned",
                 mlp_type="plain", use_attention_bias=True,
                 use_attn_output_bias=True, max_position_embeddings=64,
                 tie_word_embeddings=True),
    "gemma": dict(n_kv_heads=1, hidden_act="gelu_tanh",
                  scale_embeddings=True, tie_word_embeddings=True),
    "qwen3": dict(use_qk_norm=True),
    "moe": dict(use_qk_norm=True, moe=dict(
        num_experts=8, top_k=2, routed_intermediate_dim=16,
        shared_intermediate_dim=16)),
    "critic": dict(is_critic=True),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_placements_match_reference_partition_specs(family):
    """The port's layout of every parameter is the reference's
    ``PartitionSpec`` carried through ``convert.reference_leaf_map``: the
    stacked layer axis (``pp``) dropped, the dims of a transposed matrix
    swapped."""
    from jax.sharding import PartitionSpec

    from areal_tpu.models import config as jconfig
    from areal_tpu.parallel import sharding as jsh
    from areal_tpu_torch.models.convert import reference_leaf_map

    kw = FAMILIES[family]
    specs = jsh.param_partition_specs(jconfig.tiny_config(**kw))
    flat = {}
    for key, spec in specs.items():
        if key == "layers":
            flat.update({f"layers/{k}": v for k, v in spec.items()})
        else:
            flat[key] = spec
    cfg = tconfig.tiny_config(**kw)
    leaf_map = reference_leaf_map(cfg)
    assert set(leaf_map) == set(flat)
    layouts = psh.param_layouts(cfg)
    assert set(layouts) == {n for v in leaf_map.values() for n, _ in v}
    for key, spec in flat.items():
        assert isinstance(spec, PartitionSpec)
        axes = list(spec)
        if key.startswith("layers/"):
            assert axes[0] == "pp"
            axes = axes[1:]
        for name, transposed in leaf_map[key]:
            dims = axes[::-1] if transposed else axes
            want = {a: d for d, a in enumerate(dims) if a is not None}
            assert layouts[name] == want, (key, name)
            assert psh.param_partition_specs(cfg)[name] == \
                psh.placements_of(want)


def test_kv_heads_replicated_under_more_ranks_than_kv_heads():
    cfg = tconfig.tiny_config(**CFG)
    assert psh.param_layouts(cfg, tp=2)["layers.0.wk.weight"] == \
        {"tp": 0, "fsdp": 1}
    lay = psh.param_layouts(cfg, tp=4)
    assert lay["layers.0.wk.weight"] == {"fsdp": 1}
    assert lay["layers.0.wv.bias"] == {}
    assert [psh.kv_head_rows(cfg, 4, r) for r in range(4)] == [
        slice(0, 8), slice(0, 8), slice(8, 16), slice(8, 16)]
    with pytest.raises(ValueError, match="query heads"):
        psh.kv_replicated(cfg, 3)


# ---------------- what the port does not run yet ----------------


@pytest.mark.parametrize("axis,piece", [
    ("sp", "zig-zag ring attention"), ("pp", "the 1F1B pipeline"),
    ("ep", "expert parallelism")])
def test_later_axes_raise_on_a_mesh(world2, axis, piece):
    msg = world2[0]["later"][axis]
    assert msg is not None and piece in msg and "ROADMAP.md Queue 1" in msg


@pytest.mark.parametrize("alloc,piece", [
    ("s2", "zig-zag ring attention"), ("d2p2", "the 1F1B pipeline"),
    ("e2", "expert parallelism")])
def test_later_axes_raise_in_the_allocation(alloc, piece):
    from areal_tpu_torch.experiments import common as C
    from areal_tpu_torch.api.cli_args import BaseExperimentConfig

    cfg = BaseExperimentConfig(backend="cpu", allocation_mode=alloc,
                               n_gpus_per_node=4)
    with pytest.raises(NotImplementedError, match=piece):
        C.resolve_allocation(cfg)


def test_moe_under_tensor_parallelism_raises(world2):
    assert "expert parallelism" in world2[0]["later"]["moe_tp"]
