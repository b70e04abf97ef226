"""The decoupled generation fleet in the port against the JAX package, in
float32 on the CPU.

 - tensor-parallel generation: a meshed server's device calls
   (``system/server_mesh.py``) over gloo ranks against the reference's
   ``prefill_state`` / ``decode_chunk_rows`` on ``psh.shard_params(...,
   make_mesh(t2))`` (last logits within 1e-4, greedy tokens equal), at
   ``t2`` (kv heads split) and at ``t4`` on 4 q / 2 kv heads (Megatron's
   kv rule: each rank keeps the kv head its q head reads);
 - a meshed server end to end over gloo: ``/generate`` with a
   continuation (no second prefill), a ``device`` swap into both ranks
   (bit-equal to their slices), the digest and version gates (500, old
   weights kept);
 - the trainer's per-rank publication equal, leaf for leaf, to the
   addressable shards of the reference's ``publish_device(
   target_shardings=model_shardings(make_mesh(t2), cfg))`` (the port keeps
   the embedding whole on each rank, where the reference splits its
   vocabulary: each of the reference's shards is the port's rows);
 - transfer groups bound the bytes a publish stages;
 - the publisher's GPU found by UUID, and no match answered 500;
 - the experiments (``gen.d2t2+d1``: 2 servers of tp 2, as the
   reference's 2 servers; ``gen_parallel_spec`` threaded as the
   reference does), the launcher's GPU slices, the generation spec's
   checks, and the supervisor's failure domain;
 - the reference's fault: its fleet builds every server without a mesh;
 - a killed follower fails its server as one unit, and the supervisor
   respawns both ranks.

Each gloo world (2 and 4 ranks) is spawned once for the module; the
killed-follower test starts its server through the launcher's entry under
the supervisor. Every wait is bounded.
"""

import json
import os
import signal
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from areal_tpu_torch.base import name_resolve, names
from areal_tpu_torch.models import config as tconfig
from areal_tpu_torch.models import convert
from areal_tpu_torch.models import generate as tgen
from areal_tpu_torch.models.transformer import Transformer
from areal_tpu_torch.parallel import distributed as Dist
from areal_tpu_torch.parallel import reshard as rsh
from areal_tpu_torch.parallel import sharding as psh
from areal_tpu_torch.parallel.mesh import ParallelSpec
from test_torch_weight_stream import port_nr  # noqa: F401 (fixture)

EXP, TRIAL = "gen_mesh", "t0"
EOS, PAD = 95, 0
CFG = dict(vocab_size=96, n_layers=2, hidden_dim=32, n_q_heads=4,
           n_kv_heads=2, use_attention_bias=True, rotary_base=1e6,
           tie_word_embeddings=True)
LENS = (5, 9, 3, 12)
DECODE = 6


def _tcfg():
    return tconfig.tiny_config(**CFG)


def _flat(seed):
    """Reference-layout float32 weights from one numpy seed (scales near
    1, the rest near 0)."""
    import jax

    from areal_tpu.models import config as jconfig
    from areal_tpu.models import hf as jhf
    from areal_tpu.models import transformer as jtf

    shapes = jhf.flatten_pytree(jax.eval_shape(
        lambda: jtf.init_params(jconfig.tiny_config(**CFG),
                                jax.random.PRNGKey(0))))
    rng = np.random.RandomState(seed)
    return {k: ((1.0 if k.split("/")[-1] in ("ln1", "ln2", "final_ln")
                 else 0.0) + 0.1 * rng.randn(*a.shape)).astype(np.float32)
            for k, a in shapes.items()}


def _prompts():
    rng = np.random.RandomState(3)
    prompts = [rng.randint(2, 90, n).tolist() for n in LENS]
    return prompts, tgen.pad_prompts(prompts, PAD, bucket=16)


def _reference(spec, flat):
    """The reference's meshed generation: last logits of the prefill, the
    greedy tokens of one decode chunk and the last logits after it."""
    import jax
    import jax.numpy as jnp

    from areal_tpu.api.model import GenerationHyperparameters as JGen
    from areal_tpu.models import config as jconfig
    from areal_tpu.models import generate as jgen
    from areal_tpu.models import hf as jhf
    from areal_tpu.ops import sampling as jsamp
    from areal_tpu.parallel import mesh as jmesh
    from areal_tpu.parallel import sharding as jpsh

    jcfg = jconfig.tiny_config(**CFG)
    mesh = jmesh.make_mesh(jmesh.ParallelSpec.parse(spec))
    tree = jax.tree.map(jnp.asarray, jhf.unflatten_pytree(flat))
    params = jpsh.shard_params(tree, mesh, jcfg)
    _, (padded, plens) = _prompts()
    st = jgen.prefill_state(params, jcfg, jnp.asarray(padded),
                            jnp.asarray(plens), S=32)
    first = np.asarray(st["last_logits"])
    st, out = jgen.decode_chunk_rows(
        params, jcfg, st, jnp.zeros(len(LENS), jnp.int32),
        jax.random.PRNGKey(0),
        jsamp.sampling_from_gconfigs([JGen(greedy=True)] * len(LENS)),
        n_tokens=DECODE, eos_token_id=EOS, pad_token_id=PAD)
    return {"last_logits": first, "tokens": np.asarray(out["output_ids"]),
            "decode_last_logits": np.asarray(st["last_logits"])}


# ---------------- the gloo worlds ----------------


def _nr(root):
    name_resolve.reconfigure(name_resolve.NameResolveConfig(
        type="nfs", nfs_record_root=root))


def _post(url, path, body, timeout=60):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _rank_state(server):
    return {k: v.numpy().copy() for k, v in server.model.state_dict().items()}


def _trainer_publishes(rank, world, flat, root):
    """An ``f2`` trainer on these ranks publishes ``flat`` at version 1
    over ``device`` in a t2 fleet's layout, one leaf a transfer group
    (every rank gathers each group, rank 0 packs it). Returns the
    trainer worker (its publication lives while it does)."""
    from areal_tpu_torch.api.model import FinetuneSpec, Model, make_backend
    from areal_tpu_torch.api.train_config import (
        OptimizerConfig,
        WeightSyncConfig,
    )
    from areal_tpu_torch.backend import torch_train  # noqa: F401 (registry)
    from areal_tpu_torch.system.trainer_worker import (
        TrainerWorker,
        TrainerWorkerConfig,
    )

    cfg = _tcfg()
    model = make_backend(
        "torch_train", optimizer=OptimizerConfig(lr=1e-3), device="cpu",
        compute_dtype="float32", parallel_spec=f"f{world}").initialize(
        Model("actor", (cfg, convert.params_from_jax(flat, cfg,
                                                     device="cpu"))),
        FinetuneSpec(1, 8, 2))
    model.version.global_step = 1
    w = TrainerWorker(TrainerWorkerConfig(
        experiment=EXP, trial=TRIAL, device="cpu", dist_rank=rank,
        dist_world=world, realloc_dir=os.path.join(root, "realloc"),
        weight_sync=WeightSyncConfig(transport="device",
                                     gen_parallel_spec=f"t{world}",
                                     transfer_group_mb=0)))
    w.models["actor"] = model  # setup()-free: the publish half only
    w.publish_weights("actor")
    return w


def _serve(rank, world, flat, root, new_flat):
    """One rank of a meshed server: the parity calls, then (world 2, with
    ``new_flat`` published by a trainer on the same ranks) HTTP traffic
    and the device swap, driven by the leader."""
    from areal_tpu_torch.api.model import GenerationHyperparameters as TGen
    from areal_tpu_torch.ops.sampling import sampling_from_gconfigs
    from areal_tpu_torch.parallel.mesh import make_mesh
    from areal_tpu_torch.system.generation_server import (
        GenerationServer,
        GenerationServerConfig,
    )

    _nr(root)
    cfg = _tcfg()
    trainer = (_trainer_publishes(rank, world, new_flat, root)
               if new_flat is not None else None)
    mesh = make_mesh(ParallelSpec(tp=world))
    srv = GenerationServer(
        GenerationServerConfig(experiment=EXP, trial=TRIAL, chunk_tokens=8,
                               eos_token_id=EOS, pad_token_id=PAD,
                               prompt_bucket=16, batch_window_ms=1),
        cfg, convert.params_from_jax(flat, cfg, device="cpu"),
        device="cpu", mesh=mesh)
    if rank > 0:
        srv.follow()
        if trainer is not None:
            trainer.close()
        return {"rank": rank}
    out = {}
    prompts, (padded, plens) = _prompts()
    with torch.inference_mode():
        st = srv._ops.prefill_state(srv.model, torch.from_numpy(padded),
                                    torch.from_numpy(plens), 32)
        out["last_logits"] = st["last_logits"].clone().numpy()
        out["kv_shape"] = tuple(st["kv_k"].shape)
        st, dec = srv._ops.decode_chunk_rows(
            srv.model, st, torch.zeros(len(LENS), dtype=torch.int32),
            srv._generator,
            sampling_from_gconfigs([TGen(greedy=True)] * len(LENS)),
            DECODE, EOS, PAD)
        out["tokens"] = dec["output_ids"].numpy()
        out["decode_last_logits"] = st["last_logits"].clone().numpy()
        del st
    if trainer is None:
        srv.stop()
        return out
    url = srv.start()
    rec = rsh.lookup_publication(EXP, TRIAL, "actor")
    out["record_ranks"] = len(rsh.record_parts(rec))
    digest = rec["digest"]
    try:
        body = {"prompt_ids": prompts[1], "gconfig": {"greedy": True},
                "max_tokens": 16, "rid": "a"}
        out["first"] = _post(url, "/generate", body)
        p1 = srv.stats()["prefill_calls"]
        cont = dict(body, prompt_ids=prompts[1] + out["first"][1][
            "output_ids"], max_tokens=8, tokens_done=8)
        out["cont"] = _post(url, "/generate", cont)
        out["prefills"] = (p1, srv.stats()["prefill_calls"])
        upd = {"device": True, "role": "actor", "digest": digest}
        out["bad_digest"] = _post(url, "/update_weights",
                                  dict(upd, digest="0" * 8, version=1))
        out["bad_version"] = _post(url, "/update_weights",
                                   dict(upd, version=2))
        out["kept"] = srv.mesh_ctl.gather(_rank_state)
        out["swap"] = _post(url, "/update_weights", dict(upd, version=1))
        out["swapped"] = srv.mesh_ctl.gather(_rank_state)
        out["after"] = _post(url, "/generate", {
            "prompt_ids": prompts[1], "gconfig": {"greedy": True},
            "max_tokens": 8})
        out["health"] = srv.health()
    finally:
        srv.stop()
        trainer.close()
    return out


@pytest.fixture(scope="module")
def flats():
    return _flat(4), _flat(5)


@pytest.fixture(scope="module")
def world2(flats, tmp_path_factory):
    """The t2 server's two ranks; an f2 trainer on the same ranks
    publishes the seed-5 weights in its layout for its device swap."""
    root = str(tmp_path_factory.mktemp("nr_gen_mesh"))
    res = Dist.run_ranks(_serve, 2, flats[0], root, flats[1], timeout=240)
    return res, convert.params_from_jax(flats[1], _tcfg(), device="cpu")


@pytest.fixture(scope="module")
def world4(flats, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nr_gen_mesh4"))
    return Dist.run_ranks(_serve, 4, flats[0], root, None, timeout=240)


@pytest.mark.parametrize("spec", ["t2", "t4"])
def test_tp_generation_matches_the_reference(request, flats, spec):
    got = request.getfixturevalue(
        "world2" if spec == "t2" else "world4")
    got = got[0][0] if spec == "t2" else got[0]
    want = _reference(spec, flats[0])
    np.testing.assert_allclose(got["last_logits"], want["last_logits"],
                               atol=1e-4)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["decode_last_logits"],
                               want["decode_last_logits"], atol=1e-4)
    # each rank holds its kv heads: one of two at t2 (split), the one its
    # q head reads at t4 (replicated rule)
    assert got["kv_shape"][3] == 1


def test_kv_rule_picks_the_read_head():
    cfg = _tcfg()
    assert psh.kv_replicated(cfg, 4) and not psh.kv_replicated(cfg, 2)
    sl = psh.serving_slices(cfg, ParallelSpec(tp=4))
    # q heads 0,1 read kv head 0; q heads 2,3 read kv head 1 (head_dim 8)
    assert [r["layers.0.wk.weight"] for r in sl] == [
        ((0, 0, 8),), ((0, 0, 8),), ((0, 8, 8),), ((0, 8, 8),)]
    assert psh.rank_config(cfg, ParallelSpec(tp=4)).n_kv_heads == 1
    assert [r["embedding.weight"] for r in sl] == [()] * 4
    with pytest.raises(ValueError, match="does not divide"):
        psh.serving_slices(cfg, ParallelSpec(tp=3))


def test_meshed_server_continues_without_a_second_prefill(world2, flats):
    res, _ = world2
    out = res[0]
    (s1, first), (s2, cont) = out["first"], out["cont"]
    assert s1 == 200 and s2 == 200
    assert out["prefills"][0] == out["prefills"][1] >= 1
    # the two chunks are the unsharded model's 16 greedy tokens
    cfg = _tcfg()
    model = Transformer.from_params(cfg, convert.params_from_jax(
        flats[0], cfg, device="cpu"))
    prompts, _ = _prompts()
    from areal_tpu_torch.api.model import GenerationHyperparameters as TGen

    padded, plens = tgen.pad_prompts([prompts[1]], PAD, bucket=16)
    want = tgen.generate_batch(
        model, torch.from_numpy(padded), torch.from_numpy(plens), None,
        TGen(greedy=True), 16, EOS, PAD)["output_ids"][0].tolist()
    assert first["output_ids"] + cont["output_ids"] == want[:len(
        first["output_ids"]) + len(cont["output_ids"])]


def test_meshed_device_swap_is_all_ranks_bit_equal(world2):
    res, new = world2
    out = res[0]
    cfg = _tcfg()
    assert out["record_ranks"] == 2  # the trainer's publication, per rank
    assert out["swap"][0] == 200 and out["swap"][1]["version"] == 1
    for r, state in enumerate(out["swapped"]):
        want = psh.serving_shards(new, cfg, ParallelSpec(tp=2), r)
        assert set(state) == set(want)
        for n, t in state.items():
            assert np.array_equal(t, want[n].numpy()), (r, n)
    # the gates: 500, the old weights on both ranks, the version unchanged
    for gate, text in (("bad_digest", "digest mismatch"),
                       ("bad_version", "version skew")):
        status, reply = out[gate]
        assert status == 500 and text in reply["error"], reply
        assert reply["version"] == 0
    old = convert.params_from_jax(_flat(4), cfg, device="cpu")
    for r, state in enumerate(out["kept"]):
        want = psh.serving_shards(old, cfg, ParallelSpec(tp=2), r)
        assert all(np.array_equal(t, want[n].numpy())
                   for n, t in state.items())
    assert out["after"][0] == 200 and out["after"][1]["version"] == 1
    assert out["health"]["ok"] and out["health"]["version"] == 1


def test_publication_equals_the_reference_shards(flats, port_nr,
                                                 tmp_name_resolve):
    """Rank r's buffer of the port's t2 publication is, leaf for leaf, the
    reference's addressable shard on the tp-rank-r device of its t2
    publication (the embedding, whole on each port rank, covers both of
    the reference's vocabulary shards)."""
    import jax
    import jax.numpy as jnp

    from areal_tpu.models import config as jconfig
    from areal_tpu.models import hf as jhf
    from areal_tpu.parallel import mesh as jmesh
    from areal_tpu.parallel import reshard as jrsh

    cfg = _tcfg()
    flat = flats[1]
    mesh = jmesh.make_mesh(jmesh.ParallelSpec.parse("t2"))
    tree = jax.tree.map(jnp.asarray, jhf.unflatten_pytree(flat))
    jpub = jrsh.publish_device(
        EXP, TRIAL, "actor", tree, version=1,
        target_shardings=jrsh.model_shardings(mesh, jconfig.tiny_config(
            **CFG)))
    pub = rsh.publish_device(
        EXP, TRIAL, "actor", convert.params_from_jax(flat, cfg,
                                                     device="cpu"),
        version=1, target=rsh.model_shardings(ParallelSpec(tp=2), cfg))
    try:
        assert len(pub.parts) == 2 and "ranks" in pub.record
        assert pub.digest == rsh.layout_digest(
            [p.manifest for p in pub.parts], 1)
        ranks = []
        for part in pub.parts:
            views = {e["name"]: rsh._leaf_view(part.buffer,
                                               part.offsets[e["name"]], e)
                     for e in part.manifest}
            ranks.append({k: v.numpy() for k, v in
                          convert.params_to_reference(views, cfg).items()})
        tp_axis = mesh.axis_names.index("tp")
        coord = {d.id: int(np.argwhere(mesh.devices == d)[0][tp_axis])
                 for d in mesh.devices.flat}
        flat_pub = jhf.flatten_pytree(jpub.params)
        assert set(flat_pub) == set(ranks[0])
        for key, leaf in flat_pub.items():
            for shard in leaf.addressable_shards:
                data = np.asarray(shard.data)
                mine = ranks[coord[shard.device.id]][key]
                if key == "embedding":
                    mine = mine[shard.index]
                np.testing.assert_array_equal(mine, data, err_msg=key)
    finally:
        rsh.clear_publication(EXP, TRIAL, "actor")


def test_transfer_groups_bound_the_staged_bytes(port_nr):
    """The counterpart of the reference's ``test_plan_groups_bound_bytes``
    at the generation layout: every group a publish gathers holds at most
    the budget of whole compute-dtype tensors (a larger leaf alone), and
    the buffers equal a publish in one group."""
    cfg = tconfig.tiny_config(vocab_size=64, n_layers=4)
    params = {n: torch.randn(t.shape, generator=torch.Generator()
                             .manual_seed(i))
              for i, (n, t) in enumerate(
                  Transformer(cfg, device="meta").state_dict().items())}
    layout = rsh.model_shardings(ParallelSpec(tp=2), cfg)
    budget_mb = 1
    small = {n: torch.zeros(256, 256) for n in ("a", "b", "c", "d")}
    plan = rsh.plan_publication(small, torch.bfloat16, group_mb=0)
    assert [len(g) for g in plan.groups] == [1, 1, 1, 1]
    plan = rsh.plan_publication(
        {n: torch.zeros(512, 512) for n in "abcdef"}, torch.bfloat16,
        group_mb=budget_mb)  # 512 KiB each in bf16: two a group
    assert [len(g) for g in plan.groups] == [2, 2, 2]
    assert all(sum(512 * 512 * 2 for _ in g) <= budget_mb << 20
               for g in plan.groups)
    staged = []

    def gather(names):
        out = {n: params[n].to(torch.bfloat16) for n in names}
        staged.append(sum(t.numel() * 2 for t in out.values()))
        return out

    meta = {n: torch.empty(t.shape, device="meta") for n, t in params.items()}
    grouped = rsh.publish_device(EXP, TRIAL, "actor", meta, version=1,
                                 dtype=torch.bfloat16, target=layout,
                                 group_mb=0, gather=gather, device="cpu")
    try:
        biggest = max(t.numel() * 2 for t in params.values())
        assert len(staged) == len(params) and max(staged) <= biggest
        bufs = [p.buffer.clone() for p in grouped.parts]
    finally:
        rsh.clear_publication(EXP, TRIAL, "actor")
    whole = rsh.publish_device(EXP, TRIAL, "actor", params, version=1,
                               dtype=torch.bfloat16, target=layout,
                               group_mb=1 << 10)
    try:
        assert len(whole.plan.groups) == 1
        assert all(torch.equal(a, p.buffer)
                   for a, p in zip(bufs, whole.parts))
    finally:
        rsh.clear_publication(EXP, TRIAL, "actor")


# ---------------- the publisher's GPU by UUID ----------------


def test_visible_device_matches_by_uuid():
    table = ["GPU-aaaa", "GPU-bbbb", "GPU-cccc"]
    assert rsh.visible_device("GPU-bbbb", table) == 1
    with pytest.raises(rsh.DeviceReshardError, match="GPU-dddd"):
        rsh.visible_device("GPU-dddd", table)


def _as_cuda_record(uuid):
    """The advertised record rewritten as a card's (its shares CUDA IPC
    handles on the GPU named ``uuid``)."""
    key = names.weight_device(EXP, TRIAL, "actor")
    rec = json.loads(name_resolve.get(key))
    rec["shares"] = [dict(s, kind="cuda_ipc", uuid=uuid, device=0)
                     for s in rec["shares"]]
    name_resolve.add(key, json.dumps(rec), replace=True)
    return rec


def test_an_unmatched_uuid_claims_nothing_and_answers_500(port_nr):
    from areal_tpu_torch.system.generation_server import (
        GenerationServer,
        GenerationServerConfig,
    )

    cfg = _tcfg()
    live = convert.params_from_jax(_flat(4), cfg, device="cpu")
    pub = rsh.publish_device(EXP, TRIAL, "actor",
                             convert.params_from_jax(_flat(5), cfg,
                                                     device="cpu"),
                             version=1)
    try:
        rec = _as_cuda_record("GPU-not-here")
        with pytest.raises(rsh.DeviceReshardError, match="GPU-not-here"):
            rsh.consume_device(EXP, TRIAL, "actor", 1, pub.digest, live,
                               uuids=["GPU-one", "GPU-two"])
        assert os.listdir(rec["claims"]) == []  # no share was taken
        srv = GenerationServer(GenerationServerConfig(
            experiment=EXP, trial=TRIAL, eos_token_id=EOS), cfg, live,
            device="cpu")
        status, reply = srv.handle_update_weights(
            {"device": True, "role": "actor", "digest": pub.digest,
             "version": 1})
        assert status == 500 and "GPU-not-here" in reply["error"]
        assert srv.version == 0 and all(
            torch.equal(t, live[n]) for n, t in srv.model.state_dict().items())
    finally:
        rsh.clear_publication(EXP, TRIAL, "actor")


def test_a_whole_tensor_publication_is_refused_by_a_meshed_rank(port_nr):
    cfg = _tcfg()
    new = convert.params_from_jax(_flat(5), cfg, device="cpu")
    pub = rsh.publish_device(EXP, TRIAL, "actor", new, version=1)
    try:
        live = psh.serving_shards(new, cfg, ParallelSpec(tp=2), 0)
        with pytest.raises(rsh.DeviceReshardError, match="1 rank"):
            rsh.consume_device(EXP, TRIAL, "actor", 1, pub.digest, live,
                               rank=0, n_ranks=2)
    finally:
        rsh.clear_publication(EXP, TRIAL, "actor")


# ---------------- experiments, launcher, checks ----------------


def _async_cfg(alloc, **kw):
    from areal_tpu_torch.experiments.async_ppo_math_exp import (
        AsyncPPOMATHConfig,
    )

    return AsyncPPOMATHConfig(experiment_name="genmesh", trial_name="t",
                              allocation_mode=alloc, backend="cpu",
                              n_gpus_per_node=8, **kw)


def test_decoupled_setup_gives_servers_of_tp_ranks(tmp_path):
    from areal_tpu.experiments.async_ppo_math_exp import (
        AsyncPPOMATHConfig as JAsync,
    )

    cfg = _async_cfg("gen.d2t2+d1")
    cfg.cluster.fileroot = str(tmp_path)
    setup = cfg.initial_setup()
    servers = setup["gen_servers"]
    assert [(s.server_id, s.spec, s.rank) for s in servers] == [
        ("gen0", "t2", 0), ("gen1", "t2", 0)]
    assert setup["gserver_manager"].n_servers == 2
    ref = JAsync(experiment_name="genmesh", trial_name="t",
                 allocation_mode="gen.d2t2+d1", n_gpus_per_node=8)
    ref.cluster.fileroot = str(tmp_path)
    assert len(ref.initial_setup()["gen_servers"]) == len(servers)
    # one device, not decoupled: one server of one rank
    one = _async_cfg("")
    one.cluster.fileroot = str(tmp_path)
    assert [s.world for s in one.initial_setup()["gen_servers"]] == [1]


def test_ppo_math_threads_the_generation_spec(tmp_path):
    from areal_tpu.experiments.async_ppo_math_exp import (
        AsyncPPOMATHConfig as JAsync,
    )

    for transport, want in (("device", "d2t2"), ("stream", None)):
        cfg = _async_cfg("gen.d2t2+d1")
        cfg.cluster.fileroot = str(tmp_path)
        cfg.weight_sync.transport = transport
        got = cfg.build_trainer_config(async_mode=True).weight_sync
        ref = JAsync(experiment_name="genmesh", trial_name="t",
                     allocation_mode="gen.d2t2+d1", n_gpus_per_node=8)
        ref.cluster.fileroot = str(tmp_path)
        ref.weight_sync.transport = transport
        jws = ref.initial_setup()["trainer"].weight_sync
        assert got.gen_parallel_spec == jws.gen_parallel_spec == want
        assert got.transfer_group_mb == jws.transfer_group_mb == 64


def test_launcher_slices_the_generation_gpus():
    from areal_tpu_torch.apps import launcher as L

    assert L.derive_server_gpus("gen.d2t2+d2", 6) == [[[2], [3]],
                                                      [[4], [5]]]
    # the device transport adds the trainer's rank-0 GPU after each own
    assert L.derive_server_gpus("gen.d2t2+d2", 6, True) == [
        [[2, 0], [3, 0]], [[4, 0], [5, 0]]]
    assert L.derive_server_gpus("d2", 6) == []
    spawned = []
    launcher = L.LocalLauncher(_async_cfg("gen.d2t2+d2"))
    launcher.supervisor = types.SimpleNamespace(spawn=spawned.append)
    from areal_tpu_torch.system.generation_server import (
        GenerationServerConfig,
    )

    sc = GenerationServerConfig(server_id="gen1", spec="t2")
    launcher._spawn_server(launcher.exp_cfg, sc, "gen_replica",
                           [[4, 0], [5, 0]])
    assert [(w.name, w.kind, w.group, w.rank, w.args[1].rank,
             w.env["CUDA_VISIBLE_DEVICES"]) for w in spawned] == [
        ("genserver_gen1", "gen_replica", "genserver_gen1", 0, 0, "4,0"),
        ("genrank_gen1_1", "gen_replica", "genserver_gen1", 1, 1, "5,0")]
    assert all(w.target is L.gen_server_entry for w in spawned)


def test_slurm_runs_a_task_per_server_rank():
    from areal_tpu_torch.apps.slurm import build_job_specs

    specs = {s.name: s for s in build_job_specs(
        _async_cfg("gen.d2t2+d2"), "/c.yaml")}
    gen = specs["genmesh-gen"]
    assert gen.ntasks == 4 and gen.gpus_per_node == 4


def test_a_slurm_task_runs_its_server_rank(tmp_path, monkeypatch):
    """Task p of the generation job runs rank p % tp of server p // tp;
    task 0 also starts the manager; one task runs the whole fleet."""
    from areal_tpu_torch.apps import launcher as L
    from areal_tpu_torch.apps import remote
    from areal_tpu_torch.system import gserver_manager

    seen = []
    monkeypatch.setattr(L, "gen_server_entry", lambda exp, sc: seen.append(
        (sc.server_id, sc.spec, sc.rank)))
    monkeypatch.setattr(L, "gen_fleet_entry", lambda exp, scs, mgr:
                        seen.append(("fleet", len(scs))))
    started = []
    monkeypatch.setattr(gserver_manager.GserverManager, "start",
                        lambda self: started.append(self.cfg.n_servers))
    cfg = _async_cfg("gen.d2t2+d2")
    cfg.cluster.fileroot = str(tmp_path)
    for task in range(4):
        remote.run_role(cfg, "gen_fleet", rank=task, world=4)
    remote.run_role(cfg, "gen_fleet")
    assert seen == [("gen0", "t2", 0), ("gen0", "t2", 1), ("gen1", "t2", 0),
                    ("gen1", "t2", 1), ("fleet", 2)]
    assert started == [2]
    with pytest.raises(SystemExit):
        remote.run_role(cfg, "gen_fleet", rank=4, world=5)


@pytest.mark.parametrize("alloc,text", [
    ("gen.d1s2+d1", "sp=2, but sequence"), ("gen.d1p4+d1", "pp=4, more"),
    ("gen.d1f2s2+d1", "move the sp factor into d or t"),
    ("gen.d1t3+d1", "does not divide 4 query"),
])
def test_validate_config_checks_the_generation_spec(alloc, text):
    from areal_tpu_torch.api.cli_args import ConfigError, validate_config

    cfg = _async_cfg(alloc)
    cfg.actor.tiny = {"vocab_size": 96, "n_layers": 2}
    with pytest.raises(ConfigError, match=text):
        validate_config(cfg)
    for ok in ("gen.d2t2+d1", "gen.d1f2p2+d1", "gen.d1f2t2+d1"):
        validate_config(_async_cfg(ok))  # d, f, p and t pass


def test_generation_layout_refuses_other_axes():
    for spec, text in ((ParallelSpec(sp=2), "sp=2: sequence"),
                       (ParallelSpec(fsdp=2, ep=2), "ep=2: expert")):
        with pytest.raises(ValueError, match=text):
            rsh.model_shardings(spec, _tcfg())
    layout = rsh.model_shardings(ParallelSpec(dp=2, fsdp=2, pp=2), _tcfg())
    assert layout.n_ranks == 4  # one server's ranks; dp counts servers


# ---------------- the supervisor's failure domain ----------------


class _Proc:
    def __init__(self, name):
        self.name, self.alive, self.exitcode, self.pid = name, True, None, 1
        self.killed = False

    def is_alive(self):
        return self.alive

    def kill(self):
        self.alive, self.exitcode, self.killed = False, -9, True

    def join(self, timeout=None):
        pass


def test_a_dead_rank_takes_its_server_down_and_up():
    from areal_tpu_torch.system.supervisor import Supervisor, WorkerSpec

    now = [0.0]
    sup = Supervisor("e", "t", clock=lambda: now[0])
    made = []
    sup._make_proc = lambda spec, inc: made.append((spec.name, inc)) \
        or _Proc(spec.name)
    for r in range(2):
        sup.spawn(WorkerSpec(name=f"r{r}", kind="gen_replica",
                             target=print, group="genserver_gen0", rank=r))
    sup.spawn(WorkerSpec(name="solo", kind="gen_replica", target=print))
    assert sup.alive_count("gen_replica") == 2  # leaders only
    follower = sup.entry("r1").proc
    follower.alive, follower.exitcode = False, -9
    sup.check()
    assert sup.entry("r0").proc.killed  # the leader went down with it
    now[0] += 60
    sup.check()
    assert sorted(made[3:]) == [("r0", 2), ("r1", 2)]
    assert sup.entry("solo").incarnation == 1
    assert sup.restart_counts["gen_replica"] == 2


# ---------------- the reference's fault ----------------


def test_reference_fleet_builds_servers_without_a_mesh(monkeypatch):
    """Reference fault 12 (ROADMAP.md Queue 3): ``apps/launcher.py
    gen_fleet_entry`` builds every server as ``GenerationServer(sc, cfg,
    params)``: no mesh, so a ``gen.d2t2`` fleet is two unsharded servers
    on the process's default chip and the spec's tp is never applied; a
    ``gen.d1f2p2`` fleet is ``dp x fsdp`` = two unsharded servers, its
    fsdp and pp never applied. The port gives each of the spec's ``dp``
    servers its own GPUs and its ``fsdp x pp x tp`` ranks."""
    from areal_tpu.apps import launcher as JL
    from areal_tpu.experiments.async_ppo_math_exp import (
        AsyncPPOMATHConfig as JAsync,
    )
    from areal_tpu.system import generation_server as jgs
    from areal_tpu.system import gserver_manager as jgm

    built = []

    class Server:
        def __init__(self, sc, cfg, params, mesh=None, **kw):
            built.append((sc.server_id, mesh))

        async def start(self):
            pass

    class Stop(Exception):
        pass

    class Manager:
        def __init__(self, cfg):
            pass

        async def start(self):
            raise Stop

    monkeypatch.setattr(jgs, "GenerationServer", Server)
    monkeypatch.setattr(jgm, "GserverManager", Manager)
    monkeypatch.setattr(JL, "_child_init", lambda *a, **k: None)
    monkeypatch.setattr(JL, "_build_gen_model", lambda init: (None, {}))
    monkeypatch.setattr(JL, "_resolve_tokenizer",
                        lambda exp: types.SimpleNamespace(eos_token_id=1))
    for alloc, spec in (("gen.d2t2+d1", "t2"), ("gen.d1f2p2+d1", "f2p2")):
        built.clear()
        exp = JAsync(experiment_name="ref", trial_name="t",
                     allocation_mode=alloc, n_gpus_per_node=8)
        setup = exp.initial_setup()
        with pytest.raises(Stop):
            JL.gen_fleet_entry(exp, setup["gen_servers"],
                               setup["gserver_manager"], True)
        assert built == [("gen0", None), ("gen1", None)], alloc
        mine = _async_cfg(alloc).initial_setup()["gen_servers"]
        assert [(s.server_id, s.spec) for s in mine] == (
            [("gen0", spec), ("gen1", spec)] if spec == "t2"
            else [("gen0", spec)])


# ---------------- a killed follower ----------------


def _url(timeout):
    key = names.gen_servers("killexp", "t", "gen0")
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            return name_resolve.get(key)
        except name_resolve.NameEntryNotFoundError:
            time.sleep(0.2)
    raise TimeoutError(f"no server under {key} within {timeout} s")


def test_a_killed_follower_fails_the_server_as_one_unit(tmp_path):
    """The launcher's entry under the supervisor: a meshed server of two
    ranks serves; its follower is SIGKILLed; the leader's next /generate
    answers 500 and the leader ends its process; the supervisor brings
    both ranks back (a new rendezvous) and the server serves again."""
    from areal_tpu_torch.apps import launcher as L
    from areal_tpu_torch.experiments import common as C
    from areal_tpu_torch.system.generation_server import (
        GenerationServerConfig,
    )
    from areal_tpu_torch.system.supervisor import RestartPolicy, Supervisor

    exp = _async_cfg("gen.d1t2+d1")
    exp.experiment_name, exp.trial_name = "killexp", "t"
    exp.cluster.fileroot = str(tmp_path)
    exp.mock_tokenizer = True
    exp.actor.tiny = dict(CFG, seed=0)
    old = name_resolve.DEFAULT_REPO
    C.setup_name_resolve(exp)
    sup = Supervisor("killexp", "t", policy=RestartPolicy(
        backoff_base_secs=0.1))
    launcher = L.LocalLauncher(exp)
    launcher.supervisor = sup
    sc = GenerationServerConfig(experiment="killexp", trial="t",
                                server_id="gen0", spec="t2", chunk_tokens=8,
                                prompt_bucket=16)
    body = {"prompt_ids": [5, 6, 7], "gconfig": {"greedy": True},
            "max_tokens": 4}
    try:
        launcher._spawn_server(exp, sc, "gen_replica")
        url = _url(120)
        assert _post(url, "/generate", body)[0] == 200
        leader = sup.entry("genserver_gen0").proc
        follower = sup.entry("genrank_gen0_1").proc
        os.kill(follower.pid, signal.SIGKILL)
        follower.join(30)
        status, reply = _post(url, "/generate", body)
        assert status == 500, reply
        leader.join(60)
        assert not leader.is_alive() and leader.exitcode != 0
        deadline = time.monotonic() + 60
        while sup.entry("genserver_gen0").incarnation < 2:
            assert time.monotonic() < deadline, "no respawn"
            sup.check()
            time.sleep(0.2)
        assert sup.entry("genrank_gen0_1").incarnation == 2
        url = _url(120)
        assert _post(url, "/generate", body)[0] == 200
    finally:
        sup.shutdown(timeout=20, orderly=False)
        name_resolve.DEFAULT_REPO = old
