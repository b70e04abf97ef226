"""Generation servers sharded over ``fsdp`` and ``pp`` in the port against
the JAX package, in float32 on the CPU.

 - a meshed server's device calls (``system/server_mesh.py``: each rank
   its stage's layers and their KV, its ``fsdp`` shards gathered a layer
   at a time, the ``tp`` sums) over gloo ranks against the reference's
   ``prefill_state`` / ``decode_chunk_rows`` on ``psh.shard_params(...,
   make_mesh(spec))`` (and its ``extend_state`` on a clone of the
   prefill, the prefix-reuse path): last logits within 1e-4, the greedy
   tokens of one decode chunk equal, at ``f2`` and ``p2`` (2 ranks),
   ``f2p2``, ``p2t2``, ``f2t2`` and ``p4`` (4 ranks), and a tiny MoE
   model with an untied head at ``f2p2``; every rank ends each call with
   the leader's last logits, and its KV holds its stage's layers and its
   kv heads;
 - a server at ``f2p2`` end to end over gloo: ``/generate`` with a
   continuation (no second prefill), then a ``device`` swap from an ``f4``
   trainer on the same ranks publishing into the ``f2p2`` layout
   (``gen_parallel_spec``), bit-equal on every rank;
 - each rank's buffer of a publication at ``p2`` and ``f2p2`` equal, leaf
   for leaf, to the reference's addressable shards on the device at the
   rank's ``fsdp``, ``pp`` and ``tp`` coordinates;
 - the reference's decode at ``f2`` gathers no weight (its partial sums'
   all-reduces sit inside the decode loop), where the port's decode call
   holds its stage's gathered layers: an accepted difference;
 - the layout (which tensors a rank holds, its cuts, its geometry), the
   stage link's host staging (over gloo only), both packages'
   ``validate_config`` on ``sp``, ``fsdp`` and ``pp``, the launcher's
   GPUs, Slurm's tasks, and a killed ``pp`` follower under the
   supervisor, which respawns all four ranks.

Each gloo world (2 and 4 ranks) is spawned once for the module, the two
side by side, and runs every mesh of its size in turn. Every wait is
bounded.
"""

import dataclasses
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
from areal_tpu_torch.parallel.mesh import ParallelSpec, ServerRank
from test_torch_weight_stream import port_nr  # noqa: F401 (fixture)

EXP, TRIAL = "gen_fp", "t0"
EOS, PAD = 95, 0
CFG = dict(vocab_size=96, n_layers=4, hidden_dim=32, n_q_heads=4,
           n_kv_heads=2, use_attention_bias=True, rotary_base=1e6,
           tie_word_embeddings=True)
# E/k = 2: capacity for every entry, so no row depends on its batch
MOE = dict(vocab_size=96, n_layers=2, hidden_dim=32, n_q_heads=4,
           n_kv_heads=2, tie_word_embeddings=False,
           moe=dict(num_experts=4, top_k=2, routed_intermediate_dim=16,
                    capacity_factor=2.0))
LENS = (5, 9, 3, 12)
DECODE = 6
# (case, spec, config): every mesh each world runs, in order
WORLD2 = (("f2", "f2", CFG), ("p2", "p2", CFG))
WORLD4 = (("f2p2", "f2p2", CFG), ("p2t2", "p2t2", CFG),
          ("f2t2", "f2t2", CFG), ("p4", "p4", CFG),
          ("moe_f2p2", "f2p2", MOE))


def _tcfg(kw=CFG):
    return tconfig.tiny_config(**kw)


def _flat(seed, kw=CFG):
    """Reference-layout float32 weights from one numpy seed (scales near
    1, the rest near 0)."""
    import jax

    from areal_tpu.models import config as jconfig
    from areal_tpu.models import hf as jhf
    from areal_tpu.models import transformer as jtf

    shapes = jhf.flatten_pytree(jax.eval_shape(
        lambda: jtf.init_params(jconfig.tiny_config(**kw),
                                jax.random.PRNGKey(0))))
    rng = np.random.RandomState(seed)
    return {k: ((1.0 if k.split("/")[-1] in ("ln1", "ln2", "final_ln")
                 else 0.0) + 0.1 * rng.randn(*a.shape)).astype(np.float32)
            for k, a in shapes.items()}


def _prompts():
    rng = np.random.RandomState(3)
    prompts = [rng.randint(2, 90, n).tolist() for n in LENS]
    return prompts, tgen.pad_prompts(prompts, PAD, bucket=16)


# the suffix extend: every row's prompt past its first SHARED tokens, on
# a clone of the prefill state cut to SHARED
SHARED = 2


def _suffix():
    prompts, _ = _prompts()
    toks, lens = tgen.pad_prompts([p[SHARED:] for p in prompts], PAD,
                                  bucket=16)
    return toks, lens


def _reference(spec, flat, kw=CFG):
    """The reference's meshed generation (GSPMD over ``spec``'s mesh): last
    logits of the prefill, the greedy tokens of one decode chunk and the
    last logits after it."""
    import jax
    import jax.numpy as jnp

    from areal_tpu.api.model import GenerationHyperparameters as JGen
    from areal_tpu.models import config as jconfig
    from areal_tpu.models import generate as jgen
    from areal_tpu.models import hf as jhf
    from areal_tpu.ops import sampling as jsamp
    from areal_tpu.parallel import mesh as jmesh
    from areal_tpu.parallel import sharding as jpsh

    jcfg = jconfig.tiny_config(**kw)
    mesh = jmesh.make_mesh(jmesh.ParallelSpec.parse(spec))
    tree = jax.tree.map(jnp.asarray, jhf.unflatten_pytree(flat))
    params = jpsh.shard_params(tree, mesh, jcfg)
    _, (padded, plens) = _prompts()
    st = jgen.prefill_state(params, jcfg, jnp.asarray(padded),
                            jnp.asarray(plens), S=32)
    first = np.asarray(st["last_logits"])
    toks, lens = _suffix()
    ext = jgen.extend_state(params, jcfg, jgen.clone_prefix(st, SHARED),
                            jnp.asarray(toks), jnp.asarray(lens))
    st, out = jgen.decode_chunk_rows(
        params, jcfg, st, jnp.zeros(len(LENS), jnp.int32),
        jax.random.PRNGKey(0),
        jsamp.sampling_from_gconfigs([JGen(greedy=True)] * len(LENS)),
        n_tokens=DECODE, eos_token_id=EOS, pad_token_id=PAD)
    return {"last_logits": first, "tokens": np.asarray(out["output_ids"]),
            "decode_last_logits": np.asarray(st["last_logits"]),
            "extend_last_logits": np.asarray(ext["last_logits"])}


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


def _rank_state(server, sid):
    """A rank's part of state ``sid``: its KV's shape, its last logits,
    and the rank's stage."""
    st = server.mesh_ctl.state(sid)
    return {"kv_shape": tuple(st["kv_k"].shape),
            "last_logits": st["last_logits"].clone().numpy(),
            "stage": server.mesh_ctl.me.pp_rank}


def _live(server):
    return {k: v.numpy().copy() for k, v in server._live_params().items()}


def _server(spec, kw, flat):
    from areal_tpu_torch.parallel.mesh import make_mesh
    from areal_tpu_torch.system.generation_server import (
        GenerationServer,
        GenerationServerConfig,
    )

    cfg = _tcfg(kw)
    return GenerationServer(
        GenerationServerConfig(experiment=EXP, trial=TRIAL, chunk_tokens=8,
                               eos_token_id=EOS, pad_token_id=PAD,
                               prompt_bucket=16, batch_window_ms=1,
                               spec=spec),
        cfg, convert.params_from_jax(flat, cfg, device="cpu"),
        device="cpu", mesh=make_mesh(ParallelSpec.parse(spec)))


def _parity(srv):
    """The leader's prefill, a suffix extend on a clone of it, and one
    greedy decode chunk through the mesh, and every rank's part of the
    states."""
    from areal_tpu_torch.api.model import GenerationHyperparameters as TGen
    from areal_tpu_torch.ops.sampling import sampling_from_gconfigs

    out = {}
    _, (padded, plens) = _prompts()
    with torch.inference_mode():
        st = srv._ops.prefill_state(srv.model, torch.from_numpy(padded),
                                    torch.from_numpy(plens), 32)
        out["last_logits"] = st["last_logits"].clone().numpy()
        out["prefill_ranks"] = srv.mesh_ctl.gather(_rank_state, st.sid)
        toks, lens = _suffix()
        ext = srv._ops.extend_state(
            srv.model, srv._ops.clone_prefix(st, SHARED),
            torch.from_numpy(toks), torch.from_numpy(lens))
        out["extend_last_logits"] = ext["last_logits"].clone().numpy()
        out["extend_ranks"] = srv.mesh_ctl.gather(_rank_state, ext.sid)
        del ext
        st, dec = srv._ops.decode_chunk_rows(
            srv.model, st, torch.zeros(len(LENS), dtype=torch.int32),
            srv._generator,
            sampling_from_gconfigs([TGen(greedy=True)] * len(LENS)),
            DECODE, EOS, PAD)
        out["tokens"] = dec["output_ids"].numpy()
        out["logprobs"] = dec["output_logprobs"].numpy()
        out["decode_last_logits"] = st["last_logits"].clone().numpy()
        out["decode_ranks"] = srv.mesh_ctl.gather(_rank_state, st.sid)
        del st
    return out


def _trainer_publishes(rank, world, flat, root, gen_spec):
    """An ``f<world>`` trainer on these ranks publishes ``flat`` at version
    1 over ``device`` in ``gen_spec``'s layout. Returns the trainer worker
    (its publication lives while it does)."""
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
                                     gen_parallel_spec=gen_spec,
                                     transfer_group_mb=0)))
    w.models["actor"] = model  # setup()-free: the publish half only
    w.publish_weights("actor")
    return w


def _end_to_end(srv, prompts):
    """The f2p2 leader's HTTP traffic and device swap (a trainer on the
    same ranks published the seed-5 weights in its layout)."""
    out = {}
    url = srv.start()
    rec = rsh.lookup_publication(EXP, TRIAL, "actor")
    out["record_ranks"] = len(rsh.record_parts(rec))
    body = {"prompt_ids": prompts[1], "gconfig": {"greedy": True},
            "max_tokens": 16, "rid": "a"}
    out["first"] = _post(url, "/generate", body)
    p1 = srv.stats()["prefill_calls"]
    cont = dict(body, prompt_ids=prompts[1] + out["first"][1]["output_ids"],
                max_tokens=8, tokens_done=8)
    out["cont"] = _post(url, "/generate", cont)
    out["prefills"] = (p1, srv.stats()["prefill_calls"])
    out["swap"] = _post(url, "/update_weights", {
        "device": True, "role": "actor", "digest": rec["digest"],
        "version": 1})
    out["swapped"] = srv.mesh_ctl.gather(_live)
    out["after"] = _post(url, "/generate", {
        "prompt_ids": prompts[1], "gconfig": {"greedy": True},
        "max_tokens": 8})
    out["health"] = srv.health()
    return out


def _serve(rank, world, cases, flats, root, new_flat):
    """Every case's server on these ranks in turn (the leader drives the
    parity calls; the followers replay them), then, with ``new_flat``, an
    f2p2 server's HTTP traffic and its device swap."""
    _nr(root)
    res = {}
    for case, spec, kw in cases:
        srv = _server(spec, kw, flats[case])
        if rank > 0:
            srv.follow()
            continue
        try:
            res[case] = _parity(srv)
        finally:
            srv.stop()
    if new_flat is None:
        return res
    trainer = _trainer_publishes(rank, world, new_flat, root, "f2p2")
    srv = _server("f2p2", CFG, flats["f2p2"])
    try:
        if rank > 0:
            srv.follow()
            return res
        res["e2e"] = _end_to_end(srv, _prompts()[0])
    finally:
        if rank == 0:
            srv.stop()
        trainer.close()
    return res


@pytest.fixture(scope="module")
def flats():
    return {"seed4": _flat(4), "seed5": _flat(5), "moe": _flat(6, MOE)}


def _case_flats(flats, cases):
    return {case: flats["moe"] if kw is MOE else flats["seed4"]
            for case, _, kw in cases}


@pytest.fixture(scope="module")
def worlds(flats, tmp_path_factory):
    """Rank 0's results of both worlds, spawned side by side."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        w2 = pool.submit(
            Dist.run_ranks, _serve, 2, WORLD2, _case_flats(flats, WORLD2),
            str(tmp_path_factory.mktemp("nr_gen_fp2")), None, timeout=240)
        w4 = pool.submit(
            Dist.run_ranks, _serve, 4, WORLD4, _case_flats(flats, WORLD4),
            str(tmp_path_factory.mktemp("nr_gen_fp4")), flats["seed5"],
            timeout=300)
        return {**w2.result()[0], **w4.result()[0]}


@pytest.mark.parametrize("case,spec,kw", WORLD2 + WORLD4,
                         ids=[c[0] for c in WORLD2 + WORLD4])
def test_meshed_generation_matches_the_reference(worlds, flats, case, spec,
                                                 kw):
    ps = ParallelSpec.parse(spec)
    got = worlds[case]
    want = _reference(spec, flats["moe"] if kw is MOE else flats["seed4"],
                      kw)
    np.testing.assert_allclose(got["last_logits"], want["last_logits"],
                               atol=1e-4)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["decode_last_logits"],
                               want["decode_last_logits"], atol=1e-4)
    # a clone cut to SHARED tokens, extended by the rest of each prompt:
    # the reference's extend, and the prefill's own last logits
    np.testing.assert_allclose(got["extend_last_logits"],
                               want["extend_last_logits"], atol=1e-4)
    np.testing.assert_allclose(got["extend_last_logits"],
                               got["last_logits"], atol=1e-4)
    assert np.all(got["logprobs"] <= 0) and np.isfinite(got["logprobs"]).all()
    cfg = _tcfg(kw)
    for key, logits in (("prefill_ranks", "last_logits"),
                        ("extend_ranks", "extend_last_logits"),
                        ("decode_ranks", "decode_last_logits")):
        ranks = got[key]
        assert len(ranks) == ps.world_size
        for r, part in enumerate(ranks):
            # every rank ends the call with the last stage's logits
            np.testing.assert_array_equal(part["last_logits"], got[logits])
            # its stage's layers, its kv heads, the whole batch
            rcfg = psh.rank_config(cfg, ps, r)
            assert part["kv_shape"] == (rcfg.n_layers, len(LENS), 32,
                                        rcfg.n_kv_heads, cfg.head_dim)
            assert part["stage"] == ServerRank(ps, r).pp_rank


def test_f2p2_server_continues_without_a_second_prefill(worlds, flats):
    out = worlds["e2e"]
    (s1, first), (s2, cont) = out["first"], out["cont"]
    assert s1 == 200 and s2 == 200
    assert out["prefills"][0] == out["prefills"][1] >= 1
    # the two chunks are the unsharded model's 16 greedy tokens
    cfg = _tcfg()
    model = Transformer.from_params(cfg, convert.params_from_jax(
        flats["seed4"], cfg, device="cpu"))
    prompts, _ = _prompts()
    from areal_tpu_torch.api.model import GenerationHyperparameters as TGen

    padded, plens = tgen.pad_prompts([prompts[1]], PAD, bucket=16)
    want = tgen.generate_batch(
        model, torch.from_numpy(padded), torch.from_numpy(plens), None,
        TGen(greedy=True), 16, EOS, PAD)["output_ids"][0].tolist()
    n = len(first["output_ids"]) + len(cont["output_ids"])
    assert first["output_ids"] + cont["output_ids"] == want[:n]


def test_f2p2_device_swap_is_bit_equal_on_every_rank(worlds, flats):
    out = worlds["e2e"]
    cfg = _tcfg()
    assert out["record_ranks"] == 4  # one buffer a server rank
    assert out["swap"][0] == 200 and out["swap"][1]["version"] == 1
    new = convert.params_from_jax(flats["seed5"], cfg, device="cpu")
    spec = ParallelSpec(fsdp=2, pp=2)
    for r, state in enumerate(out["swapped"]):
        want = psh.serving_shards(new, cfg, spec, r)
        assert set(state) == set(want)
        for n, t in state.items():
            assert np.array_equal(t, want[n].numpy()), (r, n)
    assert out["after"][0] == 200 and out["after"][1]["version"] == 1
    assert out["health"]["ok"] and out["health"]["version"] == 1


def test_reference_decode_holds_only_its_shards(flats):
    """An accepted difference, pinned on the reference: its GSPMD decode
    at ``f2`` gathers no weight. The ``fsdp``-sharded contractions run as
    partial sums, with an all-reduce of the activations inside the decode
    loop, so a device holds only its shards while it decodes. The port's
    decode call instead holds its stage's gathered layers for its steps
    (``models/generate.py _params_hook``)."""
    import re

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
    mesh = jmesh.make_mesh(jmesh.ParallelSpec.parse("f2"))
    params = jpsh.shard_params(jax.tree.map(
        jnp.asarray, jhf.unflatten_pytree(flats["seed4"])), mesh, jcfg)
    _, (padded, plens) = _prompts()
    st = jgen.prefill_state(params, jcfg, jnp.asarray(padded),
                            jnp.asarray(plens), S=32)
    hlo = jgen.decode_chunk_rows.lower(
        params, jcfg, st, jnp.zeros(len(LENS), jnp.int32),
        jax.random.PRNGKey(0),
        jsamp.sampling_from_gconfigs([JGen(greedy=True)] * len(LENS)),
        n_tokens=DECODE, eos_token_id=EOS, pad_token_id=PAD
    ).compile().as_text()
    bodies = set(re.findall(r"body=%?([\w.\-]+)", hlo))
    reduces, comp = {}, None
    for line in hlo.splitlines():
        head = re.match(r"(?:ENTRY )?%?([\w.\-]+) \(", line)
        if head:
            comp = head.group(1)
        elif re.search(r"\ball-reduce(-start)?\(", line):
            reduces[comp] = reduces.get(comp, 0) + 1
    assert not re.search(r"\ball-gather(-start)?\(", hlo)
    assert reduces and set(reduces) <= bodies, (reduces, bodies)


@pytest.mark.parametrize("spec", ["p2", "f2p2"])
def test_publication_equals_the_reference_shards(flats, port_nr,
                                                 tmp_name_resolve, spec):
    """Rank r's buffer of the port's publication into ``spec``'s layout is,
    leaf for leaf, the reference's addressable shard on the device at rank
    r's coordinates along ``fsdp``, ``pp`` and ``tp`` of its publication
    with ``model_shardings(make_mesh(spec))`` (the port keeps the
    embedding's whole vocabulary on a ``tp`` rank: its rows of the
    reference's shard)."""
    import jax
    import jax.numpy as jnp

    from areal_tpu.models import config as jconfig
    from areal_tpu.models import hf as jhf
    from areal_tpu.parallel import mesh as jmesh
    from areal_tpu.parallel import reshard as jrsh
    from areal_tpu_torch.parallel.pipeline import stage_bounds

    cfg = _tcfg()
    ps = ParallelSpec.parse(spec)
    flat = flats["seed5"]
    mesh = jmesh.make_mesh(jmesh.ParallelSpec.parse(spec))
    tree = jax.tree.map(jnp.asarray, jhf.unflatten_pytree(flat))
    jpub = jrsh.publish_device(
        EXP, TRIAL, "actor", tree, version=1,
        target_shardings=jrsh.model_shardings(mesh,
                                              jconfig.tiny_config(**CFG)))
    pub = rsh.publish_device(
        EXP, TRIAL, "actor", convert.params_from_jax(flat, cfg,
                                                     device="cpu"),
        version=1, target=rsh.model_shardings(ps, cfg))
    try:
        assert len(pub.parts) == ps.world_size and "ranks" in pub.record
        ranks = []
        for r, part in enumerate(pub.parts):
            lo, hi = stage_bounds(cfg.n_layers, ps.pp)[
                ServerRank(ps, r).pp_rank]
            views = {e["name"]: rsh._leaf_view(part.buffer,
                                               part.offsets[e["name"]], e)
                     for e in part.manifest}
            ranks.append({k: v.numpy() for k, v in convert.params_to_reference(
                psh.shift_layers(views, -lo),
                dataclasses.replace(cfg, n_layers=hi - lo)).items()})
        # the port's rank at each device's (fsdp, pp, tp) coordinates
        coords = {(m.fsdp_rank, m.pp_rank, m.tp_rank): m.rank for m in (
            ServerRank(ps, r) for r in range(ps.world_size))}
        axes = [mesh.axis_names.index(a) for a in ("fsdp", "pp", "tp")]
        rank_of = {}
        for d in mesh.devices.flat:
            at = np.argwhere(mesh.devices == d)[0]
            rank_of[d.id] = coords[tuple(int(at[i]) for i in axes)]
        flat_pub = jhf.flatten_pytree(jpub.params)
        assert set(flat_pub) == set(ranks[0])
        for key, leaf in flat_pub.items():
            for shard in leaf.addressable_shards:
                data = np.asarray(shard.data)
                mine = ranks[rank_of[shard.device.id]][key]
                if key == "embedding":
                    mine = mine[shard.index[0]]
                np.testing.assert_array_equal(mine, data, err_msg=key)
    finally:
        rsh.clear_publication(EXP, TRIAL, "actor")


# ---------------- the layout ----------------


def test_a_rank_holds_its_stage_and_its_shards():
    cfg = _tcfg()
    spec = ParallelSpec(fsdp=2, pp=2)
    cuts = psh.serving_slices(cfg, spec)
    assert len(cuts) == 4
    for r, held in enumerate(cuts):
        me = ServerRank(spec, r)
        layers = sorted({int(n.split(".")[1]) for n in held
                         if n.startswith("layers.")})
        assert layers == ([0, 1] if me.pp_rank == 0 else [2, 3])
        # every stage holds the ends, as the reference replicates them
        assert {"embedding.weight", "final_ln.weight"} <= set(held)
        d = cfg.hidden_dim // 2
        assert held["embedding.weight"] == ((1, me.fsdp_rank * d, d),)
        # wq [out, in]: fsdp on the input dim; a norm whole
        assert held[f"layers.{layers[0]}.wq.weight"] == (
            (1, me.fsdp_rank * d, d),)
        assert held[f"layers.{layers[0]}.ln1.weight"] == ()
        assert held[f"layers.{layers[0]}.wq.bias"] == ()
    # f2t2: the tp cut first, then the fsdp cut
    ft = psh.serving_slices(cfg, ParallelSpec(fsdp=2, tp=2))
    assert ft[3]["layers.0.wo.weight"] == ((1, 16, 16), (0, 16, 16))
    assert psh.rank_config(cfg, ParallelSpec(pp=2, tp=2), 3).n_layers == 2
    assert psh.rank_config(cfg, ParallelSpec(fsdp=2), 1) == cfg
    with pytest.raises(ValueError, match="pp=8 stages"):
        psh.serving_slices(cfg, ParallelSpec(pp=8))
    with pytest.raises(ValueError, match="fsdp=3 does not divide"):
        psh.serving_slices(cfg, ParallelSpec(fsdp=3))


def test_server_rank_coordinates():
    spec = ParallelSpec(fsdp=2, pp=2, tp=2)
    coords = [(m.fsdp_rank, m.pp_rank, m.tp_rank)
              for m in (ServerRank(spec, r) for r in range(8))]
    assert coords == [(f, p, t) for f in range(2) for p in range(2)
                      for t in range(2)]
    me = ServerRank(spec, 5)  # (1, 0, 1)
    assert me.first_stage and not me.last_stage
    assert ServerRank(spec, 7).last_stage
    with pytest.raises(ValueError, match="fsdp, pp and tp only"):
        ServerRank(ParallelSpec(sp=2))


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_stage_link_goes_through_the_host_on_gloo_only(monkeypatch,
                                                       backend):
    """A stage hand-off over gloo is staged in host memory (gloo's send
    and receive take no CUDA tensor); over NCCL the tensor stays where it
    is. A meta tensor stands for a device one: it cannot be copied to the
    host, and a buffer made on it stays there."""
    import torch.distributed as dist

    from areal_tpu_torch.parallel import pipeline as ppl

    sent, received = [], []
    monkeypatch.setattr(dist, "get_process_group_ranks", lambda g: [0, 1])
    monkeypatch.setattr(dist, "get_backend", lambda g: backend)
    monkeypatch.setattr(dist, "isend", lambda t, dst, group: (
        sent.append(t), types.SimpleNamespace(wait=lambda: None))[1])
    monkeypatch.setattr(dist, "recv",
                        lambda t, src, group: received.append(t))
    link = ppl._P2PLink(ppl.PipeCtx(pp=2, stage=0, group=object()))
    t = torch.ones(2, 3, device="cpu" if backend == "gloo" else "meta")
    link.send("fwd", 1, t)
    link.flush()
    out = link.recv("fwd", 1, 0, (2, 3), torch.float32, "meta")
    host = torch.device("cpu")
    want = host if backend == "gloo" else torch.device("meta")
    assert sent[0].device == want and received[0].device == want
    assert out.device == torch.device("meta") and out.shape == (2, 3)


# ---------------- checks, launcher, Slurm ----------------


def _async_cfg(alloc, **kw):
    from areal_tpu_torch.experiments.async_ppo_math_exp import (
        AsyncPPOMATHConfig,
    )

    return AsyncPPOMATHConfig(experiment_name="genfp", trial_name="t",
                              allocation_mode=alloc, backend="cpu",
                              n_gpus_per_node=8, **kw)


@pytest.mark.parametrize("alloc,refused", [
    ("gen.d1s2+d1", True), ("gen.d1f2p2s2+d1", True),
    ("gen.d1f2+d1", False), ("gen.d1p2+d1", False),
])
def test_both_packages_check_the_generation_axes(alloc, refused):
    """Both packages refuse ``sp`` on a generation spec, for one reason
    (the decode loop never rings), and accept ``fsdp`` and ``pp``."""
    from areal_tpu.api.cli_args import ConfigError as JConfigError
    from areal_tpu.api.cli_args import validate_config as jvalidate
    from areal_tpu.experiments.async_ppo_math_exp import (
        AsyncPPOMATHConfig as JAsync,
    )
    from areal_tpu_torch.api.cli_args import ConfigError, validate_config

    ref = JAsync(experiment_name="genfp", trial_name="t",
                 allocation_mode=alloc, n_gpus_per_node=8)
    mine = _async_cfg(alloc)
    if not refused:
        jvalidate(ref)
        validate_config(mine)
        return
    with pytest.raises(JConfigError, match="only applies to training"):
        jvalidate(ref)
    with pytest.raises(ConfigError, match="training only") as e:
        validate_config(mine)
    assert "move the sp factor into d or t" in str(e.value)


def test_decoupled_setup_gives_dp_servers_of_fpt_ranks(tmp_path):
    cfg = _async_cfg("gen.d2f2p2+d1")
    cfg.cluster.fileroot = str(tmp_path)
    setup = cfg.initial_setup()
    assert [(s.server_id, s.spec, s.rank, s.world)
            for s in setup["gen_servers"]] == [("gen0", "f2p2", 0, 4),
                                               ("gen1", "f2p2", 0, 4)]
    assert setup["gserver_manager"].n_servers == 2
    ws = cfg.build_trainer_config(async_mode=True).weight_sync
    assert ws.gen_parallel_spec is None  # stream: no device layout
    cfg.weight_sync.transport = "device"
    ws = cfg.build_trainer_config(async_mode=True).weight_sync
    assert ws.gen_parallel_spec == "d2f2p2"


def test_launcher_gives_each_server_its_four_gpus():
    from areal_tpu_torch.apps import launcher as L
    from areal_tpu_torch.system.generation_server import (
        GenerationServerConfig,
    )

    assert L.derive_server_gpus("gen.d2f2p2+d1", 9) == [
        [[1], [2], [3], [4]], [[5], [6], [7], [8]]]
    assert L.derive_server_gpus("gen.d1f2p2+d1", 5, True) == [
        [[1, 0], [2, 0], [3, 0], [4, 0]]]
    spawned = []
    launcher = L.LocalLauncher(_async_cfg("gen.d1f2p2+d1"))
    launcher.supervisor = type("S", (), {"spawn": spawned.append})()
    launcher._spawn_server(launcher.exp_cfg, GenerationServerConfig(
        server_id="gen0", spec="f2p2"), "gen_replica",
        [[1], [2], [3], [4]])
    assert [(w.name, w.group, w.rank, w.args[1].rank,
             w.env["CUDA_VISIBLE_DEVICES"]) for w in spawned] == [
        ("genserver_gen0", "genserver_gen0", 0, 0, "1"),
        ("genrank_gen0_1", "genserver_gen0", 1, 1, "2"),
        ("genrank_gen0_2", "genserver_gen0", 2, 2, "3"),
        ("genrank_gen0_3", "genserver_gen0", 3, 3, "4")]


def test_slurm_runs_a_task_per_server_rank_of_fpt(tmp_path, monkeypatch):
    from areal_tpu_torch.apps import launcher as L
    from areal_tpu_torch.apps import remote
    from areal_tpu_torch.apps.slurm import build_job_specs
    from areal_tpu_torch.system import gserver_manager

    specs = {s.name: s for s in build_job_specs(
        _async_cfg("gen.d2f2p2+d1"), "/c.yaml")}
    assert specs["genfp-gen"].ntasks == 8
    seen = []
    monkeypatch.setattr(L, "gen_server_entry", lambda exp, sc: seen.append(
        (sc.server_id, sc.spec, sc.rank)))
    monkeypatch.setattr(gserver_manager.GserverManager, "start",
                        lambda self: None)
    cfg = _async_cfg("gen.d2f2p2+d1")
    cfg.cluster.fileroot = str(tmp_path)
    for task in range(8):
        remote.run_role(cfg, "gen_fleet", rank=task, world=8)
    assert seen == [(f"gen{i}", "f2p2", r) for i in range(2)
                    for r in range(4)]


# ---------------- a killed pp follower ----------------


def _url(timeout):
    key = names.gen_servers("killfp", "t", "gen0")
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            return name_resolve.get(key)
        except name_resolve.NameEntryNotFoundError:
            time.sleep(0.2)
    raise TimeoutError(f"no server under {key} within {timeout} s")


def test_a_killed_pp_follower_respawns_all_four_ranks(tmp_path):
    """The launcher's entry under the supervisor: an f2p2 server of four
    rank processes serves; its pp follower (rank 1: fsdp 0, stage 1) is
    SIGKILLed; the leader's next /generate answers 500 and the leader ends
    its process; the supervisor brings all four ranks back (a new
    rendezvous) and the server serves again."""
    from areal_tpu_torch.apps import launcher as L
    from areal_tpu_torch.experiments import common as C
    from areal_tpu_torch.system.generation_server import (
        GenerationServerConfig,
    )
    from areal_tpu_torch.system.supervisor import RestartPolicy, Supervisor

    exp = _async_cfg("gen.d1f2p2+d1")
    exp.experiment_name, exp.trial_name = "killfp", "t"
    exp.cluster.fileroot = str(tmp_path)
    exp.mock_tokenizer = True
    exp.actor.tiny = dict(CFG, seed=0)
    old = name_resolve.DEFAULT_REPO
    C.setup_name_resolve(exp)
    sup = Supervisor("killfp", "t", policy=RestartPolicy(
        backoff_base_secs=0.1))
    launcher = L.LocalLauncher(exp)
    launcher.supervisor = sup
    sc = GenerationServerConfig(experiment="killfp", trial="t",
                                server_id="gen0", spec="f2p2",
                                chunk_tokens=8, prompt_bucket=16)
    body = {"prompt_ids": [5, 6, 7], "gconfig": {"greedy": True},
            "max_tokens": 4}
    names_ = ["genserver_gen0"] + [f"genrank_gen0_{r}" for r in (1, 2, 3)]
    try:
        launcher._spawn_server(exp, sc, "gen_replica")
        url = _url(120)
        assert _post(url, "/generate", body)[0] == 200
        assert ServerRank(ParallelSpec(fsdp=2, pp=2), 1).pp_rank == 1
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
        assert [sup.entry(n).incarnation for n in names_] == [2] * 4
        url = _url(120)
        assert _post(url, "/generate", body)[0] == 200
    finally:
        sup.shutdown(timeout=20, orderly=False)
        name_resolve.DEFAULT_REPO = old
