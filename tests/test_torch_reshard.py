"""The port's resharding core and ``device`` weight-sync transport
(areal_tpu_torch/parallel/reshard.py) — twin of ``tests/test_reshard.py``
and of ``tests/test_system_async_ppo.py::test_device_transport_weight_bump_e2e``.

 - plans: leaves already in place pass through (the same objects), the
   moved ones go in groups bounded by bytes, a tree mismatch is refused;
 - layouts on a mesh (a spawned world of 2 ranks over gloo): values
   survive every move, and the host path equals the device path;
 - the manifest digest: stable, bound to the version, equal to the
   reference's for the same manifest;
 - a publication crossing processes (a spawned publisher; on the CPU the
   buffer is a shared-memory file where a card uses a CUDA IPC handle):
   every gate raises with the reference's message (missing, version
   skew, digest, tree, shape) and the dead-publisher gate too; latest
   wins; the consume casts to the live dtype;
 - the manager's transport detection (device, then stream, then disk; a
   skewed device descriptor falls through);
 - a server's ``/update_weights`` over ``device``: 200 with bit-equal
   weights, 500 with the old weights kept.
"""

import json
import multiprocessing as mp
import os
import shutil
import types

import pytest
import torch

from areal_tpu_torch.base import name_resolve, names
from areal_tpu_torch.models import config as tconfig
from areal_tpu_torch.models.transformer import init_params
from areal_tpu_torch.parallel import distributed as D
from areal_tpu_torch.parallel import mesh as pmesh
from areal_tpu_torch.parallel import reshard as rsh
from test_torch_weight_stream import port_nr  # noqa: F401 (fixture)

EXP, TRIAL = "reshard_port", "t0"
CFG = dict(vocab_size=64, use_attention_bias=True)


def _cfg():
    return tconfig.tiny_config(**CFG)


def _params(seed=0, dtype=torch.float32):
    return init_params(_cfg(), seed, device="cpu", dtype=dtype)


# ---------------- plans ----------------


def test_same_layout_publish_moves_nothing_and_copies_nothing(port_nr):
    params = _params()
    new, plan = rsh.reshard_pytree(params, rsh.shardings_like(
        params, torch.device("cpu")))
    assert plan.n_moved == 0 and plan.moved_bytes == 0 and not plan.groups
    assert set(plan.identical) == set(params)
    assert all(new[n] is params[n] for n in params)
    # a publication packs the leaves as the trainer holds them (whole, on
    # one device: the layout un-meshed servers hold), bit for bit
    pub = rsh.publish_device(EXP, TRIAL, "actor", params, version=1)
    try:
        assert [e["name"] for e in pub.manifest] == sorted(params)
        assert all(torch.equal(rsh._leaf_view(
            pub.buffer, pub.offsets[e["name"]], e), params[e["name"]])
            for e in pub.manifest)
    finally:
        rsh.clear_publication(EXP, TRIAL, "actor")


def test_plan_groups_bound_bytes():
    params = {f"w{i}": torch.zeros(256, 256) for i in range(6)}  # 256 KiB
    plan = rsh.plan_reshard(params, rsh.shardings_like(
        params, torch.device("meta")), group_bytes=600 << 10)
    assert plan.n_moved == 6 and len(plan.groups) == 3
    assert all(sum(params[n].numel() * 4 for n in g) <= 600 << 10
               for g in plan.groups)
    assert plan.moved_bytes == plan.total_bytes == 6 << 18
    out = rsh.execute_reshard(params, rsh.shardings_like(
        params, torch.device("meta")), plan)
    assert all(t.device.type == "meta" for t in out.values())


def test_plan_rejects_tree_mismatch():
    params = _params()
    dst = rsh.shardings_like(params, torch.device("cpu"))
    dst.pop("embedding.weight")
    with pytest.raises(ValueError, match="trees differ"):
        rsh.plan_reshard(params, dst)
    with pytest.raises(ValueError, match="trees differ"):
        rsh.reshard_via_host(params, dst)


# ---------------- layouts on a mesh ----------------

MOVES = [("f2", "t2"), ("t2", "f2"), ("f2", None), (None, "d2")]


def _rank_moves(rank, world, seed):
    from torch.distributed.tensor import DTensor

    from areal_tpu_torch.parallel import sharding as psh

    cfg = _cfg()
    params = _params(seed)
    out = {}
    for src, dst in MOVES:
        mesh = lambda s: pmesh.make_mesh(pmesh.ParallelSpec.parse(s))  # noqa
        live = (params if src is None
                else psh.shard_params(params, mesh(src), cfg))
        target = (torch.device("cpu") if dst is None
                  else rsh.model_shardings(mesh(dst), cfg))
        target = rsh.shardings_like(live, target)
        moved, plan = rsh.reshard_pytree(live, target, group_mb=1)
        host = rsh.reshard_via_host(live, target)
        whole = {n: (t.full_tensor() if isinstance(t, DTensor) else t)
                 for n, t in moved.items()}
        host_whole = {n: (t.full_tensor() if isinstance(t, DTensor) else t)
                      for n, t in host.items()}
        layouts_ok = all(rsh._equivalent(moved[n], target[n])
                         for n in moved)
        if rank == 0:
            out[(src, dst)] = (
                layouts_ok, plan.n_moved, len(plan.groups),
                all(torch.equal(whole[n], params[n]) for n in params),
                all(torch.equal(host_whole[n], params[n]) for n in params),
                all(rsh._equivalent(host[n], target[n]) for n in host))
    return out


@pytest.fixture(scope="module")
def world2_moves():
    return D.run_ranks(_rank_moves, 2, 3, timeout=180)[0]


@pytest.mark.parametrize("move", MOVES)
def test_values_survive_a_layout_change(world2_moves, move):
    layouts_ok, n_moved, n_groups, equal, _, _ = world2_moves[move]
    assert layouts_ok and equal
    assert n_moved > 0 and n_groups >= 1


@pytest.mark.parametrize("move", MOVES)
def test_host_path_matches_device_path(world2_moves, move):
    _, _, _, equal, host_equal, host_layouts = world2_moves[move]
    assert equal and host_equal and host_layouts


# ---------------- the manifest digest ----------------


def test_manifest_digest_is_stable_version_bound_and_the_references():
    import jax.numpy as jnp

    from areal_tpu.parallel import reshard as jrsh

    flat = {"a": torch.zeros(3, 4), "b": torch.zeros(5, dtype=torch.bfloat16),
            "c": torch.zeros(2, 2, dtype=torch.int32)}
    man = rsh.build_manifest(flat)
    assert rsh.manifest_digest(man, 3) == rsh.manifest_digest(
        rsh.build_manifest(dict(reversed(list(flat.items())))), 3)
    assert rsh.manifest_digest(man, 3) != rsh.manifest_digest(man, 4)
    jflat = {"a": jnp.zeros((3, 4), jnp.float32),
             "b": jnp.zeros((5,), jnp.bfloat16),
             "c": jnp.zeros((2, 2), jnp.int32)}
    jman = jrsh.build_manifest(jflat)
    assert man == jman
    assert rsh.manifest_digest(man, 3) == jrsh.manifest_digest(jman, 3)


# ---------------- a publication across processes ----------------


def _publisher(nr_root, cmds, replies):
    """A spawned trainer stand-in: publish seed-1 weights at v1 (packed in
    bf16), then serve commands: ``("publish", v)`` or ``"exit"``."""
    from areal_tpu_torch.base import name_resolve as nr

    nr.DEFAULT_REPO = nr.NfsNameRecordRepo(nr_root)
    params = _params(1)
    pub = rsh.publish_device(EXP, TRIAL, "actor", params, version=1,
                             dtype=torch.bfloat16)
    replies.put((pub.digest, pub.path))
    while True:
        cmd = cmds.get(timeout=120)
        if cmd == "exit":
            return
        pub = rsh.publish_device(EXP, TRIAL, "actor", params, version=cmd[1],
                                 dtype=torch.bfloat16)
        replies.put((pub.digest, pub.path))


def _gate(fn):
    try:
        fn()
    except rsh.DeviceReshardError as e:
        return str(e)
    return None


@pytest.fixture(scope="module")
def cross_process(tmp_path_factory):
    """Publish in a spawned process and consume here: every outcome of the
    scenario, in order."""
    root = str(tmp_path_factory.mktemp("nr_reshard"))
    old = name_resolve.DEFAULT_REPO
    name_resolve.DEFAULT_REPO = name_resolve.NfsNameRecordRepo(root)
    ctx = mp.get_context("spawn")
    cmds, replies = ctx.Queue(), ctx.Queue()
    proc = ctx.Process(target=_publisher, args=(root, cmds, replies),
                       daemon=True)
    proc.start()
    res = {}
    try:
        digest, path1 = replies.get(timeout=120)
        live32, live16 = _params(0), _params(0, torch.bfloat16)
        want16 = {n: t.to(torch.bfloat16) for n, t in _params(1).items()}

        def consume(version=1, d=None, live=live32, role="actor"):
            return rsh.consume_device(EXP, TRIAL, role, version,
                                      digest if d is None else d, live)

        res["record"] = rsh.lookup_publication(EXP, TRIAL, "actor")
        res["f32"] = consume()
        res["bf16"] = consume(live=live16)
        res["want16"] = want16
        res["missing"] = _gate(lambda: consume(role="critic"))
        res["skew"] = _gate(lambda: consume(version=2))
        res["digest"] = _gate(lambda: consume(d="00000000"))
        res["tree"] = _gate(lambda: consume(live={
            k: v for k, v in live32.items() if k != "final_ln.weight"}))
        res["shape"] = _gate(lambda: consume(live={
            **live32, "final_ln.weight": torch.zeros(7)}))
        cmds.put(("publish", 2))
        digest2, path2 = replies.get(timeout=120)
        res["latest"] = (rsh.lookup_publication(EXP, TRIAL, "actor"),
                         os.path.exists(path1), os.path.exists(path2),
                         _gate(lambda: consume(version=1)))
        res["v2"] = rsh.consume_device(EXP, TRIAL, "actor", 2, digest2,
                                       live32)
        proc.kill()
        proc.join(30)
        res["dead"] = _gate(lambda: rsh.consume_device(
            EXP, TRIAL, "actor", 2, digest2, live32))
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join(10)
        # the killed publisher's last publication: its file and claims
        rec = rsh.lookup_publication(EXP, TRIAL, "actor")
        if rec is not None:
            shutil.rmtree(rec["claims"], ignore_errors=True)
            if rec["shares"][0]["kind"] == "file":
                try:
                    os.unlink(rec["shares"][0]["path"])
                except FileNotFoundError:
                    pass
        name_resolve.DEFAULT_REPO = old
    return res


def test_publication_record_names_its_buffer(cross_process):
    rec = cross_process["record"]
    assert rec["version"] == 1 and rec["pid"] != os.getpid()
    # no server is registered: two shares
    assert [s["kind"] for s in rec["shares"]] == ["file", "file"]
    assert os.path.isabs(rec["claims"])
    assert [e["name"] for e in rec["manifest"]] == sorted(rec["offsets"])
    assert all(e["dtype"] == "bfloat16" for e in rec["manifest"])
    assert rec["digest"] == rsh.manifest_digest(rec["manifest"], 1)


def test_consume_across_processes_casts_to_the_live_dtype(cross_process):
    want = cross_process["want16"]
    for name, t in cross_process["bf16"].items():
        assert t.dtype == torch.bfloat16 and torch.equal(t, want[name]), name
    for name, t in cross_process["f32"].items():
        assert t.dtype == torch.float32
        assert torch.equal(t, want[name].float()), name


@pytest.mark.parametrize("gate,text", [
    ("missing", "no device publication for (reshard_port, t0, critic)"),
    ("skew", "version skew: registry holds v1, fanout asked for v2"),
    ("digest", "digest mismatch for v1"),
    ("tree", "tree mismatch: 1 leaves differ"),
    ("shape", "published shape [32] != live [7]"),
])
def test_consume_gates_raise(cross_process, gate, text):
    msg = cross_process[gate]
    assert msg is not None and text in msg, msg


def test_latest_wins(cross_process):
    rec, old_exists, new_exists, skew = cross_process["latest"]
    assert rec["version"] == 2 and not old_exists and new_exists
    # v1's claims directory went with it
    assert not os.path.exists(cross_process["record"]["claims"])
    assert "registry holds v2, fanout asked for v1" in skew
    want = cross_process["want16"]
    assert all(torch.equal(t, want[n].float())
               for n, t in cross_process["v2"].items())


def test_dead_publisher_gate(cross_process):
    msg = cross_process["dead"]
    assert msg is not None and "is gone" in msg


def test_consume_refuses_a_buffer_that_is_gone(port_nr):
    """A publication whose buffer vanished (its file removed) raises; it
    never reads a fresh, zero-filled file in its place."""
    pub = rsh.publish_device(EXP, TRIAL, "actor", _params(), version=1)
    try:
        os.unlink(pub.path)
        with pytest.raises(rsh.DeviceReshardError, match="opening its buffer"):
            rsh.consume_device(EXP, TRIAL, "actor", 1, pub.digest, _params())
        assert not os.path.exists(pub.path)
    finally:
        rsh.clear_publication(EXP, TRIAL, "actor")


def test_each_consume_claims_a_share_until_none_is_left(port_nr):
    """A consume takes one share of the publication (so that each
    consumer's mapping releases its own count on a card); with every share
    taken the next consume raises, and withdrawing the publication claims
    what is left and removes its claims directory. The shares follow the
    registered servers: twice their number, plus two."""
    name_resolve.add(names.gen_servers(EXP, TRIAL, "gen0"), "http://x",
                     replace=True)
    pub = rsh.publish_device(EXP, TRIAL, "actor", _params(1), version=1)
    try:
        n = len(pub.record["shares"])
        assert n == 4
        for _ in range(n - 1):
            rsh.consume_device(EXP, TRIAL, "actor", 1, pub.digest, _params())
        assert sorted(os.listdir(pub.claims)) == [str(i)
                                                  for i in range(n - 1)]
        rsh.clear_publication(EXP, TRIAL, "actor")
        assert not os.path.exists(pub.claims)
        pub = rsh.publish_device(EXP, TRIAL, "actor", _params(1), version=2)
        for _ in range(n):
            rsh.consume_device(EXP, TRIAL, "actor", 2, pub.digest, _params())
        with pytest.raises(rsh.DeviceReshardError, match="no share"):
            rsh.consume_device(EXP, TRIAL, "actor", 2, pub.digest, _params())
    finally:
        rsh.clear_publication(EXP, TRIAL, "actor")


# ---------------- the manager's detection ----------------


def _payload(v):
    from areal_tpu_torch.system.gserver_manager import GserverManager

    fake = types.SimpleNamespace(cfg=types.SimpleNamespace(
        experiment=EXP, trial=TRIAL, model_role="actor"))
    return GserverManager._update_payload(fake, v, "/ckpt/v")


def test_manager_detects_device_then_stream_then_disk(port_nr):
    assert _payload(3) == {"path": "/ckpt/v", "version": 3}
    name_resolve.add(names.weight_stream(EXP, TRIAL, "actor"),
                     "tcp://127.0.0.1:1", replace=True)
    assert _payload(3) == {"endpoint": "tcp://127.0.0.1:1", "version": 3}
    name_resolve.add(names.weight_device(EXP, TRIAL, "actor"), json.dumps(
        {"pid": 1, "version": 3, "digest": "abcd1234"}), replace=True)
    assert _payload(3) == {"device": True, "role": "actor",
                           "digest": "abcd1234", "version": 3}


def test_manager_skewed_device_descriptor_falls_through(port_nr):
    name_resolve.add(names.weight_device(EXP, TRIAL, "actor"), json.dumps(
        {"pid": 1, "version": 2, "digest": "abcd1234"}), replace=True)
    assert _payload(3) == {"path": "/ckpt/v", "version": 3}
    name_resolve.add(names.weight_stream(EXP, TRIAL, "actor"),
                     "tcp://127.0.0.1:1", replace=True)
    assert _payload(3)["endpoint"] == "tcp://127.0.0.1:1"


# ---------------- a server's /update_weights over device ----------------


def test_server_update_over_device(port_nr):
    from test_torch_weight_sync import _assert_state, _greedy, _health, _post

    from areal_tpu_torch.system.generation_server import (
        GenerationServer,
        GenerationServerConfig,
    )

    cfg = _cfg()
    old, new = _params(0), _params(2)
    server = GenerationServer(GenerationServerConfig(
        experiment=EXP, trial=TRIAL, chunk_tokens=4, prompt_bucket=16,
        kv_bucket=32, eos_token_id=CFG["vocab_size"], batch_window_ms=2),
        cfg, old,
        device="cpu")
    url = server.start()
    try:
        pub = rsh.publish_device(EXP, TRIAL, "actor", new, version=1)
        status, _ = _post(url, {"prompt_ids": [5, 9, 17], "rid": "keep",
                                "gconfig": {"greedy": True},
                                "max_tokens": 8})
        assert status == 200 and server.stats()["kv_states"] == 1
        before = _greedy(url, [5, 9, 17, 33])["output_ids"]
        bad = {"device": True, "role": "actor", "digest": "0" * 8,
               "version": 1}
        status, reply = _post(url, bad, path="/update_weights")
        assert status == 500 and reply["version"] == 0
        assert "digest mismatch" in reply["error"]
        _assert_state(server, old)
        assert server.stats()["kv_states"] == 1
        assert _greedy(url, [5, 9, 17, 33])["output_ids"] == before
        ok = dict(bad, digest=pub.digest)
        status, reply = _post(url, ok, path="/update_weights")
        assert status == 200 and reply["version"] == 1
        assert _health(url)["version"] == 1
        _assert_state(server, new)
        assert server.stats()["kv_states"] == 0
    finally:
        rsh.clear_publication(EXP, TRIAL, "actor")
        server.stop()
