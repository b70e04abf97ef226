"""Weight updates of the port's generation server (areal_tpu_torch/system/
generation_server.py ``/update_weights``) and the trainer's publish
(system/trainer_worker.py), on the CPU at ``tiny_config`` size over real
localhost HTTP — the twins of tests/test_weight_stream.py's server and
trainer tests:

 - a stream update under concurrent ``/generate`` traffic: every reply
   carries the old or the new version and that version's greedy tokens;
   the swapped weights equal the published ones bit for bit; the retained
   KV states are gone;
 - a failed update of any kind (dead endpoint, corrupted / reordered /
   digest-mismatched stream, a wrong or missing tensor, an unknown or
   malformed version, a bad path, the device transport) answers 500 and
   leaves the old weights, version and stats live;
 - disk and stream deliver identical state dicts;
 - the trainer's stream and disk publishes end to end;
 - a reference native checkpoint through ``disk``: the port's logits equal
   the reference's forward within 1e-4 (float32, another summation order).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.models import hf as jhf
from areal_tpu.models import transformer as jtf
from areal_tpu_torch.api.model import FinetuneSpec, Model, make_backend
from areal_tpu_torch.api.train_config import OptimizerConfig, WeightSyncConfig
from areal_tpu_torch.backend import torch_train  # noqa: F401 (registry)
from areal_tpu_torch.base import name_resolve, names, network
from areal_tpu_torch.models import hf
from areal_tpu_torch.models.convert import params_from_jax, params_to_reference
from areal_tpu_torch.system.generation_server import (
    GenerationServer,
    GenerationServerConfig,
)
from areal_tpu_torch.system.trainer_worker import (
    TrainerWorker,
    TrainerWorkerConfig,
)
from areal_tpu_torch.system.weight_stream import WeightStreamPublisher
from test_torch_model import _jparams
from test_torch_trainer import weights
from test_torch_weight_stream import port_nr  # noqa: F401 (fixture)

EXP, TRIAL = "wsync_port", "t0"
EOS = 1
PROMPTS = [[5, 9, 17, 33], [40, 2, 8], [77, 3, 61, 12, 90, 4]]
GREEDY = {"gconfig": {"greedy": True}, "max_tokens": 4}


def _params(seed=0, scale=None):
    _, tcfg, flat = weights(seed=seed)
    params = params_from_jax(flat, tcfg, device="cpu")
    if scale is not None:
        params = {k: v * scale for k, v in params.items()}
    return tcfg, params


def _server(params=None, **kw):
    tcfg, p = _params() if params is None else params
    server = GenerationServer(GenerationServerConfig(
        chunk_tokens=4, prompt_bucket=16,
        kv_bucket=32, eos_token_id=EOS, batch_window_ms=2, **kw),
        tcfg, p, device="cpu")
    return server, server.start()


def _post(url, body, path="/generate"):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _health(url):
    with urllib.request.urlopen(url + "/health", timeout=10) as r:
        return json.loads(r.read())


def _greedy(url, prompt):
    status, r = _post(url, {"prompt_ids": prompt, **GREEDY})
    assert status == 200, r
    return r


def _assert_state(server, want):
    got = server.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def _publish(params, tcfg, version, **kw):
    pub = WeightStreamPublisher(EXP, TRIAL, "actor", **kw)
    pub.publish(sorted(params_to_reference(params, tcfg).items()), version)
    return pub


def _expected_tokens(params):
    """Greedy tokens of every prompt on a fresh server over ``params``."""
    server, url = _server(params)
    try:
        return [_greedy(url, p)["output_ids"] for p in PROMPTS]
    finally:
        server.stop()


# ------------------------------------------------------ the atomic swap


def test_atomic_swap_under_concurrent_generate(port_nr):
    tcfg, old = _params()
    _, new = _params(scale=1.25)
    want = {0: _expected_tokens((tcfg, old)), 1: _expected_tokens((tcfg, new))}
    assert want[0] != want[1]
    server, url = _server((tcfg, old))
    pub = _publish(new, tcfg, 1)
    replies, stop = [], threading.Event()

    def load():
        i = 0
        while not stop.is_set() and i < 2000:
            r = _greedy(url, PROMPTS[i % len(PROMPTS)])
            replies.append((i % len(PROMPTS), r))
            i += 1

    try:
        status, r = _post(url, {"prompt_ids": PROMPTS[0], "rid": "keep",
                                "gconfig": {"greedy": True},
                                "max_tokens": 8})
        assert status == 200 and server.stats()["kv_states"] == 1
        client = threading.Thread(target=load, daemon=True)
        client.start()
        deadline = time.monotonic() + 30
        while len(replies) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        status, body = _post(url, {"endpoint": pub.endpoint, "version": 1},
                             path="/update_weights")
        assert status == 200 and body["ok"] and body["version"] == 1
        n_at_swap = len(replies)
        deadline = time.monotonic() + 30
        while len(replies) < n_at_swap + 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        stop.set()
        client.join(timeout=30)
        assert not client.is_alive()
        versions = [r["version"] for _, r in replies]
        assert set(versions) == {0, 1} and versions[-1] == 1
        assert versions == sorted(versions)  # never back to the old weights
        for i, r in replies:
            assert r["output_ids"] == want[r["version"]][i]
        assert _health(url)["version"] == 1
        stats = server.stats()
        assert stats["version"] == 1 and stats["kv_states"] == 0
        assert stats["last_weight_update_latency_s"] > 0
        assert stats["last_stream_stream_bytes"] == sum(
            v.numel() * 4 for v in new.values())
        assert stats["last_stream_upload_secs"] > 0
        _assert_state(server, new)
    finally:
        stop.set()
        pub.close()
        server.stop()


# ------------------------------------------------------- failed updates


def _corrupt(pub):
    entry = pub._cache[1]
    entry.arrays[0] = entry.arrays[0].copy()
    entry.arrays[0][5] ^= 0x10


def _reorder(pub):
    orig = pub._handle

    def lie(frames):
        reply = orig(frames)
        if frames[0] == b"chunk":
            meta = json.loads(reply[1])
            meta["tensor"] = (meta["tensor"] + 1) % 3
            reply[1] = json.dumps(meta).encode()
        return reply

    pub._handle = lie


def _bad_digest(pub):
    orig = pub._handle

    def lie(frames):
        reply = orig(frames)
        if frames[0] == b"digest":
            d = json.loads(reply[1])
            d["crcs"][-1][0] ^= 1
            reply[1] = json.dumps(d).encode()
        return reply

    pub._handle = lie


def _failing_body(kind, tcfg, new, tmp_path):
    """(the /update_weights body, the publisher to close or None)."""
    if kind == "dead_endpoint":
        return {"endpoint": f"tcp://127.0.0.1:{network.find_free_port()}",
                "version": 1, "timeout": 1}, None
    if kind in ("bad_path", "no_path"):
        return ({"path": str(tmp_path / "missing"), "version": 1}
                if kind == "bad_path" else {"version": 1}), None
    if kind == "device":
        return {"device": True, "version": 1}, None
    if kind == "bad_version":
        # A loadable checkpoint: the version fails before the load.
        hf.save_native_checkpoint(new, tcfg, str(tmp_path / "v1"))
        return {"path": str(tmp_path / "v1"), "version": "one"}, None
    ref = params_to_reference(new, tcfg)
    if kind == "wrong_shape":
        ref["final_ln"] = torch.zeros(ref["final_ln"].numel() + 1)
    elif kind == "missing_tensor":
        del ref["final_ln"]
    elif kind == "extra_tensor":
        ref["layers/router"] = torch.zeros(2, 3)
    pub = WeightStreamPublisher(EXP, TRIAL, "actor", chunk_bytes=1024)
    pub.publish(sorted(ref.items()), 1)
    assert pub.wait_complete(1, timeout=10)
    {"corrupted": _corrupt, "reordered": _reorder,
     "digest_mismatch": _bad_digest}.get(kind, lambda p: None)(pub)
    version = 9 if kind == "unknown_version" else 1
    return {"endpoint": pub.endpoint, "version": version, "timeout": 5}, pub


@pytest.mark.parametrize("kind", [
    "dead_endpoint", "corrupted", "reordered", "digest_mismatch",
    "wrong_shape", "missing_tensor", "extra_tensor", "unknown_version",
    "bad_path", "no_path", "device", "bad_version"])
def test_failed_update_keeps_old_weights_and_500s(kind, port_nr, tmp_path):
    tcfg, old = _params()
    _, new = _params(scale=1.25)
    server, url = _server((tcfg, old))
    body, pub = _failing_body(kind, tcfg, new, tmp_path)
    try:
        before_tokens = _greedy(url, PROMPTS[1])["output_ids"]
        before_stats = server.stats()
        status, reply = _post(url, body, path="/update_weights")
        assert status == 500, reply
        assert reply["ok"] is False and reply["version"] == 0
        assert _health(url)["version"] == 0
        _assert_state(server, old)
        r = _greedy(url, PROMPTS[1])
        assert r["version"] == 0 and r["output_ids"] == before_tokens
        after = server.stats()
        for k in ("version", "last_weight_update_latency_s"):
            assert after[k] == before_stats[k]
        assert not any(k.startswith("last_stream_") for k in after)
    finally:
        if pub is not None:
            pub.close()
        server.stop()


# --------------------------------------------------- transport parity


def test_disk_and_stream_deliver_identical_state_dicts(port_nr, tmp_path):
    tcfg, _ = _params()
    _, new = _params(seed=4)
    new = {k: v.to(torch.bfloat16) for k, v in new.items()}
    live = (tcfg, {k: v.to(torch.bfloat16) for k, v in _params()[1].items()})
    a, url_a = _server(live)
    b, url_b = _server(live)
    disk = str(tmp_path / "v1")
    hf.save_native_checkpoint(new, tcfg, disk)
    pub = _publish(new, tcfg, 1)
    try:
        assert _post(url_a, {"endpoint": pub.endpoint, "version": 1},
                     path="/update_weights")[0] == 200
        assert _post(url_b, {"path": disk, "version": 1},
                     path="/update_weights")[0] == 200
        _assert_state(a, new)
        _assert_state(b, new)
        assert a.version == b.version == 1
        assert "last_stream_stream_bytes" not in b.stats()
        assert a.stats()["last_stream_stream_bytes"] == sum(
            v.numel() * 2 for v in new.values())
    finally:
        pub.close()
        a.stop()
        b.stop()


def test_hf_checkpoint_through_disk(port_nr, tmp_path):
    """A directory in the HF layout (not a native publish) applies too."""
    tcfg, old = _params()
    _, new = _params(seed=5)
    path = str(tmp_path / "hf")
    hf.save_hf_checkpoint(new, tcfg, path)
    server, url = _server((tcfg, old))
    try:
        status, body = _post(url, {"path": path}, path="/update_weights")
        assert status == 200 and body["version"] == 1  # version + 1 default
        _assert_state(server, new)
    finally:
        server.stop()


def test_reference_native_checkpoint_through_disk(port_nr, tmp_path):
    """The reference's native publish applied to a port server: its logits
    equal the reference forward on the same weights within 1e-4 (f32)."""
    jcfg, tcfg, flat = weights(seed=6)
    path = str(tmp_path / "ref_native")
    jhf.save_native_checkpoint(_jparams(flat), jcfg, path, meta={"version": 3})
    server, url = _server()
    try:
        status, body = _post(url, {"path": path, "version": 3},
                             path="/update_weights")
        assert status == 200 and body["version"] == 3
        rng = np.random.RandomState(2)
        tokens = rng.randint(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
        pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
        seg = np.ones((2, 12), np.int32)
        jl, _ = jtf.forward(_jparams(flat), jcfg, jnp.asarray(tokens),
                            jnp.asarray(pos), segment_ids=jnp.asarray(seg))
        with torch.no_grad():
            tl, _ = server.model(torch.from_numpy(tokens),
                                 torch.from_numpy(pos.copy()),
                                 segment_ids=torch.from_numpy(seg))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    finally:
        server.stop()


# ------------------------------------------------- the trainer's publish


def _engine(compute_dtype="bfloat16", seed=7):
    _, tcfg, flat = weights(seed=seed)
    model = make_backend(
        "torch_train", optimizer=OptimizerConfig(lr=1e-3), device="cpu",
        compute_dtype=compute_dtype,
    ).initialize(Model("actor", (tcfg, params_from_jax(flat, tcfg,
                                                       device="cpu"))),
                 FinetuneSpec(1, 8, 4))
    model.version.global_step = 3
    return tcfg, model


def test_trainer_stream_publish_end_to_end(port_nr, tmp_path):
    """``transport="stream"``: nothing under ``realloc_dir``; the version,
    its publish time and the endpoint are registered; a consumer receives
    the engine's compute-dtype parameters; a server applies them."""
    from areal_tpu_torch.system.weight_stream import WeightStreamConsumer

    tcfg, model = _engine()
    realloc = tmp_path / "never"
    w = TrainerWorker(TrainerWorkerConfig(
        experiment=EXP, trial=TRIAL, realloc_dir=str(realloc),
        weight_sync=WeightSyncConfig(transport="stream")))
    w.models["actor"] = model  # setup()-free: the publish half only
    server, url = _server()
    try:
        t0 = time.time()
        w.publish_weights("actor")
        assert not realloc.exists()
        v = int(name_resolve.get(names.model_version(EXP, TRIAL, "actor")))
        assert v == 3
        t_pub = float(name_resolve.get(
            names.model_version_time(EXP, TRIAL, "actor")))
        assert t0 - 1 <= t_pub <= time.time()
        endpoint = name_resolve.get(names.weight_stream(EXP, TRIAL, "actor"))
        want = w._compute_dtype_params("actor")
        assert all(t.dtype == torch.bfloat16 for t in want.values())
        consumer = WeightStreamConsumer(endpoint, timeout_secs=10)
        try:
            _, got = consumer.fetch(v)
        finally:
            consumer.close()
        ref = params_to_reference(want, tcfg)
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == torch.bfloat16 and torch.equal(got[k],
                                                                  ref[k]), k
        status, body = _post(url, {"endpoint": endpoint, "version": v},
                             path="/update_weights")
        assert status == 200 and body["version"] == 3
        # the f32 server holds the bf16 publish cast up
        _assert_state(server, {k: t.float() for k, t in want.items()})
    finally:
        w.close()
        server.stop()
    with pytest.raises(name_resolve.NameEntryNotFoundError):
        name_resolve.get(names.weight_stream(EXP, TRIAL, "actor"))


def test_trainer_disk_publish_end_to_end(port_nr, tmp_path):
    """``transport="disk"``: a native checkpoint at
    ``realloc_dir/<role>/<version>`` that both packages read; a stale
    stream key is deleted; a server applies the checkpoint."""
    tcfg, model = _engine(compute_dtype="float32")
    name_resolve.add(names.weight_stream(EXP, TRIAL, "actor"),
                     "tcp://127.0.0.1:1")
    w = TrainerWorker(TrainerWorkerConfig(
        experiment=EXP, trial=TRIAL, realloc_dir=str(tmp_path / "realloc"),
        weight_sync=WeightSyncConfig(transport="disk")))
    w.models["actor"] = model  # setup()-free: the publish half only
    server, url = _server()
    try:
        w.publish_weights("actor")
        path = str(tmp_path / "realloc" / "actor" / "3")
        assert hf.is_native_checkpoint(path) and jhf.is_native_checkpoint(path)
        with pytest.raises(name_resolve.NameEntryNotFoundError):
            name_resolve.get(names.weight_stream(EXP, TRIAL, "actor"))
        assert name_resolve.get(names.model_version(EXP, TRIAL, "actor")) == "3"
        _, jparams = jhf.load_checkpoint_auto(path)
        want = params_to_reference(model.module.params, tcfg)
        for k, v in jhf.flatten_pytree(jparams, as_numpy=True).items():
            np.testing.assert_array_equal(v, want[k].numpy(), k)
        status, body = _post(url, {"path": path, "version": 3},
                             path="/update_weights")
        assert status == 200
        _assert_state(server, {k: v.detach() for k, v in
                               model.module.params.items()})
    finally:
        w.close()
        server.stop()


def test_device_transport_raises():
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        WeightSyncConfig(transport="device")
    with pytest.raises(ValueError):
        WeightSyncConfig(transport="carrier_pigeon")
    assert WeightSyncConfig().transport == "stream"
    w = TrainerWorker(TrainerWorkerConfig())
    w.cfg.weight_sync.transport = "device"
    with pytest.raises(ValueError):
        w.publish_weights("actor")
