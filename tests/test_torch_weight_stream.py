"""The port's streamed weight transport (areal_tpu_torch/system/
weight_stream.py) against the reference's (areal_tpu/system/
weight_stream.py): the twins of tests/test_weight_stream.py's protocol and
integrity tests, the publisher's ownership of what it serves, and both
directions across the packages — the reference's zmq sockets bridged to the
port's frame handlers. Every transfer is bit for bit; every wait is bounded
to seconds; every publisher and consumer is closed in a ``finally``.
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zmq

from areal_tpu.base import name_resolve as jnr
from areal_tpu.models.hf import flatten_pytree
from areal_tpu.system import weight_stream as jws
from areal_tpu_torch.api.model import FinetuneSpec, Model, make_backend
from areal_tpu_torch.api.train_config import OptimizerConfig
from areal_tpu_torch.api.train_config import WeightSyncConfig
from areal_tpu_torch.backend import torch_train  # noqa: F401 (registry)
from areal_tpu_torch.base import name_resolve, names
from areal_tpu_torch.models.convert import params_from_jax, params_to_reference
from areal_tpu_torch.system import weight_stream as tws
from areal_tpu_torch.system.trainer_worker import (
    TrainerWorker,
    TrainerWorkerConfig,
)
from test_torch_model import _jparams
from test_torch_trainer import weights

EXP, TRIAL = "wstest_port", "t0"


@pytest.fixture()
def port_nr(tmp_path):
    """The port's name_resolve on a fresh NFS root for one test."""
    old = name_resolve.DEFAULT_REPO
    name_resolve.DEFAULT_REPO = name_resolve.NfsNameRecordRepo(
        str(tmp_path / "nr"))
    yield name_resolve.DEFAULT_REPO
    name_resolve.DEFAULT_REPO = old


def _tensors(seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {
        "embedding": torch.randn(64, 16, generator=g).to(dtype),
        "layers/wq": torch.randn(2, 16, 16, generator=g).to(dtype),
        "layers/ln1": torch.randn(2, 16, generator=g).to(dtype),
        "final_ln": torch.randn(16, generator=g).to(dtype),
    }


def _publish(tensors, version=1, **kw) -> tws.WeightStreamPublisher:
    pub = tws.WeightStreamPublisher(EXP, TRIAL, "actor", **kw)
    pub.publish(sorted(tensors.items()), version)
    return pub


def _bits(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(t).tobytes()


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == tuple(w.shape), k
        assert str(g.dtype).removeprefix("torch.") == \
            str(w.dtype).removeprefix("torch."), k
        assert _bits(g) == _bits(w), k


# ------------------------------------------------------------ round trip


def test_manifest_roundtrip_bitexact(port_nr):
    tensors = _tensors()
    pub = _publish(tensors, version=3, chunk_bytes=1024)  # force multi-chunk
    endpoint = name_resolve.get(names.weight_stream(EXP, TRIAL, "actor"))
    assert endpoint == pub.endpoint and endpoint.startswith("tcp://")
    consumer = tws.WeightStreamConsumer(endpoint, timeout_secs=10)
    try:
        manifest, flat = consumer.fetch(3)
        assert manifest["version"] == 3
        assert manifest["total_bytes"] == sum(
            t.numel() * 4 for t in tensors.values())
        assert max(t["n_chunks"] for t in manifest["tensors"]) > 1
        assert [t["name"] for t in manifest["tensors"]] == sorted(tensors)
        _assert_same(flat, tensors)
        assert consumer.bytes_received == manifest["total_bytes"]
    finally:
        consumer.close()
        pub.close()
    with pytest.raises(name_resolve.NameEntryNotFoundError):
        name_resolve.get(names.weight_stream(EXP, TRIAL, "actor"))


def test_bf16_wire_format_preserved(port_nr):
    tensors = {"w": torch.arange(32, dtype=torch.float32).to(torch.bfloat16)}
    pub = _publish(tensors)
    consumer = tws.WeightStreamConsumer(pub.endpoint, timeout_secs=10)
    try:
        manifest, flat = consumer.fetch(1)
        spec = manifest["tensors"][0]
        assert spec["dtype"] == "bfloat16" and spec["nbytes"] == 2 * 32
        assert flat["w"].dtype == torch.bfloat16
        assert torch.equal(flat["w"], tensors["w"])
    finally:
        consumer.close()
        pub.close()


def test_unknown_version_and_replay(port_nr):
    pub = _publish(_tensors(), version=5)
    c1 = tws.WeightStreamConsumer(pub.endpoint, timeout_secs=5)
    c2 = tws.WeightStreamConsumer(pub.endpoint, timeout_secs=5)
    try:
        with pytest.raises(tws.WeightStreamError, match="not cached"):
            c1.fetch_manifest(4)
        # per-server replay: two consumers fetch the same publish
        _, f1 = c1.fetch(5)
        _, f2 = c2.fetch(5)
        _assert_same(f1, f2)
    finally:
        c1.close()
        c2.close()
        pub.close()


def test_keep_versions_replays_the_last_publishes(port_nr):
    pub = tws.WeightStreamPublisher(EXP, TRIAL, "actor", keep_versions=2)
    consumer = tws.WeightStreamConsumer(pub.endpoint, timeout_secs=5)
    try:
        for v in (1, 2, 3):
            pub.publish(sorted(_tensors(seed=v).items()), v)
        assert pub.wait_complete(3, timeout=10)
        with pytest.raises(tws.WeightStreamError, match="not cached"):
            consumer.fetch_manifest(1)
        for v in (2, 3):
            _, flat = consumer.fetch(v)
            _assert_same(flat, _tensors(seed=v))
    finally:
        consumer.close()
        pub.close()


# ------------------------------------------------------- integrity gates


def test_corrupted_chunk_rejected(port_nr):
    """Bytes corrupted in the publisher's cache AFTER checksumming fail the
    consumer's wire CRC check."""
    pub = _publish(_tensors(), chunk_bytes=1024)
    assert pub.wait_complete(1, timeout=10)
    entry = pub._cache[1]
    entry.arrays[0] = entry.arrays[0].copy()
    entry.arrays[0][3] ^= 0xFF
    consumer = tws.WeightStreamConsumer(pub.endpoint, timeout_secs=5)
    try:
        with pytest.raises(tws.WeightStreamError, match="checksum mismatch"):
            consumer.fetch(1)
    finally:
        consumer.close()
        pub.close()


def test_reordered_stream_rejected(port_nr):
    """A reply whose echoed (tensor, chunk) is not the requested one
    aborts."""
    pub = _publish(_tensors(), chunk_bytes=512)
    assert pub.wait_complete(1, timeout=10)
    orig = pub._handle

    def swapped(frames):
        reply = orig(frames)
        if frames[0] == b"chunk":
            meta = json.loads(reply[1])
            meta["chunk"] += 1  # lie about which chunk this is
            reply[1] = json.dumps(meta).encode()
        return reply

    pub._handle = swapped
    consumer = tws.WeightStreamConsumer(pub.endpoint, timeout_secs=5)
    try:
        with pytest.raises(tws.WeightStreamError, match="out-of-order"):
            consumer.fetch(1)
    finally:
        consumer.close()
        pub.close()


def test_digest_catches_divergent_crcs(port_nr):
    pub = _publish(_tensors(), chunk_bytes=1024)
    assert pub.wait_complete(1, timeout=10)
    consumer = tws.WeightStreamConsumer(pub.endpoint, timeout_secs=5)
    try:
        manifest = consumer.fetch_manifest(1)
        list(consumer.iter_tensors(1, manifest))
        consumer._local_crcs[0][0] ^= 1  # a silently-wrong chunk
        with pytest.raises(tws.WeightStreamError, match="digest mismatch"):
            consumer.verify_digest(1)
    finally:
        consumer.close()
        pub.close()


def test_consumer_death_midstream_leaves_publisher_serving(port_nr):
    pub = _publish(_tensors(), chunk_bytes=256)
    dead = tws.WeightStreamConsumer(pub.endpoint, timeout_secs=5)
    survivor = tws.WeightStreamConsumer(pub.endpoint, timeout_secs=10)
    try:
        manifest = dead.fetch_manifest(1)
        it = dead.iter_tensors(1, manifest)
        next(it)  # pull one tensor, leave requests in flight...
        dead.close()  # ...and die
        _, flat = survivor.fetch(1)
        _assert_same(flat, _tensors())
    finally:
        dead.close()
        survivor.close()
        pub.close()


def test_dead_endpoint_raises_within_its_timeout(port_nr):
    from areal_tpu_torch.base import network

    consumer = tws.WeightStreamConsumer(
        f"tcp://127.0.0.1:{network.find_free_port()}", timeout_secs=2)
    try:
        with pytest.raises(tws.WeightStreamError, match="cannot reach"):
            consumer.fetch_manifest(1)
    finally:
        consumer.close()


def test_chunk_request_waits_for_the_gather(port_nr):
    """A request for a tensor the gather has not produced waits, is not
    refused, and other consumers' manifests keep flowing meanwhile."""
    gate = threading.Event()
    tensors = _tensors()
    pub = tws.WeightStreamPublisher(EXP, TRIAL, "actor", chunk_bytes=1024)
    orig = pub._gather_leaves

    def slow(p):
        assert gate.wait(10)
        orig(p)

    pub._gather_leaves = slow
    pub.publish(sorted(tensors.items()), 1)
    waiting = tws.WeightStreamConsumer(pub.endpoint, timeout_secs=10)
    other = tws.WeightStreamConsumer(pub.endpoint, timeout_secs=5)
    out = {}
    try:
        t = threading.Thread(target=lambda: out.update(waiting.fetch(1)[1]),
                             daemon=True)
        t.start()
        assert other.fetch_manifest(1)["version"] == 1
        assert not out
        gate.set()
        t.join(timeout=10)
        assert not t.is_alive()
        _assert_same(out, tensors)
    finally:
        gate.set()
        waiting.close()
        other.close()
        pub.close()


def test_close_wakes_a_request_waiting_on_the_gather(port_nr):
    """``close()`` while a consumer waits on a gather that never finishes:
    the consumer gets an error at once, not at its timeout, and no
    connection thread is left behind."""
    gate = threading.Event()
    pub = tws.WeightStreamPublisher(EXP, TRIAL, "actor")
    orig = pub._gather_leaves

    def stuck(p):
        assert gate.wait(10)
        orig(p)

    pub._gather_leaves = stuck
    pub.publish(sorted(_tensors().items()), 1)
    consumer = tws.WeightStreamConsumer(pub.endpoint, timeout_secs=8)
    errors = []

    def fetch():
        try:
            consumer.fetch(1)
        except tws.WeightStreamError as e:
            errors.append(e)

    t = threading.Thread(target=fetch, daemon=True)
    try:
        t.start()
        deadline = time.monotonic() + 5
        while not pub._conns and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pub._conns
        t0 = time.monotonic()
        pub.close()
        t.join(timeout=5)
        assert not t.is_alive() and time.monotonic() - t0 < 4
        assert len(errors) == 1
        deadline = time.monotonic() + 5
        while pub._conns and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not pub._conns
    finally:
        gate.set()
        consumer.close()
        pub.close()


def test_many_consumers_at_once(port_nr):
    """More consumers than cores fetch one publish together under a short
    switch interval: each connection's thread answers its requests in
    order, and every transfer verifies bit for bit."""
    import os
    import sys

    tensors = _tensors(seed=9)
    pub = _publish(tensors, chunk_bytes=512)
    n = min(os.cpu_count() or 8, 62) + 2
    consumers = [tws.WeightStreamConsumer(pub.endpoint, pipeline_depth=3,
                                          timeout_secs=30) for _ in range(n)]
    results, errors = [None] * n, []

    def run(i):
        try:
            results[i] = consumers[i].fetch(1)[1]
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        for r in results:
            _assert_same(r, tensors)
    finally:
        sys.setswitchinterval(old)
        for c in consumers:
            c.close()
        pub.close()


# ------------------------------------------------- the publish owns its bytes


def test_publish_serves_pre_step_bytes_after_an_optimizer_step(port_nr,
                                                               tmp_path):
    """The trainer's stream publish of f32 masters in an f32 compute dtype
    (where the cast returns the master itself), then at once an optimizer
    step that updates the masters in place: a consumer still receives the
    published bytes, and its CRCs verify."""
    jcfg, tcfg, flat = weights(seed=1)
    model = make_backend(
        "torch_train", optimizer=OptimizerConfig(lr=1e-2), device="cpu",
        compute_dtype="float32",
    ).initialize(Model("actor", (tcfg, params_from_jax(flat, tcfg,
                                                       device="cpu"))),
                 FinetuneSpec(1, 8, 4))
    eng = model.module
    before = {k: v.detach().clone() for k, v in eng.params.items()}
    w = TrainerWorker(TrainerWorkerConfig(
        experiment=EXP, trial=TRIAL, realloc_dir=str(tmp_path / "never"),
        weight_sync=WeightSyncConfig(transport="stream", chunk_mb=1)),
        models={"actor": model})
    try:
        owned = w._compute_dtype_params("actor")
        assert all(owned[k].data_ptr() != p.data_ptr()
                   for k, p in eng.params.items())
        w.publish_weights("actor")
        ps = list(eng.params.values())
        eng.optimizer.step(ps, [torch.ones_like(p) for p in ps],
                           torch.tensor(1.0), 0.5)
        assert not torch.equal(eng.params["final_ln.weight"],
                               before["final_ln.weight"])
        consumer = tws.WeightStreamConsumer(
            name_resolve.get(names.weight_stream(EXP, TRIAL, "actor")),
            timeout_secs=10)
        try:
            _, got = consumer.fetch(0)  # verifies the digest
        finally:
            consumer.close()
        _assert_same(got, params_to_reference(before, tcfg))
    finally:
        w.close()


# ------------------------------------------------------- across packages


def _jax_tree(dtype):
    jcfg, tcfg, flat = weights(seed=2)
    tree = jax.tree.map(lambda x: x.astype(dtype), _jparams(flat))
    return tcfg, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_publisher_to_port_consumer(dtype, tmp_name_resolve):
    """The reference publishes a pytree; the port's consumer, its socket a
    zmq DEALER, reads it and ``params_from_jax`` gives the port state dict
    whose reference layout is the published tree bit for bit."""
    tcfg, tree = _jax_tree(getattr(jnp, dtype))
    jpub = jws.WeightStreamPublisher(EXP, TRIAL, "actor", chunk_bytes=2048)
    jpub.publish(sorted(flatten_pytree(tree).items()), 4)
    consumer = tws.WeightStreamConsumer(jpub.endpoint, timeout_secs=10)
    consumer._sock = zmq.Context.instance().socket(zmq.DEALER)
    consumer._sock.connect(jnr.get(
        f"areal_tpu/{EXP}/{TRIAL}/weight_stream/actor"))
    try:
        manifest, got = consumer.fetch(4)
        want = flatten_pytree(jax.device_get(tree), as_numpy=True)
        assert max(t["n_chunks"] for t in manifest["tensors"]) > 1
        _assert_same(got, want)
        params = params_from_jax(got, tcfg, device="cpu")
        assert params["final_ln.weight"].dtype == getattr(torch, dtype)
        _assert_same(params_to_reference(params, tcfg), want)
    finally:
        consumer.close()
        jpub.close()


class _RouterBridge:
    """A zmq ROUTER that answers the reference's consumer through the port
    publisher's ``_handle``."""

    def __init__(self, pub):
        self.pub = pub
        self.sock = zmq.Context.instance().socket(zmq.ROUTER)
        self.endpoint = "tcp://127.0.0.1:%d" % self.sock.bind_to_random_port(
            "tcp://127.0.0.1")
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _loop(self):
        while not self.stop.is_set():
            if not self.sock.poll(50):
                continue
            ident, *frames = self.sock.recv_multipart()
            try:
                reply = self.pub._handle(frames)
            except tws.WeightStreamError as e:
                reply = [b"err", str(e).encode()]
            self.sock.send_multipart([ident, *reply])

    def close(self):
        self.stop.set()
        self.thread.join(timeout=5)
        self.sock.close(linger=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_publisher_to_jax_consumer(dtype, port_nr):
    _, tcfg, flat = weights(seed=3)
    params = {k: v.to(dtype) for k, v in
              params_from_jax(flat, tcfg, device="cpu").items()}
    ref = params_to_reference(params, tcfg)
    pub = tws.WeightStreamPublisher(EXP, TRIAL, "actor", chunk_bytes=2048)
    pub.publish(sorted(ref.items()), 6)
    assert pub.wait_complete(6, timeout=10)
    bridge = _RouterBridge(pub)
    consumer = jws.WeightStreamConsumer(bridge.endpoint, timeout_secs=10)
    try:
        manifest, got = consumer.fetch(6)
        assert max(t["n_chunks"] for t in manifest["tensors"]) > 1
        _assert_same(got, ref)
    finally:
        consumer.close()
        bridge.close()
        pub.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk_bytes", [512, 1 << 20])
def test_both_packages_publish_equal_manifests_and_digests(
        dtype, chunk_bytes, port_nr, tmp_name_resolve):
    tcfg, tree = _jax_tree(getattr(jnp, dtype))
    jflat = flatten_pytree(tree)
    # The same f32 numbers, cast in each package (both round to nearest).
    tparams = {k: v.to(getattr(torch, dtype)) for k, v in params_from_jax(
        weights(seed=2)[2], tcfg, device="cpu").items()}
    jpub = jws.WeightStreamPublisher(EXP, TRIAL, "actor",
                                     chunk_bytes=chunk_bytes)
    tpub = tws.WeightStreamPublisher(EXP, TRIAL, "actor",
                                     chunk_bytes=chunk_bytes)
    try:
        jpub.publish(sorted(jflat.items()), 2)
        tpub.publish(sorted(params_to_reference(tparams, tcfg).items()), 2)
        assert jpub.wait_complete(2, timeout=10)
        assert tpub.wait_complete(2, timeout=10)
        for cmd in (b"manifest", b"digest"):
            req = [cmd, json.dumps({"version": 2}).encode()]
            assert jpub._handle(req) == tpub._handle(req), cmd
        req = [b"chunk", json.dumps({"version": 2, "tensor": 0,
                                     "chunk": 0}).encode()]
        jr, tr = jpub._handle(req), tpub._handle(req)
        assert jr[:2] == tr[:2] and bytes(jr[2]) == bytes(tr[2])
    finally:
        jpub.close()
        tpub.close()
