"""The port's serving engine (areal_tpu_torch/system/serving.py) and its
wiring through the server, the manager, the client, the config tree and the
async loop, on the CPU, against the reference's (areal_tpu/system/
serving.py and tests/test_serving.py, tests/test_kv_reuse.py):

 - bookkeeping parity, both packages fed the same seeded operations: the
   shape policy's buckets, refusals and rounding; the prefix trie; the KV
   store's evictions, pins and version gate (both modules' clocks replaced
   by one counter each, so LRU order is the operations' order); the queue's
   admissions, rejections and drain order; the engine's 413 checks;
 - server parity, both packages' servers on one numpy-seeded
   ``tiny_config`` in f32, greedy: prefix seeding's tokens with reuse on
   and off and the reference's (logprobs within 1e-4), ``prefill_tokens``,
   the prefix counters and the shapes observed; the savings gate; a
   budget-truncated donor and the exact-match clone; the donor's KV bytes
   unchanged by the requests it seeds; a store cleared between the acquire
   and the clone;
 - HTTP: the 429 and 413 replies (status, body, ``Retry-After``) of both
   packages, an unknown class of any JSON type served as rollout by both,
   class priority under contention, the randomized shape bound with the
   scrape, and ``perf_probe decode-bench``;
 - the manager's class routing, replies and per-class gauges against the
   reference's;
 - the chunked client's 429 backoff and its clamp of an oversized hint;
 - the ``serving.*`` overrides and ``validate_config``'s errors;
 - the async loop with the engine on and an interactive probe through the
   manager (the reference's tests/test_system_async_ppo.py:331).

Every wait is bounded.
"""

import asyncio
import collections
import dataclasses
import functools
import hashlib
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler

import numpy as np
import pytest
import torch

from areal_tpu.api.model import GenerationHyperparameters as JGen
from areal_tpu.api.train_config import ServingConfig as JServingConfig
from areal_tpu.system import serving as J
from areal_tpu_torch.api.model import GenerationHyperparameters as TGen
from areal_tpu_torch.api.train_config import ServingConfig as TServingConfig
from areal_tpu_torch.system import serving as T

WAIT = 60.0  # bound on every wait


def _scfg(pkg="port", **kw):
    kw.setdefault("enabled", True)
    kw.setdefault("max_kv_capacity", 256)
    return (TServingConfig if pkg == "port" else JServingConfig)(**kw)


def _outcome(fn, *a, **k):
    """A call's result, or the refusal it raised, comparably."""
    try:
        return ("ok", fn(*a, **k))
    except (J.PromptTooLong, T.PromptTooLong) as e:
        return ("too_long", e.needed, e.cap)
    except (J.AdmissionReject, T.AdmissionReject) as e:
        return ("reject", e.cls, e.depth, e.limit, e.retry_after)
    except ValueError as e:
        return ("value_error", str(e))


# ------------------------------------------------------------- shape policy

GEN = dict(kv_bucket=256, chunk_tokens=128, max_batch_size=64,
           prompt_bucket=128)
POLICY_CASES = [
    ({}, GEN),
    ({"enabled": False}, GEN),
    ({"max_kv_capacity": 16384, "max_compiled_shapes": 512}, GEN),
    ({"max_kv_capacity": 1024, "max_compiled_shapes": 64},
     dict(kv_bucket=128, chunk_tokens=16, max_batch_size=8, prompt_bucket=128)),
    ({"row_buckets": [1, 2, 4]},
     dict(kv_bucket=32, chunk_tokens=4, max_batch_size=8, prompt_bucket=8)),
    ({"row_buckets": [1, 2, 4]},
     dict(kv_bucket=32, chunk_tokens=4, max_batch_size=4, prompt_bucket=8)),
    ({"chunk_buckets": [256]},
     dict(kv_bucket=32, chunk_tokens=4, max_batch_size=4, prompt_bucket=8)),
    ({"chunk_buckets": [248]},
     dict(kv_bucket=32, chunk_tokens=4, max_batch_size=4, prompt_bucket=8)),
    ({"max_kv_capacity": 128, "max_compiled_shapes": 48},
     dict(kv_bucket=32, chunk_tokens=4, max_batch_size=4, prompt_bucket=8)),
    ({"max_kv_capacity": 16384, "max_compiled_shapes": 16}, GEN),
    ({"chunk_buckets": [8, 16], "row_buckets": [1, 4, 16, 64],
      "max_kv_capacity": 4096}, GEN),
    ({"max_kv_capacity": 256},
     dict(kv_bucket=32, chunk_tokens=6, max_batch_size=64, prompt_bucket=8)),
]


@pytest.mark.parametrize("over,kw", POLICY_CASES)
def test_policy_from_config_matches_reference(over, kw):
    """The same buckets, or the same refusal, and then the same rounding
    over a sweep through every bucket edge."""
    pols = {}
    for pkg, mod in (("port", T), ("ref", J)):
        pols[pkg] = _outcome(mod.policy_from_config,
                             _scfg(pkg, **{"max_kv_capacity": 256, **over}),
                             **kw)
    assert pols["port"][0] == pols["ref"][0], pols
    if pols["ref"][0] != "ok":
        assert pols["port"] == pols["ref"]
        return
    tp, jp = pols["port"][1], pols["ref"][1]
    for attr in ("quantum", "capacity_buckets", "chunk_buckets",
                 "row_buckets", "width_buckets", "max_shapes"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    edges = set(range(0, 300))
    for b in [*(jp.capacity_buckets or []), *(jp.width_buckets or []),
              *(jp.chunk_buckets or []), *(jp.row_buckets or [])]:
        edges |= {b - 1, b, b + 1}
    for n in sorted(edges):
        for fn in ("round_capacity", "round_width", "round_chunk",
                   "round_chunk_down", "round_rows", "fits"):
            assert _outcome(getattr(tp, fn), n) == \
                _outcome(getattr(jp, fn), n), (fn, n)


@pytest.mark.parametrize("kw,max_shapes", [
    (dict(capacity_buckets=list(range(64, 64 * 20, 64)),
          chunk_buckets=[2, 4, 8, 16], row_buckets=[1, 2, 4, 8]), 16),
    (dict(capacity_buckets=[64, 128, 256], chunk_buckets=[8],
          row_buckets=[1, 2, 4], width_buckets=[8, 16, 32, 248]), 33),
    (dict(capacity_buckets=[64, 128, 256], chunk_buckets=[8],
          row_buckets=[1, 2, 4], width_buckets=[8, 16, 32, 248]), 32),
])
def test_shape_bound_refusal_matches_reference(kw, max_shapes):
    got = [_outcome(mod.ShapeBucketPolicy, quantum=32, max_shapes=max_shapes,
                    **kw) for mod in (T, J)]
    assert got[0][0] == got[1][0]
    if got[1][0] != "ok":
        assert got[0] == got[1]


def test_shape_policy_records_distinct_shapes():
    pol = T.ShapeBucketPolicy(quantum=32, capacity_buckets=[64, 128, 256],
                              chunk_buckets=[4, 8], row_buckets=[1, 2, 4],
                              max_shapes=64)
    pol.observe("decode", 2, 64, 8)
    pol.observe("decode", 2, 64, 8)  # once
    pol.observe("prefill", 2, 16, 64)
    assert pol.distinct_shapes == 2
    assert pol.shapes() == [("decode", 2, 64, 8), ("prefill", 2, 16, 64)]


@pytest.mark.parametrize("cls", ["interactive", "eval", "rollout", "bogus",
                                 "interactve", None, 5, ["rollout"],
                                 {"class": "eval"}, ""])
def test_normalize_class_matches_reference(cls):
    assert T.normalize_class(cls) == J.normalize_class(cls)


# ------------------------------------------------------------- prefix trie


def _trie_dump(node):
    return (sorted(node.rids), {t: _trie_dump(c)
                                for t, c in sorted(node.children.items())})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_trie_matches_reference(seed):
    """Seeded insert / extend / remove / longest on both tries: equal
    answers and equal structure (pruning included) after every step."""
    rng = np.random.RandomState(seed)
    tries = (T.PrefixTrie(), J.PrefixTrie())
    live = {}
    for step in range(300):
        op = rng.randint(4)
        rid = f"r{rng.randint(8)}"
        if op == 0 and rid not in live:
            toks = rng.randint(1, 4, rng.randint(1, 9))
            live[rid] = toks
            for t in tries:
                t.insert(rid, toks)
        elif op == 1 and rid in live:
            suf = rng.randint(1, 4, rng.randint(0, 4))
            got = [t.extend(rid, suf) for t in tries]
            assert got[0] == got[1]
            live[rid] = np.concatenate([live[rid], suf])
        elif op == 2 and rid in live:
            for t in tries:
                t.remove(rid, live[rid])
            del live[rid]
        else:
            q = rng.randint(1, 4, rng.randint(0, 10)).tolist()
            assert tries[0].longest(q) == tries[1].longest(q), (step, q)
        assert _trie_dump(tries[0]._root) == _trie_dump(tries[1]._root)
    for rid, toks in list(live.items()):
        for t in tries:
            t.remove(rid, toks)
    assert not tries[0]._root.children  # fully pruned


# ------------------------------------------------- KV store: pins, budgets


class _Arr:
    def __init__(self, n):
        self.nbytes = n


def _fake_state(nbytes):
    return {"kv_k": _Arr(nbytes), "kv_v": _Arr(nbytes)}


@pytest.fixture()
def counted_clocks(monkeypatch):
    """Each serving module's clock a counter of its own: both stores see
    the same timestamps for the same operations."""
    for mod in (T, J):
        ticks = iter(range(1, 10**9))
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=lambda ticks=ticks: float(next(ticks))))


@pytest.mark.parametrize("seed,slots,budget", [
    (0, 4, 1 << 30), (1, 100, 200), (2, 3, 96), (3, 0, 1 << 30),
    (4, 6, 150)])
def test_kv_store_matches_reference(counted_clocks, seed, slots, budget):
    """Seeded put / pop / get / acquire / release / evict / clear: the same
    answers, evictions, pins and survivors."""
    rng = np.random.RandomState(seed)
    stores = (T.KVStateStore(slots, budget, prefix_reuse=True),
              J.KVStateStore(slots, budget, prefix_reuse=True))
    mods = (T, J)
    tokens = {}
    pinned = []
    for step in range(400):
        op = rng.randint(10)
        rid = f"r{rng.randint(10)}"
        if op <= 2:
            if rid in tokens and rng.rand() < 0.6:  # the next chunk
                toks = np.concatenate([tokens[rid],
                                       rng.randint(1, 4, rng.randint(1, 4))])
            else:
                toks = rng.randint(1, 4, rng.randint(2, 10))
            tokens[rid] = toks
            version = int(rng.rand() < 0.1)
            nb = int(rng.randint(4, 40))
            for mod, kv in zip(mods, stores):
                kv.put(rid, mod.ReqState(_fake_state(nb), cur_len=len(toks),
                                         version=version, tokens=toks))
        elif op == 3:
            got = [kv.pop(rid) for kv in stores]
            assert (got[0] is None) == (got[1] is None)
            tokens.pop(rid, None)
        elif op in (4, 5):
            q = rng.randint(1, 4, rng.randint(1, 12)).tolist()
            ml = int(rng.randint(1, 5))
            got = [kv.acquire_prefix(q, version=0, min_len=ml)
                   for kv in stores]
            assert got[0] == got[1], (step, q)
            if got[0] is not None:
                pinned.append(got[0][0])
        elif op == 6 and pinned:
            rid = pinned.pop(rng.randint(len(pinned)))
            for kv in stores:
                kv.release(rid)
        elif op in (7, 8):
            assert stores[0].evict() == stores[1].evict()
        elif op == 9 and rng.rand() < 0.1:
            for kv in stores:
                kv.clear()
            tokens.clear()
            pinned.clear()
        view = [sorted((r, s.cur_len, s.version, s.pins, s.nbytes)
                       for r, s in kv._states.items()) for kv in stores]
        assert view[0] == view[1], step
        assert stores[0].count == stores[1].count
        assert stores[0].nbytes == stores[1].nbytes


def test_pinned_donor_survives_eviction(counted_clocks):
    """The reference's test_kv_store_refcounted_pin_survives_eviction on
    the port: a pinned LRU state is never evicted; released, it is the
    next victim."""
    kv = T.KVStateStore(slots=2, bytes_budget=1 << 30, prefix_reuse=True)
    for i in range(3):
        kv.put(f"r{i}", T.ReqState(_fake_state(8), cur_len=4, version=0,
                                   tokens=np.asarray([9, 9, 9, i])))
    assert kv.acquire_prefix([9, 9, 9, 0, 5], version=0, min_len=2) == \
        ("r0", 4)
    kv.evict()
    assert kv.get("r0") is not None and kv.count <= 2
    kv.release("r0")
    assert kv.get("r0").pins == 0
    kv.get("r0").last_used = 0.0
    kv.put("r9", T.ReqState(_fake_state(8), cur_len=4, version=0,
                            tokens=np.asarray([1, 1, 1, 1])))
    kv.evict()
    assert kv.count <= 2 and kv.get("r0") is None


# ----------------------------------------------- queue: admission, priority

QUEUE_CASES = [
    dict(queue_limit_rollout=2, queue_limit_interactive=1,
         queue_limit_eval=3, retry_after_secs=0.7, min_rollout_share=0.0),
    dict(queue_limit_rollout=6, queue_limit_interactive=4,
         queue_limit_eval=2, min_rollout_share=0.25),
    dict(queue_limit_rollout=0, queue_limit_interactive=3,
         queue_limit_eval=0, min_rollout_share=0.5),
    dict(min_rollout_share=1.0),
    dict(enabled=False, queue_limit_rollout=1),
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("over", QUEUE_CASES)
def test_queue_matches_reference(over, seed):
    """Seeded puts (each admitted or refused), drains and pops: the same
    refusals and the same order out, with and without the rollout share."""
    rng = np.random.RandomState(seed)
    qs = (T.ServingQueue(_scfg("port", **over)),
          J.ServingQueue(_scfg("ref", **over)))
    n = 0
    for step in range(300):
        op = rng.randint(6)
        if op <= 2:
            cls = T.REQUEST_CLASSES[rng.randint(3)]
            got = [_outcome(q.put, f"{cls}{n}", cls) for q in qs]
            assert got[0] == got[1], step
            n += 1
        elif op <= 4:
            k = int(rng.randint(0, 8))
            assert qs[0].drain(k) == qs[1].drain(k), step
        else:
            got = []
            for q in qs:
                try:
                    got.append(q.get_nowait())
                except IndexError:
                    got.append(None)
            assert got[0] == got[1]
        for cls in T.REQUEST_CLASSES:
            assert qs[0].depth(cls) == qs[1].depth(cls)
        assert qs[0].qsize() == qs[1].qsize()


def test_queue_close_passes_limits_and_priority():
    """The runner's stop: close() wakes a blocked get, which then returns
    what is queued (in priority order) and None once empty; a put after
    the close raises."""
    q = T.ServingQueue(_scfg(queue_limit_rollout=1))
    got = []
    t = threading.Thread(target=lambda: got.append(q.get()), daemon=True)
    t.start()
    time.sleep(0.05)
    q.close()
    t.join(WAIT)
    assert not t.is_alive() and got == [None]
    q2 = T.ServingQueue(_scfg(queue_limit_rollout=1))
    q2.put("r", "rollout")
    q2.put("i", "interactive")
    q2.close()
    assert [q2.get(), q2.get(), q2.get()] == ["i", "r", None]
    with pytest.raises(RuntimeError):
        q2.put("late", "rollout")


def test_queue_admission_is_atomic_under_threads():
    """64 threads race 16 puts each at a class limit of 100 while a drain
    thread pops: no put is lost, none admitted past the limit, every
    admitted request comes out exactly once."""
    import sys

    q = T.ServingQueue(_scfg(queue_limit_rollout=100, min_rollout_share=0))
    admitted, rejected, out = [], [], []
    lock = threading.Lock()
    stop = threading.Event()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def producer(i):
            for j in range(16):
                try:
                    q.put((i, j), "rollout")
                    with lock:
                        admitted.append((i, j))
                except T.AdmissionReject as e:
                    assert e.depth >= 100
                    with lock:
                        rejected.append((i, j))
                assert q.depth("rollout") <= 100

        def consumer():
            while not stop.is_set() or not q.empty():
                out.extend(q.drain(7))
                time.sleep(0)

        c = threading.Thread(target=consumer, daemon=True)
        c.start()
        ps = [threading.Thread(target=producer, args=(i,), daemon=True)
              for i in range(64)]
        for p in ps:
            p.start()
        for p in ps:
            p.join(WAIT)
        stop.set()
        c.join(WAIT)
        assert not c.is_alive() and not any(p.is_alive() for p in ps)
    finally:
        sys.setswitchinterval(old)
    assert len(admitted) + len(rejected) == 64 * 16
    assert sorted(out) == sorted(admitted)


@pytest.mark.parametrize("prompt_len,planned", [
    (8, None), (8, 300), (8, 250), (8, 249), (247, None), (248, None),
    (249, None), (100, 150), (1, 1), (200, 260)])
def test_admit_matches_reference(prompt_len, planned):
    """The engine's 413 check on the bucketed width and ``planned_len``,
    then the queue bound: the same outcome and queue depth."""
    engines = [mod.ServingEngine(
        _scfg(pkg, queue_limit_rollout=1), kv_slots=4,
        kv_bytes_budget=1 << 20, kv_bucket=32, chunk_tokens=4,
        max_batch_size=4, prompt_bucket=8)
        for pkg, mod in (("port", T), ("ref", J))]
    for _ in range(2):  # the second one meets the limit of 1
        got = [_outcome(e.admit, object(), "rollout", prompt_len=prompt_len,
                        planned_len=planned) for e in engines]
        assert got[0] == got[1]
        assert engines[0].queue.depth("rollout") == \
            engines[1].queue.depth("rollout")


# ------------------------------------------------------- server parity

EOS = 96


@pytest.fixture(scope="module")
def weights():
    from test_torch_model import make_model

    jcfg, tcfg, flat, _ = make_model("qwen2", seed=5)
    return jcfg, tcfg, flat


def _port_server(weights, serving=None, **kw):
    from areal_tpu_torch.models.convert import params_from_jax
    from areal_tpu_torch.system.generation_server import (
        GenerationServer,
        GenerationServerConfig,
    )

    _, tcfg, flat = weights
    kw = {"chunk_tokens": 6, "prompt_bucket": 8, "kv_bucket": 32,
          "eos_token_id": EOS, "batch_window_ms": 1, **kw}
    return GenerationServer(
        GenerationServerConfig(experiment="servtest", trial="t0",
                               serving=serving or TServingConfig(), **kw),
        tcfg, params_from_jax(flat, tcfg, device="cpu"), device="cpu")


def _ref_server(weights, serving=None, **kw):
    from areal_tpu.system.generation_server import (
        GenerationServer,
        GenerationServerConfig,
    )
    from test_torch_model import _jparams

    jcfg, _, flat = weights
    kw = {"chunk_tokens": 6, "prompt_bucket": 8, "kv_bucket": 32,
          "eos_token_id": EOS, "batch_window_ms": 1, **kw}
    return GenerationServer(
        GenerationServerConfig(experiment="servtest", trial="t0",
                               serving=serving or JServingConfig(), **kw),
        jcfg, _jparams(flat))


def _reuse_servers(weights):
    """Port servers with reuse on and off and the reference's with it on
    (reference test_kv_reuse.py:_serving_server's settings)."""
    def cfg(pkg, reuse):
        return _scfg(pkg, prefix_reuse=reuse, min_prefix_tokens=4)

    ref = _ref_server(weights, cfg("ref", True))
    ref.telemetry = _Recorder()  # its prefix counters
    return {"on": _port_server(weights, cfg("port", True)),
            "off": _port_server(weights, cfg("port", False)), "ref": ref}


class _Recorder:
    """A stand-in for the reference server's telemetry that keeps its
    counters."""

    enabled = False

    def __init__(self):
        self.counts = collections.Counter()

    def inc(self, name, n=1):
        self.counts[name] += n

    def __getattr__(self, name):
        return lambda *a, **k: None


def _decode_one(server, prompt, rid, max_tokens=6):
    if hasattr(server, "device"):  # the port's
        from areal_tpu_torch.system.generation_server import _Pending

        p = _Pending(np.asarray(prompt, np.int64),
                     TGen(greedy=True, max_new_tokens=max_tokens),
                     max_tokens, rid=rid)
        with torch.inference_mode():
            (res,) = server._decode_batch([p])
        return res
    from areal_tpu.system.generation_server import _Pending as JPending

    (res,) = server._decode_batch([JPending(
        prompt=np.asarray(prompt, np.int32),
        gconfig=JGen(greedy=True, max_new_tokens=max_tokens),
        max_tokens=max_tokens, future=None, rid=rid)])
    return res


def _prefill_tokens(s):
    return s._prefill_tokens


def _counters(servers):
    names = ("serving/prefix_hits", "serving/prefix_tokens_saved",
             "serving/prefix_skipped_no_savings")
    return ({k: servers["on"].stats()[k] for k in names},
            {k: servers["ref"].telemetry.counts[k] for k in names})


def _digest(state):
    h = hashlib.sha256()
    for k in ("kv_k", "kv_v", "last_logits", "cur_len"):
        h.update(state[k].contiguous().view(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def _same_reply(a, b):
    assert a["output_ids"] == b["output_ids"]
    np.testing.assert_allclose(a["output_logprobs"], b["output_logprobs"],
                               rtol=0, atol=1e-4)
    assert a["finished"] == b["finished"] and a["version"] == b["version"]


def test_prefix_seeding_matches_reference(weights):
    """Twin of test_kv_reuse.py:244: greedy tokens equal with reuse on, off
    and the reference's; only the suffix prefilled; the counters and the
    shapes observed equal the reference's; the donor's bytes unchanged;
    parity after the donor is gone."""
    rng = np.random.RandomState(5)
    prompt_a = rng.randint(2, 90, 12).tolist()
    prompt_b = prompt_a[:8] + rng.randint(2, 90, 4).tolist()
    srv = _reuse_servers(weights)
    res_a = {k: _decode_one(s, prompt_a, "ra") for k, s in srv.items()}
    assert len(res_a["ref"]["output_ids"]) == 6  # kept: a full allowance
    _same_reply(res_a["on"], res_a["ref"])
    _same_reply(res_a["off"], res_a["ref"])
    assert srv["on"].kv.count == srv["ref"].serving.kv.count == 1
    donor = _digest(srv["on"].kv.get("ra").state)

    before = {k: _prefill_tokens(s) for k, s in srv.items()}
    res_b = {k: _decode_one(s, prompt_b, "rb") for k, s in srv.items()}
    for k in ("on", "off"):
        _same_reply(res_b[k], res_b["ref"])
    delta = {k: _prefill_tokens(s) - before[k] for k, s in srv.items()}
    assert delta == {"on": len(prompt_b) - 8, "off": len(prompt_b),
                     "ref": len(prompt_b) - 8}
    ours, theirs = _counters(srv)
    assert ours == theirs and ours["serving/prefix_hits"] == 1
    assert srv["on"].stats()["extend_calls"] == 1
    assert _digest(srv["on"].kv.get("ra").state) == donor
    assert srv["on"].shapes.shapes() == srv["ref"].serving.shapes.shapes()

    # the donor gone: a full prefill, the same tokens
    for k in ("on", "ref"):
        (srv[k].kv if k == "on" else srv[k].serving.kv).clear()
    before = {k: _prefill_tokens(srv[k]) for k in ("on", "ref")}
    for k in ("on", "ref"):
        res = _decode_one(srv[k], prompt_b, "rc")
        assert res["output_ids"] == res_b["ref"]["output_ids"]
        assert _prefill_tokens(srv[k]) - before[k] == len(prompt_b)


def test_savings_gate_matches_reference(weights):
    """Twin of test_kv_reuse.py:288: a shared prefix of min_prefix_tokens
    whose bucketed suffix is as wide as the prompt's prefill rides the
    plain prefill, counted as prefix_skipped_no_savings."""
    rng = np.random.RandomState(11)
    prompt_a = rng.randint(2, 90, 8).tolist()
    prompt_b = prompt_a[:4] + [(t + 1) % 90 + 2 for t in prompt_a[4:]]
    srv = _reuse_servers(weights)
    for s in srv.values():
        _decode_one(s, prompt_a, "ra")
    before = {k: _prefill_tokens(s) for k, s in srv.items()}
    res = {k: _decode_one(s, prompt_b, "rb") for k, s in srv.items()}
    assert {k: _prefill_tokens(s) - before[k] for k, s in srv.items()} == \
        {k: len(prompt_b) for k in srv}
    for k in ("on", "off"):
        _same_reply(res[k], res["ref"])
    ours, theirs = _counters(srv)
    assert ours == theirs
    assert ours["serving/prefix_skipped_no_savings"] == 1
    assert ours["serving/prefix_hits"] == 0
    assert srv["on"].shapes.shapes() == srv["ref"].serving.shapes.shapes()


def test_budget_truncated_donor_clone_matches_reference(weights):
    """Twin of test_kv_reuse.py:315: a donor kept after its own budget (3 <
    chunk 6) seeds an exact-match pure clone (no prefill) with the tokens
    of reuse off and of the reference's; the clone's decode leaves the
    donor's bytes as they were, so a second clone of it decodes the same."""
    rng = np.random.RandomState(9)
    prompt_a = rng.randint(2, 90, 10).tolist()
    srv = _reuse_servers(weights)
    res_a = {k: _decode_one(s, prompt_a, "ra", max_tokens=3)
             for k, s in srv.items()}
    assert len(res_a["ref"]["output_ids"]) == 3
    _same_reply(res_a["on"], res_a["ref"])
    assert srv["on"].kv.count == 1
    donor = _digest(srv["on"].kv.get("ra").state)

    prompt_b = prompt_a + res_a["ref"]["output_ids"]
    before = {k: _prefill_tokens(s) for k, s in srv.items()}
    res_b = {k: _decode_one(s, prompt_b, "rb", max_tokens=4)
             for k, s in srv.items()}
    assert _prefill_tokens(srv["on"]) == before["on"]  # no prefill
    assert _prefill_tokens(srv["ref"]) == before["ref"]
    assert srv["on"].stats()["extend_calls"] == 0
    for k in ("on", "off"):
        _same_reply(res_b[k], res_b["ref"])
    ours, theirs = _counters(srv)
    assert ours == theirs
    assert ours["serving/prefix_tokens_saved"] == len(prompt_b)
    assert _digest(srv["on"].kv.get("ra").state) == donor

    srv["on"].kv.pop("rb")
    res_c = _decode_one(srv["on"], prompt_b, "rc", max_tokens=4)
    assert res_c["output_ids"] == res_b["ref"]["output_ids"]
    assert _digest(srv["on"].kv.get("ra").state) == donor
    assert srv["on"].shapes.shapes() == srv["ref"].serving.shapes.shapes()


def test_store_cleared_between_acquire_and_clone(weights):
    """/update_weights clears the store from a handler thread while the
    runner holds a pin: the runner finds no donor and prefills plainly,
    with the tokens of a server without reuse."""
    rng = np.random.RandomState(5)
    prompt_a = rng.randint(2, 90, 12).tolist()
    prompt_b = prompt_a[:8] + rng.randint(2, 90, 4).tolist()
    srv = _reuse_servers(weights)
    for k in ("on", "off"):
        _decode_one(srv[k], prompt_a, "ra")
    kv = srv["on"].kv
    acquire = kv.acquire_prefix

    def acquire_then_clear(*a, **k):
        got = acquire(*a, **k)
        kv.clear()  # the swap lands here
        return got

    kv.acquire_prefix = acquire_then_clear
    before = _prefill_tokens(srv["on"])
    res = _decode_one(srv["on"], prompt_b, "rb")
    assert _prefill_tokens(srv["on"]) - before == len(prompt_b)
    assert srv["on"].stats()["serving/prefix_hits"] == 0
    assert res["output_ids"] == _decode_one(srv["off"], prompt_b,
                                            "rb")["output_ids"]


@pytest.mark.parametrize("enabled", [False, True])
def test_keep_rule_matches_reference(weights, enabled):
    """Which states stay after each chunk: the default rule (a full chunk
    with budget left) and the serving rule (the allowance used), the same
    in both packages over budgets around the chunk."""
    rng = np.random.RandomState(3)
    servers = [_port_server(weights, _scfg("port", enabled=enabled)),
               _ref_server(weights, _scfg("ref", enabled=enabled))]
    for i, budget in enumerate((2, 5, 6, 7, 12)):
        prompt = rng.randint(2, 90, 5 + i).tolist()
        got = [_decode_one(s, prompt, f"k{i}", max_tokens=budget)
               for s in servers]
        _same_reply(*got)
        kept = [sorted(s.kv._states if hasattr(s, "device")
                       else s.serving.kv._states) for s in servers]
        assert kept[0] == kept[1], budget
    assert servers[0].shapes.shapes() == servers[1].serving.shapes.shapes()


# ---------------------------------------------------------------- HTTP


def _post(url, body, path="/generate", timeout=WAIT):
    """(status, JSON body, headers) of a POST."""
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _body(prompt, rid, cls="rollout", max_tokens=4, greedy=True):
    return {"prompt_ids": [int(t) for t in prompt], "rid": rid, "class": cls,
            "gconfig": {"greedy": greedy, "max_new_tokens": max_tokens},
            "max_tokens": max_tokens}


class _Req:
    """An aiohttp request stand-in for the reference's handlers."""

    def __init__(self, d):
        self._d = d
        self.headers = {}

    async def json(self):
        return self._d


def _ref_reply(resp):
    return resp.status, json.loads(resp.body), dict(resp.headers)


def _until(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


@pytest.fixture()
def nr(tmp_path):
    from areal_tpu.base import name_resolve as jnr
    from areal_tpu_torch.base import name_resolve as tnr

    old = (tnr.DEFAULT_REPO, jnr.DEFAULT_REPO)
    tnr.DEFAULT_REPO = tnr.NfsNameRecordRepo(str(tmp_path / "nr_port"))
    jnr.DEFAULT_REPO = jnr.NfsNameRecordRepo(str(tmp_path / "nr_ref"))
    yield
    tnr.DEFAULT_REPO, jnr.DEFAULT_REPO = old


def test_429_and_413_match_reference(weights, nr):
    """Twin of test_serving.py:409 and :446: with nothing draining, the
    rollout queue fills to its limit and the next request gets 429 with the
    reference's body and ``Retry-After: 1`` while another class still
    admits; an over-long prompt gets 413 with the same body; so does a
    feasible prompt whose whole budget cannot fit."""
    port = _port_server(weights, _scfg(queue_limit_rollout=2,
                                       retry_after_secs=0.3,
                                       max_kv_capacity=64))
    port._runner = lambda: None  # nothing drains
    url = port.start()
    hung = [threading.Thread(target=_post, args=(url, _body([5, 6, 7],
                                                            f"q{i}")),
                             daemon=True) for i in range(2)]
    try:
        for t in hung:
            t.start()
        _until(lambda: port._queue.depth("rollout") == 2, "2 queued")
        got = {"port": [_post(url, _body([5, 6, 7], "q2"))]}
        inter = threading.Thread(target=_post, args=(
            url, _body([5, 6, 7], "q3", cls="interactive")), daemon=True)
        inter.start()
        hung.append(inter)
        _until(lambda: port._queue.depth("interactive") == 1, "interactive")
        got["port"].append(_post(url, _body(list(range(2, 70)), "long")))
        got["port"].append(_post(url, {**_body([5, 6], "plan", cls="eval"),
                                       "budget_total": 60}))
    finally:
        port.stop(timeout=5)  # fails the queued requests
        for t in hung:
            t.join(WAIT)
    assert not any(t.is_alive() for t in hung)

    ref = _ref_server(weights, _scfg("ref", queue_limit_rollout=2,
                                     retry_after_secs=0.3,
                                     max_kv_capacity=64))

    async def main():
        tasks = [asyncio.create_task(ref.handle_generate(
            _Req(_body([5, 6, 7], f"q{i}")))) for i in range(2)]
        await asyncio.sleep(0.05)
        out = [_ref_reply(await ref.handle_generate(
            _Req(_body([5, 6, 7], "q2"))))]
        tasks.append(asyncio.create_task(ref.handle_generate(
            _Req(_body([5, 6, 7], "q3", cls="interactive")))))
        await asyncio.sleep(0.05)
        out.append(_ref_reply(await ref.handle_generate(
            _Req(_body(list(range(2, 70)), "long")))))
        out.append(_ref_reply(await ref.handle_generate(
            _Req({**_body([5, 6], "plan", cls="eval"),
                  "budget_total": 60}))))
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        return out

    got["ref"] = asyncio.run(main())
    for (ps, pb, ph), (rs, rb, rh) in zip(got["port"], got["ref"]):
        assert (ps, pb) == (rs, rb)
        assert ph.get("Retry-After") == rh.get("Retry-After")
    assert got["port"][0][0] == 429 and got["port"][0][2]["Retry-After"] == "1"
    assert got["port"][0][1]["retry_after"] == 0.3
    assert [g[0] for g in got["port"][1:]] == [413, 413]


@pytest.mark.parametrize("enabled", [False, True])
def test_unknown_class_served_as_rollout(weights, nr, enabled):
    """An unknown ``class`` of any JSON type is served as rollout by both
    packages' servers: the same 200 replies."""
    from test_torch_async_rollout import RefLoop

    port = _port_server(weights, _scfg("port", enabled=enabled))
    ref = _ref_server(weights, _scfg("ref", enabled=enabled))
    loop = RefLoop()
    urls = {"port": port.start(), "ref": loop.run(ref.start())}
    try:
        replies = {pkg: [_post(u, _body([5, 6, 7, 8], f"c{i}", cls=cls,
                                        max_tokens=5))
                         for i, cls in enumerate((5, "interactve", None,
                                                  ["eval"]))]
                   for pkg, u in urls.items()}
    finally:
        port.stop()
        loop.run(ref.stop())
        loop.close()
    for (ps, pb, _), (rs, rb, _) in zip(replies["port"], replies["ref"]):
        assert ps == rs == 200
        _same_reply(pb, rb)


def test_class_priority_under_contention(weights, nr):
    """Twin of test_serving.py:461: a rollout backlog deeper than a batch is
    queued before an interactive request arrives; the interactive one
    rides the first batch and finishes before the backlog clears."""
    srv = _port_server(weights, _scfg(), max_batch_size=2)
    go = threading.Event()
    run = srv._runner

    def gated():
        go.wait(WAIT)
        run()

    srv._runner = gated
    url = srv.start()
    order, lock = [], threading.Lock()

    def one(body, tag):
        status, _, _ = _post(url, body)
        assert status == 200
        with lock:
            order.append(tag)

    threads = [threading.Thread(target=one, args=(_body([2, 3, 4], f"r{i}"),
                                                  f"r{i}"), daemon=True)
               for i in range(5)]
    try:
        for t in threads:
            t.start()
        _until(lambda: srv._queue.depth("rollout") == 5, "rollouts queued")
        t = threading.Thread(target=one, args=(
            _body([2, 3, 4], "i0", cls="interactive"), "i0"), daemon=True)
        t.start()
        threads.append(t)
        _until(lambda: srv._queue.depth("interactive") == 1, "interactive")
        go.set()
        for t in threads:
            t.join(WAIT)
    finally:
        go.set()
        srv.stop()
    assert not any(t.is_alive() for t in threads)
    assert order.index("i0") < 2, order
    assert order.index("i0") < order.index("r4")


def test_randomized_shape_bound_and_scrape(weights, nr):
    """Twin of test_serving.py:498: a randomized mixed-class load keeps the
    distinct shapes within max_compiled_shapes, and the gauge, the KV
    gauges and every class's histograms are on a real scrape; then
    ``perf_probe decode-bench`` against the same server."""
    from areal_tpu_torch.api.train_config import TelemetryConfig
    from areal_tpu_torch.tools import perf_probe

    scfg = _scfg(max_kv_capacity=128, max_compiled_shapes=48)
    srv = _port_server(weights, scfg, max_batch_size=4, chunk_tokens=4,
                       telemetry=TelemetryConfig(enabled=True,
                                                 flush_interval_secs=30))
    url = srv.start()
    rng = np.random.RandomState(7)
    try:
        bodies = [_body(rng.randint(2, 90, int(rng.randint(3, 40))).tolist(),
                        f"w{i}", cls=T.REQUEST_CLASSES[i % 3],
                        max_tokens=int(rng.randint(1, 7)), greedy=False)
                  for i in range(24)]
        for start in range(0, 24, 8):  # waves: varied batch mixes
            replies = [None] * 8
            ts = [threading.Thread(target=lambda j=j: replies.__setitem__(
                j, _post(url, bodies[start + j])), daemon=True)
                for j in range(8)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(WAIT)
            assert all(r is not None and r[0] == 200 for r in replies)
        assert srv.shapes.distinct_shapes <= scfg.max_compiled_shapes
        with urllib.request.urlopen(url + "/metrics", timeout=WAIT) as r:
            prom = r.read().decode()
        bench = perf_probe.decode_bench(url, n_requests=12, max_tokens=6)
    finally:
        srv.stop()
    assert "# TYPE areal_serving_compiled_shapes gauge" in prom
    assert "areal_genserver_kv_states" in prom
    assert "areal_genserver_kv_bytes" in prom
    for cls in T.REQUEST_CLASSES:
        assert f"areal_serving_{cls}_queue_wait_secs_bucket" in prom
        assert f"areal_serving_{cls}_ttfc_secs_bucket" in prom
        assert f"areal_serving_{cls}_admitted_total" in prom
        assert f"areal_genserver_serving_queue_{cls}" in prom
    for ln in prom.splitlines():  # every sample line parses
        if ln and not ln.startswith("#"):
            float(ln.rpartition(" ")[2])
    assert bench["non_200"] == [] and bench["tokens"] > 0
    assert set(bench["per_class"]) == set(T.REQUEST_CLASSES)
    assert bench["server"]["compiled_shapes"] <= scfg.max_compiled_shapes


def test_decode_bench_command_counts_refusals(weights, nr, capsys):
    """``python -m areal_tpu_torch.tools.perf_probe decode-bench`` against
    a server whose interactive queue holds 1: every reply is 200, 429 or
    413, and the refusals are reported, not fatal; ``scrape`` prints the
    server's gauges."""
    from areal_tpu_torch.tools import perf_probe

    srv = _port_server(weights, _scfg(queue_limit_interactive=1,
                                      queue_limit_eval=1,
                                      max_kv_capacity=64),
                       max_batch_size=2, chunk_tokens=4)
    url = srv.start()
    try:
        rc = perf_probe.main(["decode-bench", url, "16", "8"])
        out = capsys.readouterr().out
        perf_probe.main(["scrape", url])
        scraped = capsys.readouterr().out
    finally:
        srv.stop()
    assert rc == 0 and "[decode-bench] 16 requests" in out
    assert "areal_genserver_generated_tokens" in scraped
    bad = [tok for tok in out.split() if ":http" in tok
           and not tok.rstrip(",)").endswith(("http429", "http413"))]
    assert not bad, out
    assert perf_probe.main([]) == 2


# ------------------------------------------------------ manager: classes


def _managers():
    from areal_tpu.system.gserver_manager import (
        GserverManager as JMgr,
        GserverManagerConfig as JMgrCfg,
    )
    from areal_tpu_torch.system.gserver_manager import (
        GserverManager as TMgr,
        GserverManagerConfig as TMgrCfg,
    )

    out = {"port": TMgr(TMgrCfg(experiment="servtest", trial="t0")),
           "ref": JMgr(JMgrCfg(experiment="servtest", trial="t0"))}
    for m in out.values():
        m.servers = ["http://a", "http://b"]
        m._inflight = {u: 0 for u in m.servers}
    return out


def _call(mgr, name, body):
    """One manager call, (status, reply), on either package."""
    if hasattr(mgr, "schedule_request"):  # the port's: plain methods
        if name == "metrics_text":
            return 200, mgr.metrics_text()
        return getattr(mgr, name)(body)
    handler = getattr(mgr, {"schedule_request": "handle_schedule_request",
                            "release": "handle_release",
                            "metrics_json": "handle_metrics_json",
                            "metrics_text": "handle_metrics"}[name])
    resp = asyncio.run(handler(_Req(body)))
    return resp.status, (resp.text if name == "metrics_text"
                         else json.loads(resp.text))


SCRIPT = [
    ("schedule_request", {"class": "rollout"}),
    ("schedule_request", {"class": "interactive"}),
    ("schedule_request", {"class": "interactive"}),
    ("schedule_request", {"class": "eval"}),
    ("schedule_request", {}),
    ("schedule_request", {"class": "bogus"}),
    ("schedule_request", {"class": 7}),
    ("release", {"lease_id": "l2"}),
    ("schedule_request", {"class": "interactive"}),
    ("release", {"url": "http://a"}),  # ambiguous: counts move only
    ("release", {"lease_id": "l4"}),
    ("schedule_request", {"class": "eval"}),
    ("release", {"lease_id": "l99"}),
]


def test_manager_class_routing_matches_reference():
    """Twin of test_serving.py:564 and :606: the same script of schedules
    and releases gives the same replies (url, lease, class), the same
    per-class counts after every call and the same gsmgr_inflight_*
    gauges."""
    mgrs = _managers()
    for name, body in SCRIPT:
        got = {pkg: _call(m, name, body) for pkg, m in mgrs.items()}
        assert got["port"] == got["ref"], (name, body)
        counts = {pkg: _call(m, "metrics_json", {})[1]["inflight_by_class"]
                  for pkg, m in mgrs.items()}
        assert counts["port"] == counts["ref"], (name, body)
    assert counts["port"]["interactive"] == 2 and counts["port"]["eval"] == 1
    gauges = {}
    for pkg, m in mgrs.items():
        text = _call(m, "metrics_text", {})[1]
        gauges[pkg] = sorted(ln for ln in text.splitlines()
                             if ln.startswith("areal_gsmgr_inflight_"))
    assert gauges["port"] == gauges["ref"]
    assert len(gauges["port"]) == 4  # requests + three classes


def test_manager_interactive_spreads_across_servers():
    mgr = _managers()["port"]
    _, r1 = mgr.schedule_request({"class": "rollout"})
    _, i1 = mgr.schedule_request({"class": "interactive"})
    _, i2 = mgr.schedule_request({"class": "interactive"})
    assert r1["class"] == "rollout"
    assert {i1["url"], i2["url"]} == {"http://a", "http://b"}
    mgr.release({"lease_id": i1["lease_id"]})
    assert mgr.metrics_json()[1]["inflight_by_class"]["interactive"] == 1
    # a lease expiring takes its class count with it
    for lid, (u, _) in list(mgr._leases.items()):
        mgr._leases[lid] = (u, 0.0)
    mgr.schedule_request({})
    assert mgr.metrics_json()[1]["inflight_by_class"] == {
        "interactive": 0, "eval": 0, "rollout": 1}


# ------------------------------------------------- client: 429 backpressure


class _FakeFleet:
    """A manager and a generation server in one stdlib HTTP server:
    ``/generate`` answers 429 with ``retry_after`` for the first ``n429``
    calls (all of them with n429=-1), then a finished reply."""

    def __init__(self, n429, retry_after):
        from areal_tpu_torch.system.http import FleetHTTPServer

        self.calls, self.schedules = [], []
        fleet = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, status, d):
                data = json.dumps(d).encode()
                self.send_response(status)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):  # noqa: N802
                d = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])) or b"{}")
                if self.path == "/schedule_request":
                    fleet.schedules.append(d.get("class"))
                    return self._reply(200, {"url": fleet.url, "version": 0})
                if self.path != "/generate":
                    return self._reply(200, {"ok": True})
                fleet.calls.append(d.get("class"))
                if n429 < 0 or len(fleet.calls) <= n429:
                    return self._reply(429, {"ok": False,
                                             "reason": "admission",
                                             "retry_after": retry_after})
                self._reply(200, {"output_ids": [7, 1],
                                  "output_logprobs": [-0.1, -0.2],
                                  "finished": True, "version": 0})

            def log_message(self, *args):
                pass

        self.http = FleetHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.http.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.http.server_address[1]}"

    def close(self):
        self.http.shutdown()
        self.http.server_close()


def _client(url, **kw):
    from areal_tpu_torch.base.retry import RetryPolicy
    from areal_tpu_torch.system.http import AsyncHttp
    from areal_tpu_torch.system.partial_rollout import PartialRolloutClient

    return PartialRolloutClient(
        url, AsyncHttp(), chunk_tokens=4,
        retry=RetryPolicy(max_attempts=2, base_delay_secs=0.01), **kw)


def test_client_backs_off_on_429_without_burning_failover():
    """Twin of test_serving.py:644: two 429s then a reply: the chunk
    completes, no failover, no abandonment, the class on every call."""
    fleet = _FakeFleet(n429=2, retry_after=0.01)
    client = _client(fleet.url, request_class="interactive")
    try:
        res = asyncio.run(asyncio.wait_for(client.generate_one(
            [2, 3], TGen(max_new_tokens=4)), WAIT))
    finally:
        client.session.close()
        fleet.close()
    assert res.output_ids == [7, 1]
    assert client.n_failovers == 0 and client.n_abandoned == 0
    assert fleet.calls == ["interactive"] * 3
    assert set(fleet.schedules) == {"interactive"}


def test_client_clamps_oversized_retry_after():
    """Twin of test_serving.py:679: a 3600 s hint against a 0.2 s budget
    abandons in well under a second, without a failover."""
    from areal_tpu_torch.system.partial_rollout import (
        GenerationAbandonedError,
    )

    fleet = _FakeFleet(n429=-1, retry_after=3600.0)
    client = _client(fleet.url, no_server_wait_secs=0.2)
    t0 = time.monotonic()
    try:
        with pytest.raises(GenerationAbandonedError):
            asyncio.run(asyncio.wait_for(client.generate_one(
                [2, 3], TGen(max_new_tokens=4)), WAIT))
    finally:
        client.session.close()
        fleet.close()
    assert time.monotonic() - t0 < 5.0
    assert client.n_abandoned == 1 and client.n_failovers == 0


# ------------------------------------------------------- config surface

SERVING_OVERRIDES = ["serving.enabled=true", "serving.chunk_buckets=8,16",
                     "serving.queue_limit_interactive=7",
                     "serving.max_compiled_shapes=32",
                     "serving.min_rollout_share=0.5",
                     "serving.prefix_reuse=false", "serving.row_buckets="]


def test_serving_overrides_match_reference():
    """Twin of test_serving.py:786: the same overrides give the same
    serving block (the defaults too)."""
    from areal_tpu.api import cli_args as JCA
    from areal_tpu_torch.api import cli_args as TCA

    for ovs in ([], SERVING_OVERRIDES):
        cfgs = [TCA.apply_overrides(TCA.BaseExperimentConfig(), list(ovs)),
                JCA.apply_overrides(JCA.BaseExperimentConfig(), list(ovs))]
        assert dataclasses.asdict(cfgs[0].serving) == \
            dataclasses.asdict(cfgs[1].serving)
    assert cfgs[0].serving.chunk_buckets == [8, 16]
    assert cfgs[0].serving.enabled is True


SMALL = ["serving.enabled=true", "serving.row_buckets=64",
         "serving.chunk_buckets=128", "serving.max_kv_capacity=256",
         "new_tokens_per_chunk=128"]
CHECKS = [
    [],
    ["serving.enabled=true"],
    ["serving.enabled=true", "serving.row_buckets=1,2,4"],
    ["serving.enabled=false", "serving.row_buckets=1,2,4"],
    ["serving.enabled=true", "serving.chunk_buckets=16384"],
    ["serving.enabled=true", "serving.min_rollout_share=1.5"],
    ["serving.enabled=true", "serving.min_rollout_share=-0.1"],
    ["serving.enabled=true", "serving.max_compiled_shapes=16"],
    ["serving.enabled=true", "gen_max_batch_size=100"],
    [*SMALL, "serving.max_compiled_shapes=32"],
    [*SMALL, "serving.max_compiled_shapes=32", "telemetry.enabled=true",
     "compile_watch.enabled=true"],
    [*SMALL, "serving.max_compiled_shapes=64", "telemetry.enabled=true",
     "compile_watch.enabled=true"],
]


@pytest.mark.parametrize("overrides", CHECKS)
def test_validate_config_serving_matches_reference(overrides):
    """``validate_config`` raises ConfigError with the reference's message
    where the reference's raises, and passes where it passes."""
    from areal_tpu.api import cli_args as JCA
    from areal_tpu.experiments.async_ppo_math_exp import (
        AsyncPPOMATHConfig as JCfg,
    )
    from areal_tpu_torch.api import cli_args as TCA
    from areal_tpu_torch.experiments.async_ppo_math_exp import (
        AsyncPPOMATHConfig as TCfg,
    )

    got = []
    for CA, Cfg in ((TCA, TCfg), (JCA, JCfg)):
        cfg = CA.apply_overrides(Cfg(experiment_name="v", trial_name="t"),
                                 list(overrides))
        try:
            CA.validate_config(cfg)
            got.append(None)
        except CA.ConfigError as e:
            got.append(str(e))
    assert got[0] == got[1]


def test_experiment_threads_serving_into_servers(tmp_path):
    """The async experiment gives every server the serving block and the
    shape inputs ``validate_config`` checked."""
    from areal_tpu_torch.api import cli_args as CA
    from areal_tpu_torch.experiments.async_ppo_math_exp import (
        AsyncPPOMATHConfig,
    )

    cfg = CA.apply_overrides(
        AsyncPPOMATHConfig(experiment_name="x", trial_name="t",
                           backend="cpu"),
        [f"cluster.fileroot={tmp_path}", "serving.enabled=true",
         "new_tokens_per_chunk=64", "gen_prompt_bucket=32",
         "gen_max_batch_size=16"])
    (sc,) = cfg.initial_setup()["gen_servers"]
    assert sc.serving is cfg.serving and sc.serving.enabled
    assert (sc.kv_bucket, sc.chunk_tokens, sc.max_batch_size,
            sc.prompt_bucket) == tuple(T.experiment_policy_kwargs(cfg)[k] for k in (
                "kv_bucket", "chunk_tokens", "max_batch_size",
                "prompt_bucket"))


# ------------------------------------------------------- the async loop


def _interactive_probe(nr_root, exp, results, stop):
    """The reference's e2e probe (test_system_async_ppo.py:331): three
    interactive requests through the manager's class-aware schedule."""
    from areal_tpu_torch.base import name_resolve as tnr
    from areal_tpu_torch.base import names

    repo = tnr.NfsNameRecordRepo(nr_root)
    try:
        murl = repo.wait(names.gen_server_manager(exp, "t0"), timeout=120)
    except Exception as e:  # noqa: BLE001 — surfaced by the assert
        results.append({"error": repr(e)})
        return
    for i in range(3):
        if stop.is_set():
            return
        try:
            s, route, _ = _post(murl, {"class": "interactive"},
                                path="/schedule_request")
            if not route.get("url"):
                time.sleep(0.2)
                continue
            s, out, _ = _post(route["url"], {
                "prompt_ids": [7, 8, 9, 10 + i], "class": "interactive",
                "rid": f"interactive{i}",
                "gconfig": {"max_new_tokens": 4, "greedy": True},
                "max_tokens": 4})
            _post(murl, {"lease_id": route.get("lease_id"),
                         "url": route["url"]}, path="/release")
            results.append({"status": s, "class": route.get("class"), **out})
        except Exception as e:  # noqa: BLE001 — surfaced by the assert
            results.append({"error": repr(e)})
            time.sleep(0.2)


def _serving_fleet_probe(path, servers, mgr):
    """The fleet's versions, quota and serving counters, written to
    ``path`` every 50 ms (the launcher terminates the process)."""
    def loop():
        while True:
            st = servers[0].stats()
            snap = {"manager": mgr.version, "server": servers[0].version,
                    "running": mgr.running_rollouts,
                    "serving": servers[0].cfg.serving.enabled,
                    "scheduled": dict(mgr._inflight_by_class()),
                    "prefix_hits": st["serving/prefix_hits"],
                    "compiled_shapes": servers[0].shapes.distinct_shapes}
            with open(path + ".tmp", "w") as f:
                json.dump(snap, f)
            os.replace(path + ".tmp", path)
            time.sleep(0.05)

    threading.Thread(target=loop, daemon=True).start()


def test_async_loop_with_serving_and_interactive_probe(tmp_path, monkeypatch):
    """The README's async recipe at tiny size with ``serving.enabled=true``
    through ``run_experiment``, while a thread sends interactive requests
    through the manager (the reference's e2e runs its loop so): 3 steps,
    finite losses, the fleet at version >= 2, the quota returned, an
    interactive reply of 4 tokens routed as interactive."""
    from areal_tpu_torch.api import cli_args as CA
    from areal_tpu_torch.apps.launcher import run_experiment
    from areal_tpu_torch.base import name_resolve as tnr
    from areal_tpu_torch.base.testing import make_math_jsonl
    from areal_tpu_torch.experiments.async_ppo_math_exp import (
        AsyncPPOMATHConfig,
    )
    from test_torch_async_ppo import _run_bounded

    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the spawned children's
    data_path = str(tmp_path / "math.jsonl")
    make_math_jsonl(data_path, n=8, seed=3)
    nr_root = str(tmp_path / "nr")
    cfg = AsyncPPOMATHConfig(experiment_name="asyncserve", trial_name="t0",
                             backend="cpu")
    CA.apply_overrides(cfg, [
        f"cluster.fileroot={tmp_path}", f"dataset.path={data_path}",
        f"cluster.name_resolve.nfs_record_root={nr_root}",
        "mock_tokenizer=true", "actor.tiny.vocab_size=258",
        "actor.tiny.seed=0", "ref.tiny.vocab_size=258", "ref.tiny.seed=0",
        "dataset.train_bs_n_seqs=2", "group_size=2",
        "max_head_offpolicyness=0", "ppo.disable_value=true",
        "ppo.gen.max_new_tokens=8", "new_tokens_per_chunk=4",
        "ppo.ppo_n_minibatches=1", "max_concurrent_rollouts=4",
        "gen_prompt_bucket=16", "exp_ctrl.benchmark_steps=3",
        "serving.enabled=true"])
    CA.validate_config(cfg)
    snap_path = str(tmp_path / "fleet.json")
    old = tnr.DEFAULT_REPO
    box, results, stop = {}, [], threading.Event()
    probe = threading.Thread(target=_interactive_probe,
                             args=(nr_root, "asyncserve", results, stop),
                             daemon=True)
    try:
        probe.start()
        t = _run_bounded(lambda: run_experiment(cfg, probes={
            "gen_fleet": functools.partial(_serving_fleet_probe,
                                           snap_path)}), box, "out")
        t.join(240)
        assert not t.is_alive(), "the loop hung"
        stop.set()
        probe.join(WAIT)
    finally:
        stop.set()
        tnr.DEFAULT_REPO = old
    if "out_error" in box:
        raise box["out_error"]
    result = box["out"]
    assert result["steps"] == 3
    for st in result["stats"]:
        assert np.isfinite(st["actor_train/actor_loss"])
        assert st["actor_train/n_action_tokens"] > 0
    snap = json.load(open(snap_path))
    assert snap["serving"] and snap["manager"] >= 2 and snap["server"] >= 2
    assert snap["running"] == 0
    ok = [r for r in results if r.get("status") == 200]
    assert ok, results
    for r in ok:
        assert r["class"] == "interactive"
        assert len(r["output_ids"]) == 4 or r["finished"]
