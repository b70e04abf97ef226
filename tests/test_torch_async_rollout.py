"""The port's async rollout stack on the CPU: the manager
(areal_tpu_torch/system/gserver_manager.py), the chunked client
(system/partial_rollout.py), the rollout worker (system/rollout_worker.py)
and the trajectory stream (system/streams.py), against the reference's.

 - gate and lease parity: the same scripted calls over HTTP to the
   reference's manager and to the port's give equal reply sequences;
 - chunked generation: greedy, chunk_tokens=4, max_new_tokens=10, on one
   numpy-seeded ``tiny_config`` (f32); each package's client against its
   own server and against the other package's manager and server. Tokens
   identical, logprobs within 1e-4, versions equal;
 - trajectories bit-equal (but ``birth_time``), the math agent's rewards
   equal;
 - the weight fanout, eviction, re-admission and reconcile of the port's
   manager on two CPU servers;
 - twins of the reference's failover, abandonment and rollout-worker
   survival tests (tests/test_fault_tolerance.py:422, :468, :547), and the
   worker outliving its trainer's stream;
 - the push stream: round trip, the bounded block, the key withdrawn;
 - registrations: servers on one key start and stop concurrently without
   a fault, and a killed fleet's leased keys lapse.

Every wait is bounded by the test itself.
"""

import asyncio
import json
import os
import random
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from areal_tpu.base import name_resolve as jnr
from areal_tpu.base import names as jnames
from areal_tpu_torch.base import name_resolve as tnr
from areal_tpu_torch.base import names as tnames
from areal_tpu_torch.base.retry import FaultInjector, RetryPolicy
from areal_tpu_torch.system import gserver_manager as tgm

EXP, TRIAL = "torch_async", "t0"
WAIT = 30.0  # bound on every wait of a test
FAKE = ["http://127.0.0.1:9", "http://127.0.0.1:11", "http://127.0.0.1:13"]


@pytest.fixture()
def repos(tmp_path):
    """Both packages' name_resolve on fresh NFS roots."""
    old = (tnr.DEFAULT_REPO, jnr.DEFAULT_REPO)
    tnr.DEFAULT_REPO = tnr.NfsNameRecordRepo(str(tmp_path / "nr_port"))
    jnr.DEFAULT_REPO = jnr.NfsNameRecordRepo(str(tmp_path / "nr_ref"))
    yield
    tnr.DEFAULT_REPO, jnr.DEFAULT_REPO = old


def _post(url, body=None, timeout=WAIT):
    """(status, JSON) of a POST (GET without a body)."""
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _until(cond, what, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


class RefLoop:
    """An asyncio loop on a thread for the reference's aiohttp pieces."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout=WAIT):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(WAIT)


class Managers:
    """The reference's manager and the port's, same config, each with
    ``urls`` registered as its fleet."""

    def __init__(self, urls, **kw):
        from areal_tpu.system.gserver_manager import (
            GserverManager,
            GserverManagerConfig,
        )

        kw = dict(experiment=EXP, trial=TRIAL, n_servers=len(urls),
                  health_check_interval_secs=60.0, **kw)
        for i, u in enumerate(urls):
            jnr.add(jnames.gen_servers(EXP, TRIAL, f"gen{i}"), u, replace=True)
            tnr.add(tnames.gen_servers(EXP, TRIAL, f"gen{i}"), u, replace=True)
        self.ref_loop = RefLoop()
        self.ref = GserverManager(GserverManagerConfig(**kw))
        self.port = tgm.GserverManager(tgm.GserverManagerConfig(**kw))
        self.urls = {"ref": self.ref_loop.run(self.ref.start()),
                     "port": self.port.start()}
        self.mgr = {"ref": self.ref, "port": self.port}

    def close(self):
        self.port.stop()
        self.ref_loop.run(self.ref.stop())
        self.ref_loop.close()


# ------------------------------------------------------------ gate parity


def _gate_replies(url, mgr, n, seed):
    """A seeded script of allocations, finishes and version bumps; the
    replies in order."""
    rng = random.Random(seed)
    out, booked = [], []
    for _ in range(60):
        r = rng.random()
        if r < 0.1:
            mgr.version += 1
            out.append(("bump", mgr.version))
        elif r < 0.2:
            out.append(_post(f"{url}/get_model_version"))
        elif r < 0.5 and booked:
            k = booked.pop(0)
            n_acc = rng.randint(0, k)
            out.append(_post(f"{url}/finish_rollout", {
                "accepted": n_acc > 0, "n_samples": k, "n_accepted": n_acc}))
        else:
            reply = _post(f"{url}/allocate_rollout", {"n_samples": n})
            if reply[1].get("allowed"):
                booked.append(n)
            out.append(reply)
    out.append((mgr.running_rollouts, mgr.accepted_rollouts, mgr.version))
    return out


@pytest.mark.parametrize("train_batch_size,offpolicy,max_concurrent,n", [
    (4, 0, 64, 4), (2, 1, 64, 1), (8, 2, 16, 4), (6, 1, 12, 3)])
def test_gate_replies_match_reference(repos, train_batch_size, offpolicy,
                                      max_concurrent, n):
    m = Managers(FAKE[:1], train_batch_size=train_batch_size,
                 max_head_offpolicyness=offpolicy,
                 max_concurrent_rollouts=max_concurrent)
    try:
        got = {pkg: _gate_replies(m.urls[pkg], m.mgr[pkg], n, seed=n)
               for pkg in ("ref", "port")}
    finally:
        m.close()
    assert got["port"] == got["ref"]
    denied = [r for r in got["ref"]
              if isinstance(r[1], dict) and r[1].get("allowed") is False]
    assert denied  # the gate closed at least once


# ----------------------------------------------------------- lease parity


def _lease_replies(url, mgr):
    def call(path, body):
        return _post(f"{url}{path}", body)

    out = [call("/schedule_request", {}) for _ in range(6)]
    # an unknown class serves as rollout in both
    out.append(call("/schedule_request", {"class": "bogus"}))
    out += [call("/renew", {"lease_id": "l2"}),
            call("/renew", {"lease_id": "l99"}),
            call("/release", {"lease_id": "l1"}),
            call("/release", {"lease_id": "l1"}),  # twice: harmless
            # by url: FAKE[2]'s single lease, then FAKE[0] with several
            call("/release", {"url": out[2][1]["url"]}),
            call("/release", {"url": FAKE[0]})]
    out += [call("/schedule_request", {}) for _ in range(3)]
    # every lease past its TTL: the next schedule expires them all
    for lid, (u, _) in list(mgr._leases.items()):
        mgr._leases[lid] = (u, 0.0)
    out.append(call("/schedule_request", {}))
    out.append(call("/renew", {"lease_id": "l3"}))
    out.append((dict(mgr._inflight), sorted(mgr._leases)))
    return out


@pytest.mark.parametrize("policy", ["round_robin", "least_requests"])
def test_lease_replies_match_reference(repos, policy):
    m = Managers(FAKE, schedule_policy=policy)
    try:
        got = {pkg: _lease_replies(m.urls[pkg], m.mgr[pkg])
               for pkg in ("ref", "port")}
    finally:
        m.close()
    assert got["port"] == got["ref"]
    assert got["ref"][-1][1] == ["l11"]  # expiry left only the new lease


# ---------------------------------------------------- chunked generation

EOS = 1


@pytest.fixture()
def fleets(repos, tmp_path):
    """A reference and a port server (same numpy-seeded weights) each behind
    its own package's manager."""
    from areal_tpu.system.generation_server import (
        GenerationServer as JServer,
        GenerationServerConfig as JServerConfig,
    )
    from areal_tpu.system.gserver_manager import (
        GserverManager as JMgr,
        GserverManagerConfig as JMgrConfig,
    )
    from areal_tpu_torch.models.convert import params_from_jax
    from areal_tpu_torch.system.generation_server import (
        GenerationServer,
        GenerationServerConfig,
    )
    from test_torch_model import _jparams
    from test_torch_trainer import weights

    jcfg, tcfg, flat = weights(seed=3)
    srv_kw = dict(experiment=EXP, trial=TRIAL, chunk_tokens=4,
                  prompt_bucket=16, batch_window_ms=2, eos_token_id=EOS)
    mgr_kw = dict(experiment=EXP, trial=TRIAL, n_servers=1,
                  max_head_offpolicyness=100, health_check_interval_secs=60.0)
    loop = RefLoop()
    jserver = JServer(JServerConfig(**srv_kw), jcfg, _jparams(flat))
    loop.run(jserver.start(), timeout=120)
    jmgr = JMgr(JMgrConfig(**mgr_kw))
    tserver = GenerationServer(GenerationServerConfig(**srv_kw), tcfg,
                               params_from_jax(flat, tcfg, device="cpu"),
                               device="cpu")
    tserver.start()
    tmgr = tgm.GserverManager(tgm.GserverManagerConfig(**mgr_kw))
    urls = {"ref": loop.run(jmgr.start()), "port": tmgr.start()}
    yield urls, loop
    tmgr.stop()
    tserver.stop()
    loop.run(jmgr.stop())
    loop.run(jserver.stop())
    loop.close()


async def _port_generate(mgr_url, prompts, gconfig):
    from areal_tpu_torch.system.http import AsyncHttp
    from areal_tpu_torch.system.partial_rollout import PartialRolloutClient

    session = AsyncHttp()
    try:
        client = PartialRolloutClient(mgr_url, session, chunk_tokens=4)
        return [await client.generate_one(p, gconfig, EOS) for p in prompts]
    finally:
        session.close()


async def _ref_generate(mgr_url, prompts, gconfig):
    import aiohttp

    from areal_tpu.system.partial_rollout import PartialRolloutClient

    async with aiohttp.ClientSession() as sess:
        client = PartialRolloutClient(mgr_url, sess, chunk_tokens=4)
        return [await client.generate_one(p, gconfig, EOS) for p in prompts]


def test_chunked_generation_across_packages(fleets):
    """Each client against each package's fleet (the wire contract is one),
    greedy: the same tokens, logprobs within 1e-4, the same versions."""
    from areal_tpu.api.model import GenerationHyperparameters as JGen
    from areal_tpu_torch.api.model import GenerationHyperparameters as TGen

    urls, loop = fleets
    rng = np.random.RandomState(4)
    prompts = [rng.randint(2, 120, n).tolist() for n in (3, 7, 12)]
    runs = {}
    for fleet in ("ref", "port"):
        runs[("port", fleet)] = asyncio.run(asyncio.wait_for(_port_generate(
            urls[fleet], prompts, TGen(max_new_tokens=10, greedy=True)),
            120))
        runs[("ref", fleet)] = loop.run(_ref_generate(
            urls[fleet], prompts, JGen(max_new_tokens=10, greedy=True)),
            timeout=120)
    base = runs[("ref", "ref")]
    assert max(r.n_chunks for r in base) == 3  # 4 + 4 + 2 tokens
    for key, res in runs.items():
        for a, b in zip(res, base):
            assert a.output_ids == b.output_ids, key
            np.testing.assert_allclose(a.output_logprobs, b.output_logprobs,
                                       rtol=0, atol=1e-4, err_msg=str(key))
            assert (a.version_start, a.version_end, a.n_chunks) == (
                b.version_start, b.version_end, b.n_chunks), key


# ----------------------------------------------------------- trajectories


@pytest.mark.parametrize("out_ids", [[5, 9, 1], [7, 8, 9, 10], []])
def test_trajectory_from_gen_matches_reference(out_ids):
    from areal_tpu.system import partial_rollout as jpr
    from areal_tpu_torch.system import partial_rollout as tpr

    prompt = np.asarray([3, 4, 5, 6], np.int32)
    lps = [-0.5 * (i + 1) for i in range(len(out_ids))]
    got = []
    for pr in (tpr, jpr):
        res = pr.GenResult(output_ids=list(out_ids), output_logprobs=list(lps),
                           version_start=2, version_end=3, n_chunks=2)
        got.append(pr.trajectory_from_gen("q7", 1, prompt, res, task="code",
                                          task_id=1, eos_token_id=EOS))
    t, j = got
    assert t.ids == j.ids and t.seqlens == j.seqlens
    assert t.metadata == j.metadata and t.keys == j.keys
    for k in j.keys - {"birth_time"}:
        assert t.data[k].dtype == j.data[k].dtype, k
        np.testing.assert_array_equal(t.data[k], j.data[k], err_msg=k)


def test_math_agent_rewards_match_reference():
    """The same generated texts through both packages' single-step math
    agent and env: equal rewards (and the code env's format gate)."""
    import areal_tpu.agents  # noqa: F401 — the registries
    import areal_tpu_torch.agents  # noqa: F401
    from areal_tpu.api import model as jmodel
    from areal_tpu.base.testing import MockTokenizer as JTok
    from areal_tpu.system import partial_rollout as jpr
    from areal_tpu_torch.api import model as tmodel
    from areal_tpu_torch.base.testing import MockTokenizer as TTok
    from areal_tpu_torch.system import partial_rollout as tpr

    info = {"q1": {"query_id": "q1", "task": "math",
                   "solutions": ["\\boxed{12}"]}}
    texts = ["so \\boxed{12}", "\\boxed{13}", "twelve", "\\boxed{ 12 }"]

    async def run(model_mod, pr, data_mod, tok):
        agent = model_mod.make_agent("math_single_step", tokenizer=tok,
                                     reward_bias=0.25, reward_scaling=2.0)
        env = model_mod.make_env("math_code_single_step", info)
        prompt = data_mod.SequenceSample.from_default(
            ids=["q1"], data={"packed_prompts": np.asarray([5, 6], np.int32)},
            seqlens=[2])
        obs_q, act_q = asyncio.Queue(), asyncio.Queue()
        task = asyncio.create_task(agent.collect_trajectory(prompt, env,
                                                            obs_q, act_q))
        qid, pids, _ = await obs_q.get()
        await act_q.put([pr.trajectory_from_gen(
            qid, j, np.asarray(pids, np.int32),
            pr.GenResult(tok.encode(t), [0.0] * len(tok.encode(t)), 0, 0, 1))
            for j, t in enumerate(texts)])
        out = await task
        return [float(np.asarray(s.data["rewards"])[0]) for s in out]

    from areal_tpu.api import data as jdata
    from areal_tpu_torch.api import data as tdata

    port = asyncio.run(run(tmodel, tpr, tdata, TTok()))
    ref = asyncio.run(run(jmodel, jpr, jdata, JTok()))
    assert port == ref and sorted(set(port)) == [-0.5, 1.5]


# ------------------------------------------------------------------ fanout


def _tiny_server(server_id, seed=0):
    from areal_tpu_torch.models.config import tiny_config
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system.generation_server import (
        GenerationServer,
        GenerationServerConfig,
    )

    cfg = tiny_config(vocab_size=128)
    srv = GenerationServer(
        GenerationServerConfig(experiment=EXP, trial=TRIAL,
                               server_id=server_id, prompt_bucket=16),
        cfg, init_params(cfg, seed=seed, device="cpu"), device="cpu")
    srv.start()
    return srv, cfg


def _publish(realloc, cfg, version, seed):
    """A native checkpoint of seeded weights as version ``version``."""
    from areal_tpu_torch.models import hf
    from areal_tpu_torch.models.transformer import init_params

    hf.save_native_checkpoint(init_params(cfg, seed=seed, device="cpu"), cfg,
                              os.path.join(realloc, "actor", str(version)))
    tnr.add(tnames.model_version(EXP, TRIAL, "actor"), str(version),
            replace=True)


def test_fanout_eviction_and_readmission(repos, tmp_path):
    """A published version reaches every server and the manager's version;
    a server that fails the push is evicted, then re-admitted through a
    reconcile; zero acks hold the version; a server that fails its health
    checks is evicted, and re-admitted at the fleet's version."""
    realloc = str(tmp_path / "realloc")
    a, cfg = _tiny_server("gen0")
    b, _ = _tiny_server("gen1")
    url_a = tnr.get(tnames.gen_servers(EXP, TRIAL, "gen0"))
    url_b = tnr.get(tnames.gen_servers(EXP, TRIAL, "gen1"))
    inj = FaultInjector()
    mgr = tgm.GserverManager(tgm.GserverManagerConfig(
        experiment=EXP, trial=TRIAL, n_servers=2, realloc_dir=realloc,
        weight_poll_secs=0.05, health_check_interval_secs=0.05,
        health_failure_threshold=2, fanout_timeout_secs=20.0,
        fanout_retry=RetryPolicy(max_attempts=2, base_delay_secs=0.01),
        keep_last_versions=10), fault_injector=inj)
    mgr.start()
    try:
        # v1: b fails every push -> evicted; a swaps; the version moves
        inj.arm("fanout", times=-1, when=lambda ctx: ctx["url"] == url_b)
        _publish(realloc, cfg, 1, seed=1)
        _until(lambda: mgr.version == 1, "v1 at the manager")
        assert a.version == 1 and b.version == 0
        assert url_b not in mgr.servers
        assert mgr.health[url_b].evicted_reason == "no ack for weight v1"
        # b probes healthy, but its reconcile push fails: still out
        _until(lambda: inj.fired["fanout"] >= 4, "a failed reconcile")
        assert url_b not in mgr.servers
        inj.disarm("fanout")
        _until(lambda: url_b in mgr.servers, "b re-admitted")
        assert b.version == 1
        # v2 with no ack at all: the version holds, the fleet stays
        inj.arm("fanout", times=-1)
        _publish(realloc, cfg, 2, seed=2)
        _until(lambda: inj.fired["fanout"] >= 10, "failed v2 pushes")
        assert mgr.version == 1 and sorted(mgr.servers) == sorted(
            [url_a, url_b])
        inj.disarm("fanout")
        _until(lambda: mgr.version == 2, "v2 after the retry")
        assert a.version == b.version == 2
        # b fails health_failure_threshold probes -> evicted; v3 goes to a
        # alone; b comes back and is reconciled to v3 before it routes
        inj.arm("health", times=-1, when=lambda ctx: ctx["url"] == url_b)
        _until(lambda: url_b not in mgr.servers, "b evicted by health")
        _publish(realloc, cfg, 3, seed=3)
        _until(lambda: mgr.version == 3, "v3 at the manager")
        assert a.version == 3 and b.version == 2
        inj.disarm("health")
        _until(lambda: url_b in mgr.servers, "b re-admitted after v3")
        assert b.version == 3
        # publish-to-swap seconds anchored on model_version_time: absent
        # here (no trainer published it), the fanout seconds present
        assert [h[0] for h in mgr.sync_history] == [1, 2, 3]
    finally:
        mgr.stop()
        a.stop()
        b.stop()


# ---------------------------------------------------------- failure twins


class FakeGenServer:
    """A deterministic stand-in generation server: token i of a request is
    100 + tokens_done + i, so a replay from the accumulated tokens shows in
    the output."""

    def __init__(self, server_id="gen0"):
        calls = self.calls = []

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, body):
                data = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):  # noqa: N802
                d = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                td, mt = int(d["tokens_done"]), int(d["max_tokens"])
                calls.append(td)
                self._reply({"output_ids": list(range(100 + td,
                                                      100 + td + mt)),
                             "output_logprobs": [0.0] * mt,
                             "finished": False, "version": 0})

            def do_GET(self):  # noqa: N802
                self._reply({"ok": True, "version": 0})

            def log_message(self, *args):
                pass

        self.http = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.http.daemon_threads = True
        threading.Thread(target=self.http.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.http.server_address[1]}"
        tnr.add(tnames.gen_servers(EXP, TRIAL, server_id), self.url,
                replace=True)

    def close(self):
        self.http.shutdown()
        self.http.server_close()


@pytest.fixture()
def fake_fleet(repos):
    srv = FakeGenServer()
    mgr = tgm.GserverManager(tgm.GserverManagerConfig(
        experiment=EXP, trial=TRIAL, n_servers=1, max_head_offpolicyness=100,
        health_check_interval_secs=30.0))
    url = mgr.start()
    yield srv, mgr, url
    mgr.stop()
    srv.close()


def _client(url, inj, attempts):
    from areal_tpu_torch.system.http import AsyncHttp
    from areal_tpu_torch.system.partial_rollout import PartialRolloutClient

    return PartialRolloutClient(
        url, AsyncHttp(), chunk_tokens=4,
        retry=RetryPolicy(max_attempts=attempts, base_delay_secs=0.01),
        fault_injector=inj)


class _SlowSession:
    """An ``AsyncHttp`` stand-in: each call runs on as a task of its own
    when its caller is cancelled (as a call on the pool's threads does).
    ``/schedule_request`` grants a lease after ``schedule_delay`` s,
    ``/generate`` hangs, ``/release`` records its lease after 50 ms."""

    def __init__(self, schedule_delay=0.0):
        self.schedule_delay = schedule_delay
        self.granted, self.released = [], []

    async def _call(self, path, body):
        if path == "schedule_request":
            await asyncio.sleep(self.schedule_delay)
            lid = f"l{len(self.granted)}"
            self.granted.append(lid)
            return 200, {"url": "http://fake", "version": 0, "lease_id": lid}
        if path == "release":
            await asyncio.sleep(0.05)
            self.released.append(body["lease_id"])
            return 200, {"ok": True}
        await asyncio.sleep(3600)  # /generate: never answers

    async def post(self, url, body, timeout=30.0, headers=None):
        return await asyncio.shield(asyncio.ensure_future(
            self._call(url.rsplit("/", 1)[-1], body)))


@pytest.mark.parametrize("schedule_delay", [0.0, 0.2])
def test_cancelled_group_returns_every_lease(schedule_delay):
    """A rollout cancelled mid-generation (the worker's exit) returns every
    lease its group holds before the cancel reaches the caller, who closes
    the session next; a lease granted after the cancel (the schedule call
    still in flight) is returned too. A kept lease pins the server's
    inflight count until it expires."""
    from areal_tpu_torch.api.model import GenerationHyperparameters
    from areal_tpu_torch.system.partial_rollout import PartialRolloutClient

    async def main():
        session = _SlowSession(schedule_delay)
        client = PartialRolloutClient("http://mgr", session, chunk_tokens=4)
        task = asyncio.ensure_future(client.generate_group(
            [1, 2, 3], GenerationHyperparameters(max_new_tokens=8), 3))
        await asyncio.sleep(0.1)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        # what the caller sees as the cancel reaches it
        return list(session.granted), list(session.released)

    granted, released = asyncio.run(asyncio.wait_for(main(), WAIT))
    assert len(granted) == 3
    assert sorted(released) == sorted(granted)


def test_client_failover_replays_from_accumulated_tokens(fake_fleet):
    """A failed chunk re-schedules and resumes at the same tokens_done: the
    tokens are contiguous and no lease leaks."""
    from areal_tpu_torch.api.model import GenerationHyperparameters

    srv, mgr, url = fake_fleet
    inj = FaultInjector()
    inj.arm("generate", times=1, when=lambda ctx: ctx["tokens_done"] == 4)
    client = _client(url, inj, attempts=4)
    try:
        res = asyncio.run(asyncio.wait_for(client.generate_one(
            [1, 2, 3], GenerationHyperparameters(max_new_tokens=8)), WAIT))
    finally:
        client.session.close()
    assert res.output_ids == list(range(100, 108))
    assert client.n_failovers == 1 and inj.fired["generate"] == 1
    assert srv.calls == [0, 4]  # chunk 2 replayed at tokens_done=4
    assert res.n_chunks == 2
    assert not mgr._leases
    assert all(v == 0 for v in mgr._inflight.values())


def test_generation_abandoned_after_max_attempts(fake_fleet):
    from areal_tpu_torch.api.model import GenerationHyperparameters
    from areal_tpu_torch.system.partial_rollout import (
        GenerationAbandonedError,
    )

    _, mgr, url = fake_fleet
    inj = FaultInjector()
    inj.arm("generate", times=-1)  # the fleet is permanently dead
    client = _client(url, inj, attempts=3)
    try:
        with pytest.raises(GenerationAbandonedError):
            asyncio.run(asyncio.wait_for(client.generate_one(
                [1, 2], GenerationHyperparameters(max_new_tokens=8)), WAIT))
    finally:
        client.session.close()
    assert inj.fired["generate"] == 3
    assert client.n_abandoned == 1
    assert all(v == 0 for v in mgr._inflight.values())
    assert not mgr._leases


def test_rollout_worker_abandons_cleanly_never_crashes(fake_fleet, tmp_path):
    """Every chunk fails: the worker abandons each rollout after its retry
    budget, reports /finish_rollout so running_rollouts drains to 0, and
    returns instead of raising."""
    from areal_tpu_torch.api.model import GenerationHyperparameters
    from areal_tpu_torch.base.testing import MockTokenizer, make_math_jsonl
    from areal_tpu_torch.system.rollout_worker import (
        RolloutWorker,
        RolloutWorkerConfig,
    )
    from areal_tpu_torch.system.streams import TrajectoryPuller

    _, mgr, _ = fake_fleet
    data_path = str(tmp_path / "math.jsonl")
    make_math_jsonl(data_path, n=4)
    puller = TrajectoryPuller(EXP, TRIAL, "trainer")
    inj = FaultInjector()
    inj.arm("generate", times=-1)
    worker = RolloutWorker(RolloutWorkerConfig(
        experiment=EXP, trial=TRIAL, dataset_path=data_path,
        gconfig=GenerationHyperparameters(max_new_tokens=8),
        group_size=2, chunk_tokens=4, max_concurrent=2,
        tokenizer=MockTokenizer(), max_rollouts=2,
        retry=RetryPolicy(max_attempts=2, base_delay_secs=0.01),
    ), fault_injector=inj)
    try:
        asyncio.run(asyncio.wait_for(worker.run_async(), WAIT))  # no raise
        assert worker._abandoned >= 2 and worker._pushed == 0
        _until(lambda: mgr.running_rollouts == 0 and not mgr._leases,
               "the quota to drain")
    finally:
        puller.close()


def test_rollout_worker_survives_a_gone_trainer(fake_fleet, tmp_path):
    """The trainer's stream is gone (its address refuses connections): the
    worker stays up, each rollout returns its quota with no sample
    accepted, and no prompt is marked consumed."""
    from areal_tpu_torch.api.model import GenerationHyperparameters
    from areal_tpu_torch.base import network
    from areal_tpu_torch.base.testing import MockTokenizer, make_math_jsonl
    from areal_tpu_torch.system.rollout_worker import (
        RolloutWorker,
        RolloutWorkerConfig,
    )
    from areal_tpu_torch.system.streams import push_pull_addr_key

    _, mgr, _ = fake_fleet
    data_path = str(tmp_path / "math.jsonl")
    make_math_jsonl(data_path, n=4)
    tnr.add(push_pull_addr_key(EXP, TRIAL, "trainer"),
            f"tcp://127.0.0.1:{network.find_free_port()}", replace=True)
    worker = RolloutWorker(RolloutWorkerConfig(
        experiment=EXP, trial=TRIAL, dataset_path=data_path,
        gconfig=GenerationHyperparameters(max_new_tokens=8),
        group_size=2, chunk_tokens=4, max_concurrent=2,
        tokenizer=MockTokenizer(), max_rollouts=3,
        recover_dir=str(tmp_path / "recover")))
    asyncio.run(asyncio.wait_for(worker.run_async(), WAIT))  # no raise
    assert worker._done >= 3 and worker._pushed == 0
    _until(lambda: mgr.running_rollouts == 0 and not mgr._leases,
           "the quota to drain")
    assert mgr.accepted_rollouts == 0
    assert not worker.consumed.seen


# ------------------------------------------------------------- the stream


def test_push_stream_round_trip_block_and_withdraw(repos):
    from areal_tpu_torch.system.streams import (
        TrajectoryPuller,
        TrajectoryPusher,
        push_pull_addr_key,
    )

    puller = TrajectoryPuller(EXP, TRIAL, "trainer")
    key = push_pull_addr_key(EXP, TRIAL, "trainer")
    assert tnr.get(key) == puller._addr
    pusher = TrajectoryPusher(EXP, TRIAL, "trainer", timeout=WAIT,
                              block_secs=0.5)
    try:
        sent = [{"ids": [f"q{i}@0"], "data": {"x": list(range(i + 1))}}
                for i in range(3)]
        for obj in sent:
            pusher.push(obj)
        got = []
        deadline = time.monotonic() + WAIT
        while len(got) < 3 and time.monotonic() < deadline:
            obj = puller.pull(timeout_ms=100)
            if obj is not None:
                got.append(obj)
        assert got == sent
        # Nobody pulls: once the socket buffers fill, a push raises within
        # its budget instead of wedging the caller.
        big = b"x" * (4 << 20)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="blocked"):
            for _ in range(256):
                pusher.push(big)
        assert time.monotonic() - t0 < 20
    finally:
        pusher.close()
        puller.close()
    with pytest.raises(tnr.NameEntryNotFoundError):
        tnr.get(key)


# -------------------------------------------------------- registrations


def _bare_server(seed):
    """A port server on a tiny seeded model, with the default config (the
    default experiment, trial and server id, so the default key)."""
    from areal_tpu_torch.models.config import tiny_config
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system.generation_server import (
        GenerationServer,
        GenerationServerConfig,
    )

    cfg = tiny_config()
    return GenerationServer(GenerationServerConfig(), cfg,
                            init_params(cfg, seed, device="cpu"),
                            device="cpu")


def test_servers_on_one_key_start_and_stop_concurrently(repos):
    """Two servers registering under one key at once, and withdrawing at
    once, never raise: a delete that loses the race to another delete, or
    an add that refills a directory being pruned, is not a fault. Below
    the servers, eight threads add and delete one key in a tight loop."""
    servers = [_bare_server(seed) for seed in (0, 1)]

    def together(fn):
        errors = []

        def run(s):
            try:
                fn(s)
            except Exception as e:  # noqa: BLE001 — collected, asserted
                errors.append(e)

        threads = [threading.Thread(target=run, args=(s,)) for s in servers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
        assert errors == []

    key = tnames.gen_servers("exp", "trial", "gen0")
    for _ in range(5):
        together(lambda s: s.start())
        assert tnr.get(key) in {f"http://{h}:{p}" for h, p in (
            s._http.server_address[:2] for s in servers)}
        together(lambda s: s.stop())
    with pytest.raises(tnr.NameEntryNotFoundError):
        tnr.get(key)

    errors, barrier = [], threading.Barrier(8)

    def churn(i):
        barrier.wait(WAIT)
        for n in range(200):
            try:
                tnr.add("race/k", f"{i}.{n}", replace=True,
                        delete_on_exit=False)
                tnr.delete("race/k")
            except tnr.NameEntryNotFoundError:
                pass  # another thread withdrew it first
            except Exception as e:  # noqa: BLE001 — collected, asserted
                errors.append(e)

    threads = [threading.Thread(target=churn, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


_LEASED_FLEET = """
import sys, time
from areal_tpu_torch.models.config import tiny_config
from areal_tpu_torch.models.transformer import init_params
from areal_tpu_torch.system.generation_server import (
    GenerationServer, GenerationServerConfig)
from areal_tpu_torch.system.gserver_manager import (
    GserverManager, GserverManagerConfig)
cfg = tiny_config()
GenerationServer(GenerationServerConfig(), cfg, init_params(cfg, 0, device="cpu"),
                 device="cpu").start()
GserverManager(GserverManagerConfig()).start()
print("up", flush=True)
time.sleep(600)
"""


def test_a_killed_fleets_registrations_lapse(tmp_path):
    """With AREAL_WORKER_KEEPALIVE_TTL set, the server's and the manager's
    registrations are leased: alive, a heartbeat keeps them past several
    TTLs; killed (no stop(), no exit handler), they lapse within a few."""
    import signal
    import subprocess
    import sys

    root = tmp_path / "nr"
    env = dict(os.environ, AREAL_WORKER_KEEPALIVE_TTL="1",
               AREAL_NAME_RESOLVE_ROOT=str(root), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.getcwd()] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)))
    repo = tnr.NfsNameRecordRepo(str(root))
    keys = [tnames.gen_servers("exp", "trial", "gen0"),
            tnames.gen_server_manager("exp", "trial")]
    proc = subprocess.Popen([sys.executable, "-c", _LEASED_FLEET], env=env,
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "up"
        time.sleep(3.0)  # three TTLs: only the heartbeat keeps them
        assert all(repo.get(k).startswith("http://") for k in keys)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(WAIT)
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline:
            try:
                for k in keys:
                    repo.get(k)
            except tnr.NameEntryNotFoundError:
                if all(_gone(repo, k) for k in keys):
                    break
            time.sleep(0.2)
        assert all(_gone(repo, k) for k in keys)
    finally:
        proc.kill()
        proc.wait(WAIT)
        proc.stdout.close()


def _gone(repo, key) -> bool:
    try:
        repo.get(key)
    except tnr.NameEntryNotFoundError:
        return True
    return False
