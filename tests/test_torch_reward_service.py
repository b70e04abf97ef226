"""The port's sandboxed reward service against the reference's.

Twins of ``tests/test_reward_service.py`` (16 tests) and
``tests/test_reward_parity.py`` (3 tests). Each sends the same tasks to
both packages: the reference's fleet members on aiohttp (served from an
event loop on a thread of this test's), the port's on the standard
library's threaded HTTP server, both registered in in-memory name-resolve
repositories. Verdicts, scores, ``/health`` and the ``/metrics.json`` keys
must be equal, and the disabled path bit-identical to local grading.

Every wait is bounded, and chaos comes from injected graders that block on
events, never from sleeps: a wedged grade holds its thread until the test
releases it, and the grade that must run on the replaced pool is a code
task whose budget (one case: 13 s) no scheduling delay can exhaust.
"""

import asyncio
import contextlib
import json
import os
import threading
import time
import urllib.request

import pytest

from areal_tpu.api.train_config import RewardServiceConfig as JRSConfig
from areal_tpu.api.train_config import TelemetryConfig as JTelConfig
from areal_tpu.base import name_resolve as jnr
from areal_tpu.rewards import client as jclient
from areal_tpu.rewards import code_verify as jcode
from areal_tpu.rewards import math_verify as jmath
from areal_tpu.rewards import service as jservice
from areal_tpu.system import reward_worker as jrw
from areal_tpu_torch.api.train_config import RewardServiceConfig as TRSConfig
from areal_tpu_torch.api.train_config import TelemetryConfig as TTelConfig
from areal_tpu_torch.base import name_resolve as tnr
from areal_tpu_torch.rewards import client as tclient
from areal_tpu_torch.rewards import code_verify as tcode
from areal_tpu_torch.rewards import math_verify as tmath
from areal_tpu_torch.rewards import service as tservice
from areal_tpu_torch.system import reward_worker as trw
from areal_tpu_torch.system.http import request_json

pytestmark = pytest.mark.rewards

EXP, TRIAL = "rewardsvc", "t0"
MATH_OK = {"task": "math", "generated": "\\boxed{4}",
           "solutions": ["\\boxed{4}"]}
MATH_BAD = {"task": "math", "generated": "\\boxed{5}",
            "solutions": ["\\boxed{4}"]}
CODE_IO = json.dumps({"inputs": ["1\n"], "outputs": ["1\n"]})
CODE_OK = {"task": "code", "generated": "```python\nprint(input())\n```",
           "input_output": CODE_IO}
CODE_BAD = {"task": "code", "generated": "```python\nprint('x')\n```",
            "input_output": CODE_IO}
# A fake grader's fast task with a budget no scheduling delay can spend:
# a one-case code task floors at 8 s x 1 + 5 s.
FAST = {"task": "code", "generated": "ok", "input_output": CODE_IO}
WEDGE = {"task": "math", "generated": "WEDGE"}
CORPUS = os.path.join(os.path.dirname(__file__), "fixtures",
                      "math_parity_corpus.jsonl")


@pytest.fixture(autouse=True)
def _mem_repos():
    old = jnr.DEFAULT_REPO, tnr.DEFAULT_REPO
    jnr.DEFAULT_REPO = jnr.MemoryNameRecordRepo()
    tnr.DEFAULT_REPO = tnr.MemoryNameRecordRepo()
    yield
    jnr.DEFAULT_REPO, tnr.DEFAULT_REPO = old
    jclient.configure_service(None)
    tclient.configure_service(None)


class RefLoop:
    """An event loop on a thread of its own, hosting reference workers."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout=60):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


@pytest.fixture()
def ref_loop():
    rl = RefLoop()
    yield rl
    rl.close()


def _cfgs(**kw):
    return JRSConfig(enabled=True, **kw), TRSConfig(enabled=True, **kw)


def _tworker(index=0, cfg=None, telemetry_enabled=False, grade_fn=None,
             ttl=0.0):
    return trw.RewardWorker(trw.RewardWorkerConfig(
        experiment=EXP, trial=TRIAL, worker_index=index,
        reward=cfg or TRSConfig(enabled=True),
        telemetry=TTelConfig(enabled=telemetry_enabled,
                             flush_interval_secs=3600),
        keepalive_ttl_secs=ttl), grade_fn=grade_fn)


def _jworker(index=0, cfg=None, telemetry_enabled=False, grade_fn=None):
    return jrw.RewardWorker(jrw.RewardWorkerConfig(
        experiment=EXP, trial=TRIAL, worker_index=index,
        reward=cfg or JRSConfig(enabled=True),
        telemetry=JTelConfig(enabled=telemetry_enabled,
                             flush_interval_secs=3600)), grade_fn=grade_fn)


@contextlib.contextmanager
def both_workers(ref_loop, n=1, cfg=None, **kw):
    """n reference and n port workers, started; yields (ref, port) lists."""
    jcfg, tcfg = cfg if cfg is not None else (None, None)
    js = [_jworker(i, jcfg, **kw) for i in range(n)]
    ts = [_tworker(i, tcfg, **kw) for i in range(n)]
    try:
        for w in js:
            ref_loop.run(w.start())
        for w in ts:
            w.start()
        yield js, ts
    finally:
        for w in ts:
            w.stop()
        for w in js:
            with contextlib.suppress(Exception):
                ref_loop.run(w.stop())


def get_text(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()


def post(url, body):
    return request_json(url, body, timeout=60)


def post_all(url, bodies):
    """POST every body at once, each on a thread; replies in order."""
    out = [None] * len(bodies)

    def one(i):
        out[i] = post(url, bodies[i])

    ts = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    return out


def test_service_grades_math_and_code_over_http(ref_loop):
    with both_workers(ref_loop, telemetry_enabled=True) as (js, ts):
        seen = {}
        for side, w in (("ref", js[0]), ("port", ts[0])):
            url = w.url
            outs = [post(f"{url}/math_verify", MATH_OK)[1],
                    post(f"{url}/math_verify", MATH_BAD)[1],
                    post(f"{url}/code_verify", CODE_OK)[1],
                    post(f"{url}/batch_reward",
                         {"tasks": [MATH_OK, CODE_BAD]})[1]]
            health = post(f"{url}/health", None)[1]
            metrics = post(f"{url}/metrics.json", None)[1]
            prom = get_text(f"{url}/metrics")
            seen[side] = (outs, health, metrics, prom)
        (jo, jh, jm, jp), (to, th, tm, tp) = seen["ref"], seen["port"]
        assert to == jo
        assert to[:3] == [{"score": 1.0, "verdict": "pass"},
                          {"score": 0.0, "verdict": "fail"},
                          {"score": 1.0, "verdict": "pass"}]
        assert to[3] == {"scores": [1.0, 0.0], "verdicts": ["pass", "fail"]}
        assert set(th) == set(jh) and th["ok"] and th["graded_total"] == 5
        for k in ("inflight", "graded_total", "timeouts_total", "languages"):
            assert th[k] == jh[k], k
        assert set(tm) == set(jm)
        for k in set(tm) - {"reward_worker_uptime_secs"}:
            assert tm[k] == jm[k], k
        for prom in (jp, tp):
            assert "areal_reward_requests_total" in prom
            assert 'task="math"' in prom and 'verdict="pass"' in prom
            assert "areal_reward_grade_latency_secs_bucket" in prom
            for ln in prom.splitlines():
                if ln and not ln.startswith("#"):
                    float(ln.rpartition(" ")[2])  # every sample parses
        families = [{ln.split("{")[0].split(" ")[0] for ln in p.splitlines()
                     if ln and not ln.startswith("#")} for p in (jp, tp)]
        assert families[0] == families[1]


def test_client_fanout_spreads_over_fleet(ref_loop):
    jcfg, tcfg = _cfgs(n_workers=2, max_concurrency=4)
    tasks = [MATH_OK, MATH_BAD] * 8
    with both_workers(ref_loop, 2, (jcfg, tcfg)) as (js, ts):
        jclient.configure_service(jcfg, EXP, TRIAL)
        tclient.configure_service(tcfg, EXP, TRIAL)
        jscores = ref_loop.run(jclient.abatch_reward(tasks))
        tscores = asyncio.run(tclient.abatch_reward(tasks))
        assert tscores == jscores == [1.0, 0.0] * 8
        for ws in (js, ts):
            assert all(w.service._graded > 0 for w in ws)
            assert sum(w.service._graded for w in ws) == 16
        assert tclient.service_client().counts == {"remote": 16}


def test_fleet_unreachable_local_fallback_parity(ref_loop):
    """No worker registered and a dead URL: every task degrades to local
    grading, and both packages answer what the local path answers."""
    jcfg, tcfg = _cfgs(max_retries=1, retry_base_delay_secs=0.01,
                       retry_max_delay_secs=0.01)
    tasks = [MATH_OK, MATH_BAD, CODE_OK, CODE_BAD]
    jc = jclient.configure_service(jcfg, EXP, TRIAL,
                                   urls=["http://127.0.0.1:9"])
    tc = tclient.configure_service(tcfg, EXP, TRIAL,
                                   urls=["http://127.0.0.1:9"])
    jscores = ref_loop.run(jclient.abatch_reward(tasks))
    tscores = asyncio.run(tclient.abatch_reward(tasks))
    assert tscores == jscores == [1.0, 0.0, 1.0, 0.0]
    assert tc is tclient.service_client() and jc is jclient.service_client()
    assert tc.counts["local_fallback"] == 4
    tclient.configure_service(None)
    jclient.configure_service(None)
    assert tclient.batch_reward(tasks) == jclient.batch_reward(tasks) \
        == tscores


def test_cold_start_registration_race_retries_before_fallback(ref_loop):
    """The fleet resolves empty at first (workers still registering): the
    client waits out the cold start instead of running code locally, and
    the worker that registers meanwhile grades the task."""
    jcfg, tcfg = _cfgs(max_retries=3, retry_base_delay_secs=0.05,
                       retry_max_delay_secs=0.1)
    jclient.configure_service(jcfg, EXP, TRIAL)
    tclient.configure_service(tcfg, EXP, TRIAL)
    jw, tw = _jworker(cfg=jcfg), _tworker(cfg=tcfg)

    async def ref_main():
        async def register_late():
            await asyncio.sleep(0.02)
            await jw.start()

        reg = asyncio.create_task(register_late())
        scores = await jclient.abatch_reward([CODE_OK])
        await reg
        return scores

    async def port_main():
        async def register_late():
            await asyncio.sleep(0.02)
            await asyncio.to_thread(tw.start)

        reg = asyncio.create_task(register_late())
        scores = await tclient.abatch_reward([CODE_OK])
        await reg
        return scores

    try:
        assert asyncio.run(port_main()) == ref_loop.run(ref_main()) == [1.0]
        # graded by the fleet, after the race, never locally
        assert tw.service._graded == jw.service._graded == 1
        assert tclient.service_client().counts["local_fallback"] == 0
    finally:
        tw.stop()
        ref_loop.run(jw.stop())


def test_mid_batch_worker_death_retries_on_survivor(ref_loop):
    """One replica dies mid-batch: its in-flight tasks retry on the
    survivor; every score lands, and the fleet view drops the dead URL."""
    jcfg, tcfg = _cfgs(n_workers=2, max_retries=2,
                       retry_base_delay_secs=0.01,
                       retry_max_delay_secs=0.02, max_concurrency=2)
    tasks = [MATH_OK, MATH_BAD] * 12
    # the reference, as its own test drives it
    j0, j1 = _jworker(0, jcfg), _jworker(1, jcfg)

    async def ref_main():
        await j0.start()
        await j1.start()

        async def kill_j0_soon():
            while j0.service._graded < 2:
                await asyncio.sleep(0.005)
            await j0.stop()

        jclient.configure_service(jcfg, EXP, TRIAL)
        killer = asyncio.create_task(kill_j0_soon())
        scores = await jclient.abatch_reward(tasks)
        await killer
        await j1.stop()
        return scores

    jscores = ref_loop.run(ref_main())
    # the port, the kill on an event
    w0, w1 = _tworker(0, tcfg), _tworker(1, tcfg)
    u0 = w0.start()
    w1.start()
    two_graded = threading.Event()
    inner = w0.service.grade

    def counting(task):
        out = inner(task)
        if w0.service._graded >= 2:
            two_graded.set()
        return out

    w0.service.grade = counting

    def kill_w0():
        assert two_graded.wait(30)
        w0.stop()  # socket closed, discovery withdrawn

    try:
        client = tclient.configure_service(tcfg, EXP, TRIAL)
        assert u0 in client.refresh()
        killer = threading.Thread(target=kill_w0)
        killer.start()
        scores = asyncio.run(tclient.abatch_reward(tasks))
        killer.join(30)
        assert scores == jscores == [1.0, 0.0] * 12
        assert w1.service._graded > 0 and j1.service._graded > 0
        assert u0 not in client.refresh()
        assert client.counts["local_fallback"] == 0
        assert client.counts["remote"] == 24
    finally:
        w1.stop()
        w0.stop()


def test_timeout_returns_zero_verdict_and_counter(ref_loop):
    """A grade overrunning its budget answers 0.0 "timeout" and counts
    reward/timeouts; the next grade runs normally."""
    release = threading.Event()

    def slow_grade(task):
        if task.get("generated") == "SLOW":
            release.wait(30)
        return {"score": 1.0, "verdict": "pass"}

    cfgs = _cfgs(grade_timeout_secs=0.05)
    try:
        with both_workers(ref_loop, 1, cfgs, telemetry_enabled=True,
                          grade_fn=slow_grade) as (js, ts):
            for w in (js[0], ts[0]):
                _, out = post(f"{w.url}/math_verify",
                              {"task": "math", "generated": "SLOW"})
                assert out == {"score": 0.0, "verdict": "timeout"}
                _, out = post(f"{w.url}/code_verify", FAST)
                assert out == {"score": 1.0, "verdict": "pass"}
                assert w.service._timeouts == 1
                assert w.telemetry.registry.snapshot(reset=False)[
                    "counters"]["reward/timeouts"] == 1
                assert "areal_reward_timeouts_total" in get_text(
                    f"{w.url}/metrics")
    finally:
        release.set()


def test_task_budget_floors_code_worst_case():
    one_case = json.dumps({"inputs": ["1\n"], "outputs": ["1\n"]})
    many = json.dumps({"inputs": ["1\n"] * 500, "outputs": ["1\n"] * 500})
    cases = [({"task": "math"}, 30.0, 30.0),
             ({"task": "code", "timeout": 8.0}, 30.0, 8.0 * 16 + 5.0),
             ({"task": "code", "timeout": 0.1}, 30.0, 30.0),
             ({"task": "code", "timeout": 8.0, "input_output": one_case},
              5.0, 8.0 * 1 + 5.0),
             ({"task": "code", "timeout": 8.0, "input_output": many},
              5.0, 8.0 * 16 + 5.0),
             ({"task": "code", "input_output": "{not json"}, 5.0,
              8.0 * 16 + 5.0)]
    for task, base, want in cases:
        assert tservice.task_budget_secs(task, base) == want
        assert jservice.task_budget_secs(task, base) == want


def test_sample_cases_honors_cap_for_every_length():
    for n in (1, 15, 16, 17, 31, 32, 33, 500):
        args = ([str(i) for i in range(n)], [str(i) for i in range(n)], 16)
        got = tcode.sample_cases(*args)
        assert got == jcode.sample_cases(*args)
        assert len(got) <= 16 and got[0] == ("0", "0")
    assert tcode.sample_cases([], [], 16) == jcode.sample_cases([], [], 16) \
        == []


def _wedge_grader(release):
    def grade(task):
        if task.get("generated") == "WEDGE":
            release.wait(30)
        return {"score": 1.0, "verdict": "pass"}
    return grade


def _sem_value(sem):
    return sem._value


def _settle(side, ref_loop, w):
    """Wait for the zombies' completions to take effect: the old pool's
    threads have ended, and (reference) its loop ran their callbacks."""
    if side == "ref":
        for _ in range(5):  # future -> done callback -> threadsafe restore
            ref_loop.run(asyncio.sleep(0))


def test_wedged_grader_pool_self_heals():
    """Once every admittable thread is wedged past its budget, the pool is
    replaced: a fresh grade runs at once on the new pool while the wedge
    still holds, and the restored permits are exactly the admission
    limit, also after the zombies end (their stale completions restore
    nothing). The port alone: the reference replaces its pool here only
    when both timeouts land in one loop iteration (each restores its
    permit at once, Queue 3 item 4 of ROADMAP.md), which is the load
    sensitivity its own test has shown; its replacement at the limit is
    held in the next test, where one zombie is the limit."""
    release = threading.Event()
    _, tcfg = _cfgs(pool_size=2, max_inflight=2, grade_timeout_secs=0.05)
    w = _tworker(cfg=tcfg, grade_fn=_wedge_grader(release))
    w.start()
    try:
        pool0 = w.service._pool
        outs = post_all(f"{w.url}/math_verify", [WEDGE, WEDGE])
        assert [o[1]["verdict"] for o in outs] == ["timeout"] * 2
        assert w.service._pool is not pool0  # swapped out
        # a fresh grade while both old threads are still wedged
        _, out = post(f"{w.url}/code_verify", FAST)
        assert out == {"score": 1.0, "verdict": "pass"}
        assert not release.is_set()
        assert (w.service._withheld, w.service._pool_gen,
                _sem_value(w.service._sem)) == (0, 1, 2)
        release.set()
        pool0.shutdown(wait=True)  # the zombies end
        assert (w.service._withheld, _sem_value(w.service._sem)) == (0, 2)
    finally:
        release.set()
        w.stop()


def test_self_heal_triggers_at_admission_limit(ref_loop):
    """max_inflight < pool_size: the replacement triggers at the clamped
    admission bound (one zombie here), else admission would deadlock."""
    release = threading.Event()
    cfgs = _cfgs(pool_size=8, max_inflight=1, grade_timeout_secs=0.05)
    try:
        with both_workers(ref_loop, 1, cfgs,
                          grade_fn=_wedge_grader(release)) as (js, ts):
            for w in (js[0], ts[0]):
                _, out = post(f"{w.url}/math_verify", WEDGE)
                assert out["verdict"] == "timeout"
                assert w.service._pool_gen == 1
                _, out = post(f"{w.url}/code_verify", FAST)
                assert out["verdict"] == "pass"  # admitted, not deadlocked
                assert not release.is_set()
                assert _sem_value(w.service._sem) == 1
    finally:
        release.set()


def test_zombie_below_the_limit_holds_its_permit_until_its_thread_ends(
        ref_loop):
    """Below the admission limit a timed-out grade's permit stays withheld
    until its thread ends (the pool is kept), so that no grade is admitted
    without a free thread. This is the reference's documented design; its
    code restores the permit on the next loop iteration instead, because
    ``asyncio.wait_for`` cancels the executor future it then watches
    (ROADMAP.md Queue 3). Both are pinned here."""
    release = threading.Event()
    cfgs = _cfgs(pool_size=4, max_inflight=4, grade_timeout_secs=0.05)
    try:
        with both_workers(ref_loop, 1, cfgs,
                          grade_fn=_wedge_grader(release)) as (js, ts):
            for side, w in (("ref", js[0]), ("port", ts[0])):
                _, out = post(f"{w.url}/math_verify", WEDGE)
                assert out == {"score": 0.0, "verdict": "timeout"}
                _settle(side, ref_loop, w)
                assert w.service._pool_gen == 0
            j, t = js[0].service, ts[0].service
            assert (j._withheld, _sem_value(j._sem)) == (0, 4)
            assert (t._withheld, _sem_value(t._sem)) == (1, 3)
            release.set()
            t._pool.shutdown(wait=True)  # the zombie ends
            assert (t._withheld, _sem_value(t._sem)) == (0, 4)
    finally:
        release.set()


def test_cancelled_grade_returns_at_once_and_settles_later():
    """A rollout cancelled while its grade is wedged on a worker returns at
    once, without waiting for the reply. The call runs on: ``settle``
    returns within its grace while the wedge holds, and once the worker
    answers, the grade counts as ``remote``, as many as the worker
    graded. The port alone (the reference drops such a call)."""
    from areal_tpu_torch.system.http import AsyncHttp

    release, entered = threading.Event(), threading.Event()

    def grade(task):
        entered.set()
        release.wait(30)
        return {"score": 1.0, "verdict": "pass"}

    _, tcfg = _cfgs(grade_timeout_secs=60.0)
    w = _tworker(cfg=tcfg, grade_fn=grade)
    w.start()
    client = tclient.RewardServiceClient(tcfg, urls=[w.url])

    async def cancel_then_settle():
        session = AsyncHttp(max_workers=2)
        try:
            task = asyncio.ensure_future(client.grade_one(
                session, MATH_OK, asyncio.Semaphore(1)))
            assert await asyncio.to_thread(entered.wait, 30)
            t0 = time.monotonic()
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task
            cancel_secs = time.monotonic() - t0
            t0 = time.monotonic()
            out = await client.settle(0.2)
            wedged = (out, time.monotonic() - t0)
            release.set()
            return cancel_secs, wedged, await client.settle(30)
        finally:
            session.close()

    try:
        cancel_secs, (out, settle_secs), left = asyncio.run(
            cancel_then_settle())
        assert cancel_secs < 1.0
        assert out == 1 and settle_secs < 2.0
        assert left == 0
        assert client.counts["remote"] == 1 == w.service._graded
    finally:
        release.set()
        w.stop()


def test_unsupported_language_verdict():
    task = {"task": "code", "generated": "```cpp\nint main(){}\n```",
            "input_output": CODE_IO, "language": "cpp"}
    want = {"score": 0.0, "verdict": "unsupported_language"}
    assert tservice.grade_task(task) == jservice.grade_task(task) == want
    task = {**CODE_OK, "language": "python"}
    assert tservice.grade_task(task, languages=[]) \
        == jservice.grade_task(task, languages=[]) == want


def test_inflight_cap_bounds_concurrency(ref_loop):
    import time as _t

    peak = {"v": 0, "cur": 0}
    lock = threading.Lock()

    def counting_grade(task):
        with lock:
            peak["cur"] += 1
            peak["v"] = max(peak["v"], peak["cur"])
        _t.sleep(0.02)
        with lock:
            peak["cur"] -= 1
        return {"score": 1.0, "verdict": "pass"}

    cfgs = _cfgs(max_inflight=2, pool_size=8)
    with both_workers(ref_loop, 1, cfgs, grade_fn=counting_grade) as (js,
                                                                      ts):
        for w in (js[0], ts[0]):
            peak["v"] = 0
            outs = post_all(f"{w.url}/math_verify",
                            [{"task": "math", "generated": "x"}] * 10)
            assert all(o[1]["score"] == 1.0 for o in outs)
            assert peak["v"] <= 2  # the admission bound, not the pool's


def test_batch_reward_sync_on_running_loop_raises():
    async def main():
        for mod in (tclient, jclient):
            with pytest.raises(RuntimeError, match="abatch_reward"):
                mod.batch_reward([MATH_OK])

    asyncio.run(main())


def test_agent_env_awaits_async_grading():
    from areal_tpu.agents.math_single_step import MathCodeSingleStepEnv as J
    from areal_tpu_torch.agents.math_single_step import (
        MathCodeSingleStepEnv as T,
    )

    info = {"q1": {"task": "math", "solutions": ["\\boxed{4}"]}}

    async def main(env):
        _, scores, done, _ = await env.step(("q1", ["\\boxed{4}", "no"]))
        return scores, done

    assert asyncio.run(main(T(info))) == asyncio.run(main(J(info))) \
        == ([1.0, 0.0], True)


def test_code_agent_format_gate_and_pass_rate():
    from areal_tpu.agents.code_single_step import CodeSingleStepEnv as J
    from areal_tpu_torch.agents.code_single_step import (
        CodeSingleStepEnv as T,
    )

    io = json.dumps({"inputs": ["1\n", "2\n"], "outputs": ["1\n", "2\n"]})
    info = {"c1": {"task": "code", "input_output": io}}
    half = "```python\nx=input()\nprint(x if x=='1' else 'no')\n```"

    async def main(cls):
        _, gate, _, _ = await cls(info).step(
            ("c1", ["```python\nprint(input())\n```", "just prose"]))
        _, rate, _, _ = await cls(info, pass_rate_reward=True).step(
            ("c1", [half]))
        return gate, rate

    got = asyncio.run(main(T))
    assert got == asyncio.run(main(J))
    assert got[0] == [1.0, 0.0] and got[1] == [pytest.approx(0.5)]


def test_worker_control_and_lease_registration():
    """run() serves WorkerControl (status, heartbeat under the launcher's
    worker name, exit) and withdraws discovery on exit."""
    from areal_tpu_torch.system.worker_base import WorkerControlPanel

    w = _tworker(ttl=30.0)
    t = threading.Thread(target=w.run, daemon=True)
    t.start()
    panel = WorkerControlPanel(EXP, TRIAL, timeout=5.0)
    try:
        url = tnr.wait(tnr_key(), timeout=10)
        assert trw.resolve_fleet(EXP, TRIAL) == [url]
        assert post(f"{url}/health", None)[1]["ok"]
        st = panel.status("reward0")
        assert st["ok"] and st["url"] == url and st["graded"] == 0
        assert "reward0" in panel.heartbeats()
        panel.exit("reward0")
        t.join(10)
        assert not t.is_alive()
        assert trw.resolve_fleet(EXP, TRIAL) == []
        assert panel.heartbeats() == {}
    finally:
        panel.close()
        if t.is_alive():
            w.stop()


def tnr_key():
    from areal_tpu_torch.base import names

    return names.reward_worker(EXP, TRIAL, "rw0")


# ---------------- twins of tests/test_reward_parity.py ----------------

KNOWN_DIVERGENCES = {"p082", "p083", "p116"}


def _corpus():
    with open(CORPUS) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def test_corpus_shape_and_allowlist_pinned():
    entries = _corpus()
    assert len(entries) >= 200
    assert len({e["id"] for e in entries}) == len(entries)
    assert {e["id"] for e in entries if "divergence" in e} \
        == KNOWN_DIVERGENCES
    for e in entries:
        if "divergence" in e:
            got = tmath.verify_math(e["generated"], e["solutions"])
            assert got == e["expected"] != e["reference_expected"], e["id"]


def test_math_grader_agrees_on_whole_corpus():
    mism = []
    for e in _corpus():
        got = tmath.verify_math(e["generated"], e["solutions"])
        ref = jmath.verify_math(e["generated"], e["solutions"])
        if not got == ref == e["expected"]:
            mism.append((e["id"], e["expected"], ref, got))
    assert not mism, f"{len(mism)} corpus mismatches: {mism[:10]}"


def test_disabled_service_batch_reward_bit_identical():
    """Service off (the default): the port's batch_reward over the corpus is
    bit-identical to direct local grading and to the reference's."""
    tclient.configure_service(TRSConfig())  # disabled: clears
    assert tclient.service_client() is None
    entries = _corpus()
    tasks = [{"task": "math", "generated": e["generated"],
              "solutions": e["solutions"]} for e in entries]
    # One grading thread: a symbolic comparison runs in a forked child
    # with a 3 s limit in both packages, and eight at once on a loaded
    # host can run out of it (the reference's twin of this test failed a
    # loaded run so); the path under test is the same with one.
    got = tclient.batch_reward(tasks, max_workers=1)
    direct = [tmath.verify_math(e["generated"], e["solutions"])
              for e in entries]
    assert got == direct
    assert got == jclient.batch_reward(tasks, max_workers=1)
    assert got == [e["expected"] for e in entries]


def test_perf_probe_reward_bench_against_a_live_fleet(capsys):
    """``reward-bench`` against a live two-worker fleet (found through
    name_resolve; telemetry on, so each worker's /metrics carries its
    verdicts): the reference's lines, every task answered by the fleet,
    the verdicts adding up; and the reference's own tool
    (``tools/perf_probe.py reward-bench <url>``, jax-free) on one port
    worker gives the port's mean score for the same seeded tasks."""
    import subprocess
    import sys

    from areal_tpu_torch.tools import perf_probe

    ts = [_tworker(i, telemetry_enabled=True) for i in range(2)]
    for w in ts:
        w.start()
    try:
        out = perf_probe.reward_bench(EXP, TRIAL, 16)
        text = capsys.readouterr().out
        assert "[reward-bench] fleet: 2 worker(s)" in text
        assert "[reward-bench] 16 tasks in" in text
        assert "[reward-bench] math  n=12" in text
        assert "[reward-bench] code  n=4" in text
        assert "fleet verdicts (per-worker)" in text
        assert out["client"] == {"remote": 16}
        assert sum(out["verdicts"].values()) == 16
        assert sum(w.service._graded for w in ts) == 16
        one = perf_probe.reward_bench(ts[0].url, n_tasks=16)
        capsys.readouterr()
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        ref = subprocess.run(
            [sys.executable, "tools/perf_probe.py", "reward-bench",
             ts[0].url, "16"], capture_output=True, text=True, cwd=root,
            env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=120)
        assert ref.returncode == 0, ref.stderr
        mean = [ln for ln in ref.stdout.splitlines() if "mean score" in ln]
        assert mean and mean[0].endswith(f"mean score {one['mean_score']:.3f}")
        assert one["mean_score"] == out["mean_score"]
    finally:
        for w in ts:
            w.stop()
