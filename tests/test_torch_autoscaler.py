"""The port's elastic fleet against the reference's.

Twins of the tier-1 tests of ``tests/test_autoscaler.py``: the fault
injector's delay mode, the decision core (hysteresis, cooldowns, bounds,
the staleness gate, the overload latch, wedged heartbeats), the straggler
tracker, the manager's cordon and drain, straggler routing, the injected-
latency straggler path over real ``/health`` probes, overload backpressure,
the rollout worker's Retry-After, the plan and the executor, the autoscale
tick's scale-down, and the supervisor's expendable kind. Then the parity
checks: ``AutoscalerCore`` plans and ``StragglerTracker`` sweeps equal the
reference's on the same seeded signal sequences, and both managers answer
``/cordon``, ``/uncordon`` and capacity denials reply for reply.

Every clock is a fake one; the only real waits are bounded HTTP round
trips.
"""

import asyncio
import json
import random
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from areal_tpu_torch.api.train_config import AutoscaleConfig
from areal_tpu_torch.base import name_resolve as tnr
from areal_tpu_torch.base import names as tnames
from areal_tpu_torch.base.retry import FaultInjector
from areal_tpu_torch.system.autoscaler import (
    AutoscaleExecutor,
    AutoscalerCore,
    FleetSignals,
    StragglerTracker,
    publish_plan,
    read_plan,
)
from areal_tpu_torch.system.gserver_manager import (
    GserverManager,
    GserverManagerConfig,
    _ServerHealth,
)

pytestmark = pytest.mark.autoscale

EXP, TRIAL = "torch_autoscale", "t0"
WAIT = 30.0  # bound on every wait of a test


@pytest.fixture()
def nr(tmp_path):
    old = tnr.DEFAULT_REPO
    tnr.DEFAULT_REPO = tnr.NfsNameRecordRepo(str(tmp_path / "nr"))
    yield tnr.DEFAULT_REPO
    tnr.DEFAULT_REPO = old


def _cfg(**asc_kw) -> GserverManagerConfig:
    return GserverManagerConfig(experiment=EXP, trial=TRIAL,
                                autoscale=AutoscaleConfig(enabled=True,
                                                          **asc_kw))


def _mgr(**asc_kw) -> GserverManager:
    return GserverManager(_cfg(**asc_kw))


def _add_server(mgr, url, server_id="", routable=True):
    st = _ServerHealth(routable=routable)
    st.server_id = server_id
    mgr.health[url] = st
    if routable:
        mgr.servers.append(url)
        mgr.servers.sort()
        mgr._inflight.setdefault(url, 0)
    return st


# ---------------- the fault injector's delays ----------------


@pytest.mark.chaos
def test_fault_injector_delay_mode_deterministic():
    slept = []

    async def fake_sleep(secs):
        slept.append(secs)  # records, never waits

    inj = FaultInjector(sleeper=fake_sleep)
    inj.arm_delay("decode", 0.8, times=2,
                  when=lambda ctx: ctx.get("server_id") == "gen1")

    async def main():
        assert await inj.maybe_delay("decode", server_id="gen0") == 0.0
        assert await inj.maybe_delay("decode", server_id="gen1") == 0.8
        assert await inj.maybe_delay("decode", server_id="gen1") == 0.8
        assert await inj.maybe_delay("decode", server_id="gen1") == 0.0

    asyncio.run(main())
    assert slept == [0.8, 0.8]
    assert inj.fired["decode"] == 2
    inj.arm_delay("decode", 0.5, times=-1)
    assert inj.delay_for("decode") == 0.5
    assert inj.delay_for("decode") == 0.5
    inj.disarm("decode")
    assert inj.delay_for("decode") == 0.0
    inj.arm("decode", times=1)
    with pytest.raises(Exception):
        inj.maybe_fail("decode")


# ---------------- the decision core ----------------


def test_core_hysteresis_cooldown_and_bounds():
    t = [0.0]
    cfg = AutoscaleConfig(
        enabled=True, min_servers=1, max_servers=3, up_consecutive=2,
        down_consecutive=2, scale_up_cooldown_secs=10.0,
        scale_down_cooldown_secs=20.0, up_utilization=0.8,
        down_utilization=0.2, queue_high=8.0, queue_low=1.0)
    core = AutoscalerCore(cfg, clock=lambda: t[0])
    hot = FleetSignals(current_size=1, utilization=0.95)
    assert core.observe(hot) is None  # one hot interval is not enough
    assert core.target == 1
    a = core.observe(hot)
    assert a == {"action": "up", "target": 2, "reason": a["reason"]}
    assert "utilization" in a["reason"]
    assert core.observe(hot) is None  # the cooldown holds
    assert core.observe(hot) is None
    t[0] = 11.0
    assert core.observe(hot)["target"] == 3
    t[0] = 30.0
    for _ in range(5):  # pinned at max
        assert core.observe(hot) is None
    assert core.target == 3
    idle = FleetSignals(current_size=3, utilization=0.0, queue_depth=0.0)
    t[0] = 100.0
    assert core.observe(idle) is None
    a = core.observe(idle)
    assert a["action"] == "down" and core.target == 2
    assert core.observe(idle) is None
    core.observe(hot)  # one hot interval resets the down streak
    t[0] = 200.0
    assert core.observe(idle) is None
    a = core.observe(idle)
    assert a["action"] == "down" and core.target == 1
    t[0] = 300.0
    for _ in range(5):  # never below min_servers
        assert core.observe(idle) is None
    assert core.target == 1


def test_core_staleness_gate_inhibits_scale_up_and_overload_latches():
    t = [0.0]
    cfg = AutoscaleConfig(enabled=True, min_servers=1, max_servers=2,
                          up_consecutive=1, scale_up_cooldown_secs=0.0,
                          up_utilization=0.8)
    core = AutoscalerCore(cfg, clock=lambda: t[0])
    # saturated, but the gate is closed: the trainer is the bottleneck
    staled = FleetSignals(current_size=1, utilization=1.0, staled=True)
    assert core.observe(staled) is None
    assert core.target == 1 and not core.overloaded
    t[0] = 1.0
    assert core.observe(FleetSignals(current_size=1,
                                     utilization=1.0))["target"] == 2
    t[0] = 2.0
    assert core.observe(FleetSignals(current_size=2, utilization=1.0)) is None
    assert core.overloaded  # at max and still saturated
    assert core.observe(FleetSignals(current_size=2, utilization=0.0)) is None
    assert not core.overloaded


def test_core_wedged_heartbeats_count_against_capacity():
    core = AutoscalerCore(AutoscaleConfig(enabled=True, min_servers=1,
                                          max_servers=4), clock=lambda: 0.0)
    core.observe(FleetSignals(current_size=3, stale_heartbeats=2))
    assert core.target == 1  # 3 routable, 2 wedged


# ---------------- straggler scoring ----------------


def test_straggler_tracker_peer_median_scoring():
    tr = StragglerTracker(factor=3.0, min_probes=3, slow_sweeps=2,
                          cordon_sweeps=4, floor_secs=0.002)
    urls = ["a", "b", "c"]
    for _ in range(5):  # below the noise floor nothing is slow
        tr.observe("a", 0.0001)
        tr.observe("b", 0.0001)
        tr.observe("c", 0.001)
        assert tr.sweep(urls)["c"] == "ok"
    tr = StragglerTracker(factor=3.0, min_probes=3, slow_sweeps=2,
                          cordon_sweeps=4, floor_secs=0.002)
    verdicts = []
    for _ in range(8):
        tr.observe("a", 0.010)
        tr.observe("b", 0.012)
        tr.observe("c", 0.100)  # ~9x the peer median
        verdicts.append(tr.sweep(urls)["c"])
    assert verdicts[0] == "ok" and verdicts[1] == "ok"
    assert "slow" in verdicts and verdicts[-1] == "cordon"
    assert verdicts.index("slow") < verdicts.index("cordon")
    assert tr.sweep(urls)["a"] == "ok" and tr.sweep(urls)["b"] == "ok"
    solo = StragglerTracker(min_probes=1)  # no peers: cannot judge
    solo.observe("x", 5.0)
    assert solo.sweep(["x"])["x"] == "ok"


# ---------------- cordon ----------------


@pytest.mark.chaos
def test_cordon_blocks_new_leases_drains_existing_then_uncordon():
    mgr = _mgr()
    u1, u2 = "http://s1:1", "http://s2:2"
    _add_server(mgr, u1, "gen0")
    _add_server(mgr, u2, "gen1")
    _, lease = mgr.schedule_request({})
    victim = lease["url"]
    other = u2 if victim == u1 else u1
    assert mgr.cordon(victim, "preemption notice") is True
    assert mgr.cordon(victim, "again") is False  # idempotent
    st = mgr.health[victim]
    assert st.cordoned and not st.routable
    for _ in range(4):  # new leases avoid it...
        assert mgr.schedule_request({})[1]["url"] == other
    # ...the old one stays valid and renews (drain, don't kill)
    assert mgr.renew({"lease_id": lease["lease_id"]})[1]["ok"]
    assert mgr._server_draining_load(victim) == 1
    mgr._admit(victim)  # the health sweep never re-admits it
    assert victim not in mgr.servers
    mgr.release({"lease_id": lease["lease_id"]})
    assert mgr._server_draining_load(victim) == 0
    # uncordon goes back through the health gate, not straight to routing
    assert mgr.uncordon(victim) is True
    assert victim not in mgr.servers and not mgr.health[victim].cordoned
    mgr._admit(victim)
    assert victim in mgr.servers


@pytest.mark.chaos
def test_evicting_a_cordoned_server_still_retires_its_leases():
    mgr = _mgr()
    _add_server(mgr, "http://s1:1", "gen0")
    _add_server(mgr, "http://s2:2", "gen1")
    for _ in range(2):
        mgr.schedule_request({})
    victim = next(u for u, _ in mgr._leases.values())
    mgr.cordon(victim, "preemption")
    assert mgr._server_draining_load(victim) >= 1
    mgr._evict(victim, "deregistered from name_resolve")
    assert mgr._server_draining_load(victim) == 0
    assert all(u != victim for u, _ in mgr._leases.values())


@pytest.mark.chaos
def test_pick_server_deprioritizes_stragglers_until_none_left():
    mgr = _mgr()
    u1, u2 = "http://s1:1", "http://s2:2"
    _add_server(mgr, u1, "gen0")
    _add_server(mgr, u2, "gen1")
    mgr.health[u2].deprioritized = True
    for _ in range(4):
        assert mgr._pick_server() == u1
    mgr.servers.remove(u1)
    assert mgr._pick_server() == u2  # the last resort


# ---------------- stragglers over real /health probes ----------------


class _FakeHealth:
    """A generation-server stand-in whose /health reports the decode EWMA a
    FaultInjector delay point injects."""

    def __init__(self, inj, server_id):
        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server naming)
                extra = inj.delay_for("decode", server_id=server_id)
                data = json.dumps({
                    "ok": True, "version": 0, "server_id": server_id,
                    "queue_depth": 0, "decode_ewma_secs": 0.010 + extra,
                    "ttfc_ewma_secs": 0.0}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.http = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.http.server_address[1]}"
        threading.Thread(target=self.http.serve_forever, daemon=True).start()

    def close(self):
        self.http.shutdown()
        self.http.server_close()


@pytest.mark.chaos
def test_injected_decode_latency_deprioritizes_then_cordons(nr):
    """A server with injected decode latency is deprioritized, then
    cordoned, from the /health EWMAs alone; the fleet routes to its healthy
    peers throughout."""
    inj = FaultInjector()
    inj.arm_delay("decode", 0.200, times=-1,
                  when=lambda ctx: ctx.get("server_id") == "gen2")
    mgr = GserverManager(_cfg(straggler_min_probes=2, straggler_slow_sweeps=2,
                              straggler_cordon_sweeps=4,
                              straggler_factor=3.0))
    fakes = {sid: _FakeHealth(inj, sid) for sid in ("gen0", "gen1", "gen2")}
    try:
        for sid, f in fakes.items():
            tnr.add(tnames.gen_servers(EXP, TRIAL, sid), f.url, replace=True)
        straggler = fakes["gen2"].url
        seen = []
        for _ in range(8):
            mgr.check_fleet()
            deadline = time.monotonic() + WAIT  # re-admissions are detached
            while len(mgr.servers) < 3 and not any(
                    st.cordoned for st in mgr.health.values()):
                assert time.monotonic() < deadline
                time.sleep(0.01)
            st = mgr.health.get(straggler)
            seen.append("cordoned" if st and st.cordoned
                        else "slow" if st and st.deprioritized else "ok")
            if seen[-1] == "cordoned":
                break
        assert "slow" in seen, seen
        assert seen[-1] == "cordoned", seen
        assert seen.index("slow") < len(seen) - 1
        assert sorted(mgr.servers) == sorted([fakes["gen0"].url,
                                              fakes["gen1"].url])
        assert mgr._pick_server() in (fakes["gen0"].url, fakes["gen1"].url)
        assert mgr.health[straggler].cordon_reason.startswith("straggler")
    finally:
        mgr._pool.shutdown(wait=False)
        for f in fakes.values():
            f.close()


# ---------------- backpressure ----------------


@pytest.mark.chaos
def test_capacity_denials_carry_retry_after_only_while_overloaded(nr):
    mgr = _mgr(max_servers=1, up_consecutive=1, backpressure_retry_secs=3.5)
    _add_server(mgr, "http://s1:1", "gen0")
    mgr.cfg.max_concurrent_rollouts = 2
    mgr.running_rollouts = 2  # saturated
    assert mgr.allocate_rollout({"n_samples": 1})[1] == {
        "allowed": False, "reason": "capacity"}
    mgr._autoscale_tick()  # pinned at max under saturation: overloaded
    assert mgr._overloaded
    d = mgr.allocate_rollout({"n_samples": 1})[1]
    assert d["reason"] == "capacity" and d["retry_after"] == 3.5
    mgr.running_rollouts = 0
    mgr._autoscale_tick()
    mgr.running_rollouts = 2
    assert "retry_after" not in mgr.allocate_rollout({"n_samples": 1})[1]


@pytest.mark.chaos
def test_rollout_worker_honors_denial_retry_after(monkeypatch):
    from areal_tpu_torch.system.rollout_worker import (
        RolloutWorker,
        RolloutWorkerConfig,
    )

    w = RolloutWorker.__new__(RolloutWorker)  # no dataset, no agent
    w.cfg = RolloutWorkerConfig()
    w._mgr_url0 = "http://mgr:1"
    w.client = None
    w.denials = {}
    w._who = {"worker": "rollout0", "incarnation": 0}

    async def fake_post(session, url, payload, timeout_secs=15.0):
        return {"allowed": False, "reason": "capacity", "retry_after": 2.75}

    w._post_json = fake_post
    slept = []

    async def fake_sleep(secs):
        slept.append(secs)

    monkeypatch.setattr(asyncio, "sleep", fake_sleep)
    assert asyncio.run(w._rollout_one(None, "q0", None, None, None)) == "retry"
    assert slept == [2.75]  # the hint, not the 0.5 s default
    assert w.denials == {"capacity": 1}


# ---------------- the plan and the executor ----------------


class _FakeSupervisorCounts:
    def __init__(self):
        self.alive = 0
        self._draining = False

    def alive_count(self, kind):
        return self.alive


def test_plan_roundtrip_and_executor_spawns_with_cooldown(nr):
    t = [0.0]
    sup = _FakeSupervisorCounts()
    spawned = []

    def spawn(sid):
        spawned.append(sid)
        sup.alive += 1

    ex = AutoscaleExecutor(EXP, TRIAL, sup, spawn, spawn_cooldown_secs=5.0,
                           clock=lambda: t[0])
    assert ex.step() is None  # no plan yet
    publish_plan(EXP, TRIAL, {"target": 3, "dynamic": 2, "ts": 1.0})
    assert read_plan(EXP, TRIAL)["dynamic"] == 2
    assert ex.step() == "dyn1"
    assert ex.step() is None  # the cooldown
    t[0] = 6.0
    assert ex.step() == "dyn2"
    t[0] = 20.0
    assert ex.step() is None  # satisfied
    assert spawned == ["dyn1", "dyn2"]
    sup.alive = 1  # one removed: replaced under a fresh id
    assert ex.step() == "dyn3"
    sup.alive = 0
    sup._draining = True
    t[0] = 40.0
    assert ex.step() is None  # a draining supervisor: no spawn


@pytest.mark.chaos
def test_autoscale_tick_publishes_plan_and_scale_down_cordons_dynamic(
        nr, monkeypatch):
    mgr = _mgr(min_servers=1, max_servers=3, up_consecutive=1,
               scale_up_cooldown_secs=0.0)
    _add_server(mgr, "http://s1:1", "gen0")
    mgr.cfg.max_concurrent_rollouts = 4
    mgr.running_rollouts = 4  # hot
    mgr._autoscale_tick()
    plan = read_plan(EXP, TRIAL)
    assert plan["target"] == 2 and plan["dynamic"] == 1
    assert mgr.autoscaler.target == 2
    _add_server(mgr, "http://s2:2", "dyn1")  # the dynamic server joins
    mgr.running_rollouts = 0
    mgr.autoscaler.target = 1
    exits = []
    monkeypatch.setattr(mgr, "_command_server_exit",
                        lambda sid: exits.append(sid) or True)
    mgr._autoscale_tick()
    st = mgr.health["http://s2:2"]
    assert st.cordoned and st.cordon_reason.startswith("scale-down")
    assert "http://s2:2" not in mgr.servers
    mgr._drain_cordoned()  # no lease: drained at once
    assert exits == ["dyn1"] and st.exit_commanded
    assert read_plan(EXP, TRIAL)["dynamic"] == 0


@pytest.mark.chaos
def test_scale_down_reclaims_cordoned_baseline_before_spawning(nr):
    mgr = _mgr(min_servers=1, max_servers=3)
    _add_server(mgr, "http://s1:1", "gen0")
    _add_server(mgr, "http://s2:2", "gen1")
    mgr.autoscaler.target = 1
    mgr._autoscale_tick()  # cordons one baseline server
    cordoned = [u for u, st in mgr.health.items() if st.cordoned]
    assert len(cordoned) == 1
    mgr.autoscaler.target = 2  # pressure is back: reclaim, don't spawn
    mgr._autoscale_tick()
    assert not mgr.health[cordoned[0]].cordoned
    assert read_plan(EXP, TRIAL)["dynamic"] == 0


# ---------------- a flapping dynamic server ----------------


class _FakeProc:
    _next_pid = [2000]

    def __init__(self):
        _FakeProc._next_pid[0] += 1
        self.pid = _FakeProc._next_pid[0]
        self._alive = True
        self.exitcode = None

    def is_alive(self):
        return self._alive

    def die(self, code):
        self._alive = False
        self.exitcode = code

    def join(self, timeout=None):
        pass

    def terminate(self):
        self.die(-15)

    def kill(self):
        self.die(-9)


@pytest.mark.chaos
def test_flapping_server_trips_breaker_removed_not_escalated(nr):
    """A dynamic server that crash-loops trips the breaker and is removed
    for good, with no escalation; the executor replaces it within the
    plan's bounds. A stateless worker that is not expendable still
    escalates."""
    from areal_tpu_torch.system.supervisor import (
        RestartPolicy,
        Supervisor,
        SupervisorEscalation,
        WorkerSpec,
    )

    t = [0.0]
    sup = Supervisor(EXP, TRIAL, policy=RestartPolicy(
        max_restarts=2, window_secs=100.0, backoff_base_secs=0.1,
        backoff_max_secs=0.1), clock=lambda: t[0])
    sup._make_proc = lambda spec, incarnation: _FakeProc()
    sup.spawn(WorkerSpec(name="genserver_dyn1", kind="gen_server",
                         target=lambda: None, required=False,
                         expendable=True))
    entry = sup._entries["genserver_dyn1"]
    assert sup.alive_count("gen_server") == 1
    for _ in range(2):  # crash, respawn (twice)
        entry.proc.die(1)
        sup.check()
        t[0] += 0.2
        sup.check()
        assert entry.proc.is_alive()
    entry.proc.die(1)
    sup.check()  # the breaker trips: no SupervisorEscalation
    assert entry.done
    assert sup.alive_count("gen_server") == 0
    assert sup.restart_counts.get("gen_server") == 2
    publish_plan(EXP, TRIAL, {"target": 2, "dynamic": 1, "ts": 1.0})
    spawned = []
    ex = AutoscaleExecutor(EXP, TRIAL, sup, spawned.append,
                           clock=lambda: t[0])
    ex.step()
    assert spawned == ["dyn1"]  # the executor's own sequence of ids
    sup2 = Supervisor(EXP, TRIAL, policy=RestartPolicy(
        max_restarts=1, window_secs=100.0, backoff_base_secs=0.1),
        clock=lambda: t[0])
    sup2._make_proc = lambda spec, incarnation: _FakeProc()
    sup2.spawn(WorkerSpec(name="rollout0", kind="rollout",
                          target=lambda: None))
    e2 = sup2._entries["rollout0"]
    e2.proc.die(1)
    sup2.check()
    t[0] += 0.2
    sup2.check()
    e2.proc.die(1)
    with pytest.raises(SupervisorEscalation):
        sup2.check()


# ---------------- parity with the reference ----------------


def _ref_mod():
    from areal_tpu.api.train_config import AutoscaleConfig as JCfg
    from areal_tpu.system import autoscaler as jas

    return JCfg, jas


def _signal_script(seed, n=240):
    """Phases of 15 intervals: hot, idle or mixed signals."""
    rng = random.Random(seed)
    out, t = [], 0.0
    for i in range(n):
        if i % 15 == 0:
            phase = rng.choice(["hot", "idle", "mixed"])
        t += rng.choice([1.0, 3.0, 12.0, 40.0])
        idle = phase == "idle" or (phase == "mixed" and rng.random() < 0.5)
        out.append((t, dict(
            current_size=rng.randint(0, 5), cordoned=rng.randint(0, 2),
            utilization=(rng.random() * 0.25 if idle
                         else rng.choice([0.5, 0.9, 1.0, rng.random()])),
            queue_depth=(rng.random() if idle
                         else rng.choice([0.5, 2.0, 9.0, rng.random() * 12])),
            staled=rng.random() < 0.15,
            slo_miss_frac=0.0 if idle else rng.random(),
            fanout_ack_secs=rng.random() * (5 if idle else 20),
            stale_heartbeats=rng.choice([0, 0, 0, 1, 2]),
            inhibited=rng.random() < 0.1)))
    return out


@pytest.mark.parametrize("seed,knobs", [
    (0, {}),
    (1, {"up_consecutive": 1, "down_consecutive": 1,
         "scale_up_cooldown_secs": 0.0, "scale_down_cooldown_secs": 5.0}),
    (2, {"min_servers": 1, "max_servers": 3, "slo_ttfc_secs": 1.0,
         "fanout_ack_high_secs": 10.0, "queue_high": 4.0}),
])
def test_core_plans_match_reference(seed, knobs):
    JCfg, jas = _ref_mod()
    clocks = {"port": [0.0], "ref": [0.0]}
    cores = {
        "port": AutoscalerCore(AutoscaleConfig(enabled=True, **knobs),
                               clock=lambda: clocks["port"][0]),
        "ref": jas.AutoscalerCore(JCfg(enabled=True, **knobs),
                                  clock=lambda: clocks["ref"][0])}
    signals = {"port": FleetSignals, "ref": jas.FleetSignals}
    got = {}
    for pkg, core in cores.items():
        out = []
        for t, sig in _signal_script(seed):
            clocks[pkg][0] = t
            out.append((core.observe(signals[pkg](**sig)), core.target,
                        core.overloaded))
        got[pkg] = out
    assert got["port"] == got["ref"]
    actions = {a["action"] for a, _, _ in got["ref"] if a}
    assert actions == {"up", "down"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_sweeps_match_reference(seed):
    _, jas = _ref_mod()
    rng = random.Random(seed)
    kw = dict(factor=2.5, min_probes=3, slow_sweeps=2, cordon_sweeps=5,
              floor_secs=0.002, alpha=0.3)
    trs = {"port": StragglerTracker(**kw), "ref": jas.StragglerTracker(**kw)}
    urls = ["a", "b", "c", "d"]
    script = []
    for _ in range(60):
        script.append([(u, rng.choice([0.001, 0.01, 0.012, 0.05, 0.2])
                        * (4.0 if u == "d" and rng.random() < 0.7 else 1.0))
                       for u in urls if rng.random() < 0.9])
        if rng.random() < 0.05:
            script[-1].append(("forget", rng.choice(urls)))
    got = {}
    for pkg, tr in trs.items():
        out = []
        for probes in script:
            for u, v in probes:
                if u == "forget":
                    tr.forget(v)
                else:
                    tr.observe(u, v)
            out.append((tr.sweep(urls), [tr.ewma(u) for u in urls]))
        got[pkg] = out
    assert got["port"] == got["ref"]
    verdicts = {v for sweep, _ in got["ref"] for v in sweep.values()}
    assert {"ok", "slow", "cordon"} <= verdicts


def _post(url, body=None, timeout=WAIT):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


FAKE = ["http://127.0.0.1:9", "http://127.0.0.1:11"]


@pytest.fixture()
def managers(tmp_path):
    """The reference's manager (its aiohttp app on a loop of its own) and
    the port's, same config and fleet, autoscale on with a one-hour
    interval: only their first tick runs before the script."""
    from areal_tpu.base import name_resolve as jnr
    from areal_tpu.base import names as jnames
    from areal_tpu.system.gserver_manager import (
        GserverManager as JMgr,
        GserverManagerConfig as JMgrCfg,
    )
    from test_torch_async_rollout import RefLoop

    JCfg, jas = _ref_mod()
    old = (tnr.DEFAULT_REPO, jnr.DEFAULT_REPO)
    tnr.DEFAULT_REPO = tnr.NfsNameRecordRepo(str(tmp_path / "nr_port"))
    jnr.DEFAULT_REPO = jnr.NfsNameRecordRepo(str(tmp_path / "nr_ref"))
    asc = dict(enabled=True, min_servers=1, max_servers=2, up_consecutive=1,
               scale_up_cooldown_secs=0.0, interval_secs=3600.0,
               backpressure_retry_secs=1.5, straggler_defense=False)
    kw = dict(experiment=EXP, trial=TRIAL, n_servers=len(FAKE),
              health_check_interval_secs=3600.0, max_concurrent_rollouts=3,
              train_batch_size=1000)
    for i, u in enumerate(FAKE):
        jnr.add(jnames.gen_servers(EXP, TRIAL, f"gen{i}"), u, replace=True)
        tnr.add(tnames.gen_servers(EXP, TRIAL, f"gen{i}"), u, replace=True)
    loop = RefLoop()
    ref = JMgr(JMgrCfg(autoscale=JCfg(**asc), **kw))
    port = GserverManager(GserverManagerConfig(
        autoscale=AutoscaleConfig(**asc), **kw))
    urls = {"ref": loop.run(ref.start()), "port": port.start()}
    mgrs = {"ref": ref, "port": port}
    plans = {"ref": lambda: jas.read_plan(EXP, TRIAL),
             "port": lambda: read_plan(EXP, TRIAL)}
    try:
        deadline = time.monotonic() + WAIT
        while not (plans["ref"]() and plans["port"]()):  # the first ticks
            assert time.monotonic() < deadline
            time.sleep(0.02)
        yield urls, mgrs, loop
    finally:
        port.stop()
        loop.run(ref.stop())
        loop.close()
        tnr.DEFAULT_REPO, jnr.DEFAULT_REPO = old


def _cordon_script(url, mgr, tick):
    out = []

    def call(path, body=None):
        out.append((path, _post(f"{url}{path}", body)))
        return out[-1][1]

    for i, u in enumerate(FAKE):  # as its /health probes would report
        mgr.health[u].server_id = f"gen{i}"
    call("/schedule_request", {})
    call("/schedule_request", {})
    call("/cordon", {"url": FAKE[0], "reason": "preemption notice"})
    call("/cordon", {"server_id": "gen0"})  # already cordoned
    call("/cordon", {"url": "http://nowhere:1"})  # unknown: 404
    call("/cordon", {})
    for _ in range(3):
        call("/schedule_request", {})  # the other server only
    call("/release", {"lease_id": "l1"})
    fleet = _post(f"{url}/metrics.json")[1]  # (its probe fields differ)
    out.append(("fleet", fleet["autoscale"], {
        u: {k: st[k] for k in ("cordoned", "cordon_reason", "draining",
                               "routable", "server_id")}
        for u, st in fleet["fleet"].items()}))
    call("/uncordon", {"server_id": "gen0"})
    call("/uncordon", {"url": FAKE[0]})  # not cordoned any more
    call("/uncordon", {"server_id": "gen9"})
    # capacity: three samples fill it; the denial has no hint until a tick
    # pins the fleet at max_servers under saturation
    for _ in range(4):
        call("/allocate_rollout", {"n_samples": 1})
    tick()
    call("/allocate_rollout", {"n_samples": 1})
    call("/finish_rollout", {"accepted": True, "n_samples": 3,
                             "n_accepted": 3})
    tick()
    call("/allocate_rollout", {"n_samples": 3})
    call("/allocate_rollout", {"n_samples": 1})
    out.append(("overloaded", mgr._overloaded, mgr.autoscaler.target))
    return out


def test_cordon_and_capacity_replies_match_reference(managers):
    urls, mgrs, loop = managers
    ticks = {"port": mgrs["port"]._autoscale_tick,
             "ref": lambda: loop.run(_ref_tick(mgrs["ref"]))}
    got = {pkg: _cordon_script(urls[pkg], mgrs[pkg], ticks[pkg])
           for pkg in ("ref", "port")}
    assert got["port"] == got["ref"]
    statuses = [r[0] for p, r in got["ref"][:6]]
    assert statuses == [200, 200, 200, 200, 404, 404]
    hints = [rec[1][1].get("retry_after") for rec in got["ref"]
             if rec[0] == "/allocate_rollout"]
    assert 1.5 in hints and None in hints


async def _ref_tick(mgr):
    mgr._autoscale_tick()  # on the reference's own loop: no race with it


def test_autoscale_config_defaults_and_checks_match_reference():
    import dataclasses

    from areal_tpu.api import cli_args as jca
    from areal_tpu_torch.api import cli_args as tca

    JCfg, _ = _ref_mod()
    assert dataclasses.asdict(AutoscaleConfig()) == dataclasses.asdict(JCfg())
    bad = [{"min_servers": 0}, {"min_servers": 3, "max_servers": 2},
           {"interval_secs": 0.0},
           {"down_utilization": 0.9, "up_utilization": 0.8},
           {"straggler_factor": 1.0}]
    for kw in bad:
        cfg = tca.BaseExperimentConfig(backend="cpu")
        cfg.autoscale = AutoscaleConfig(enabled=True, **kw)
        with pytest.raises(tca.ConfigError, match="autoscale"):
            tca.validate_config(cfg)
        ref = jca.BaseExperimentConfig()
        ref.autoscale = JCfg(enabled=True, **kw)
        with pytest.raises(jca.ConfigError, match="autoscale"):
            jca.validate_config(ref)
    cfg = tca.BaseExperimentConfig(backend="cpu")
    tca.apply_overrides(cfg, ["autoscale.enabled=true",
                              "autoscale.max_servers=2"])
    tca.validate_config(cfg)
