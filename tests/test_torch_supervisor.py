"""The port's launcher-level supervision against the reference's.

Twins of ``tests/test_fault_tolerance.py:793-1558`` below the whole-loop
runs (those are tests/test_torch_supervised_loop.py's): the supervisor's
backoff and circuit breaker, failure domains and unexpected clean exits,
ghost keys, a real SIGKILL respawn and a real crash loop, the drain
sequence, shutdown markers, keepalive leases and their re-registration,
heartbeats and incarnations, the crash-safe consumed log,
``run_experiment``'s relaunch backoff and trial-subtree clear, and the
manager's quota reclaim (the recover twin and the operator commands spawn
the package and are tests/test_torch_supervised_loop.py's). The state
machines run both packages' ``Supervisor`` on one fake clock and fake
processes, and their states must agree step by step; real children are
standard-library functions (``time.sleep``, ``sys.exit``), so a spawn
costs no package import. Every wait is bounded and every child joined.
"""

import json
import os
import signal
import sys
import threading
import time
import types

import pytest

from areal_tpu.base import name_resolve as jnr
from areal_tpu.base import names as jnames
from areal_tpu.system import supervisor as jsup
from areal_tpu.system import worker_base as jwb
from areal_tpu_torch.base import name_resolve as tnr
from areal_tpu_torch.base import names as tnames
from areal_tpu_torch.system import supervisor as tsup
from areal_tpu_torch.system import worker_base as twb

pytestmark = pytest.mark.chaos

PKGS = {"ref": (jsup, jnr, jnames, jwb), "port": (tsup, tnr, tnames, twb)}


@pytest.fixture(autouse=True)
def repos(tmp_path):
    old = jnr.DEFAULT_REPO, tnr.DEFAULT_REPO
    jnr.DEFAULT_REPO = jnr.NfsNameRecordRepo(str(tmp_path / "jnr"))
    tnr.DEFAULT_REPO = tnr.NfsNameRecordRepo(str(tmp_path / "tnr"))
    yield
    jnr.DEFAULT_REPO, tnr.DEFAULT_REPO = old


class FakeProc:
    """A process stand-in for the state-machine tests (no spawn, no
    sleep)."""

    _next_pid = [1000]

    def __init__(self):
        FakeProc._next_pid[0] += 1
        self.pid = FakeProc._next_pid[0]
        self._alive = True
        self.exitcode = None
        self.name = f"fake{self.pid}"

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


def fake_sup(pkg, clock, exp="supfake", **policy_kw):
    mod = PKGS[pkg][0]
    sup = mod.Supervisor(exp, "t0", policy=mod.RestartPolicy(**policy_kw),
                         clock=clock)
    sup._make_proc = lambda spec, incarnation: FakeProc()
    return sup


def spec(pkg, name, kind, **kw):
    return PKGS[pkg][0].WorkerSpec(name=name, kind=kind, target=time.sleep,
                                   args=(3600,), **kw)


def state(sup, name):
    e = sup._entries[name]
    return (e.incarnation, e.respawn_due, e.done, e.proc.is_alive(),
            len(e.restarts), dict(sup.restart_counts))


def test_supervisor_backoff_and_circuit_breaker():
    """A stateless worker's deaths schedule respawns with exponential
    backoff; max_restarts inside the window opens the breaker; restarts
    outside the window are pruned. Both packages step by step."""
    for pkg in PKGS:
        esc = PKGS[pkg][0].SupervisorEscalation
        t = [0.0]
        sup = fake_sup(pkg, lambda: t[0], max_restarts=2, window_secs=100.0,
                       backoff_base_secs=1.0, backoff_max_secs=8.0,
                       backoff_multiplier=2.0)
        sup.spawn(spec(pkg, "rollout0", "rollout"))
        e = sup._entries["rollout0"]
        p1 = e.proc
        trace = []
        p1.die(-9)
        sup.check()
        trace.append(state(sup, "rollout0"))
        t[0] = 0.5
        sup.check()
        assert e.proc is p1
        t[0] = 1.0
        sup.check()
        assert e.proc is not p1 and e.proc.is_alive()
        trace.append(state(sup, "rollout0"))
        e.proc.die(1)
        sup.check()
        trace.append(state(sup, "rollout0"))
        t[0] = 3.0
        sup.check()
        trace.append(state(sup, "rollout0"))
        e.proc.die(1)
        with pytest.raises(esc, match="crash-loop"):
            sup.check()
        trace.append(state(sup, "rollout0"))
        assert trace == [
            (1, 1.0, False, False, 1, {}),
            (2, None, False, True, 1, {"rollout": 1}),
            (2, 3.0, False, False, 2, {"rollout": 1}),
            (3, None, False, True, 2, {"rollout": 2}),
            (3, None, True, False, 2, {"rollout": 2}),
        ], pkg
        # outside the window the history is pruned
        sup2 = fake_sup(pkg, lambda: t[0], max_restarts=1, window_secs=10.0,
                        backoff_base_secs=0.5, backoff_max_secs=8.0)
        sup2.spawn(spec(pkg, "gen_fleet", "gen_fleet"))
        e2 = sup2._entries["gen_fleet"]
        t[0] = 0.0
        e2.proc.die(-9)
        sup2.check()
        t[0] = 0.5
        sup2.check()
        assert sup2.restart_counts == {"gen_fleet": 1}
        t[0] = 50.0
        e2.proc.die(-9)
        sup2.check()
        t[0] = 50.5
        sup2.check()
        assert sup2.restart_counts == {"gen_fleet": 2}


def test_supervisor_failure_domains_and_clean_exit():
    """The trainer's death escalates (a clean unrequested exit too); a
    required stateless worker's clean exit respawns; an optional worker's
    clean exit is ignored; a drain suppresses everything."""
    for pkg in PKGS:
        esc = PKGS[pkg][0].SupervisorEscalation
        t = [0.0]
        sup = fake_sup(pkg, lambda: t[0], backoff_base_secs=0.1)
        sup.spawn(spec(pkg, "trainer", "trainer"))
        sup._entries["trainer"].proc.die(0)
        with pytest.raises(esc, match="stateful"):
            sup.check()
        sup = fake_sup(pkg, lambda: t[0], backoff_base_secs=0.1)
        sup.spawn(spec(pkg, "rollout0", "rollout"))
        sup._entries["rollout0"].proc.die(0)
        sup.check()
        assert sup._entries["rollout0"].respawn_due == pytest.approx(0.1)
        sup = fake_sup(pkg, lambda: t[0], backoff_base_secs=0.1)
        sup.spawn(spec(pkg, "aux", "rollout", required=False))
        sup._entries["aux"].proc.die(0)
        sup.check()
        assert sup._entries["aux"].respawn_due is None
        assert sup.restart_counts == {}
        sup = fake_sup(pkg, lambda: t[0], backoff_base_secs=0.1)
        sup.spawn(spec(pkg, "trainer", "trainer"))
        sup.begin_drain()
        sup._entries["trainer"].proc.die(-15)
        sup.check()  # expected during a drain
        assert sup._entries["trainer"].done


def test_reward_workers_are_a_restartable_domain():
    """The launchers restart reward workers in place: the reference passes
    ("rollout", "gen_fleet", "reward") to its supervisor, the port's
    default is that set; supervise=false escalates any death."""
    for pkg in PKGS:
        mod = PKGS[pkg][0]
        t = [0.0]
        sup = mod.Supervisor("supfake", "t0", restartable_kinds=(
            "rollout", "gen_fleet", "reward"), clock=lambda: t[0],
            policy=mod.RestartPolicy(backoff_base_secs=0.5))
        sup._make_proc = lambda spec_, inc: FakeProc()
        sup.spawn(spec(pkg, "reward0", "reward"))
        sup._entries["reward0"].proc.die(-9)
        sup.check()
        t[0] = 0.5
        sup.check()
        assert sup.restart_counts == {"reward": 1}
        sup = mod.Supervisor("supfake", "t0", restartable_kinds=(),
                             clock=lambda: t[0])
        sup._make_proc = lambda spec_, inc: FakeProc()
        sup.spawn(spec(pkg, "rollout0", "rollout"))
        sup._entries["rollout0"].proc.die(-9)
        with pytest.raises(mod.SupervisorEscalation):
            sup.check()
    assert set(tsup.STATELESS_KINDS) == {"rollout", "gen_fleet", "reward",
                                         "gen_server"}


def _ghost_keys(pkg, exp, trial):
    _, nr, nm, wb = PKGS[pkg]
    keys = {
        "manager": nm.gen_server_manager(exp, trial),
        "server": nm.gen_servers(exp, trial, "gen0"),
        "hb_manager": nm.worker_heartbeat(exp, trial, "gserver_manager"),
        "hb_server": nm.worker_heartbeat(exp, trial, "genserver_gen0"),
        "ctrl_fleet": wb.worker_control_key(exp, trial, "gen_fleet"),
        "hb_rollout": nm.worker_heartbeat(exp, trial, "rollout0"),
        "ctrl_reward": wb.worker_control_key(exp, trial, "reward0"),
        "hb_reward": nm.worker_heartbeat(exp, trial, "reward0"),
        "url_reward": nm.reward_worker(exp, trial, "rw0"),
    }
    for k in keys.values():
        nr.add(k, "x", replace=True)
    return keys


def _alive(nr, keys):
    out = set()
    for name, k in keys.items():
        try:
            nr.get(k)
            out.add(name)
        except nr.NameEntryNotFoundError:
            pass
    return out


def test_supervisor_clears_ghost_keys_on_respawn():
    """A fleet respawn clears the dead incarnation's discovery keys (the
    manager, the servers, their heartbeats, the control key) before the
    new process binds fresh ones; other workers' keys survive. A reward
    worker's respawn clears its control and heartbeat keys in both; the
    port also drops its discovery URL (the reference leaves it to lapse
    with its lease)."""
    exp, trial = "supfake", "t0"
    left = {}
    for pkg in PKGS:
        nr = PKGS[pkg][1]
        keys = _ghost_keys(pkg, exp, trial)
        t = [0.0]
        sup = fake_sup(pkg, lambda: t[0], backoff_base_secs=0.1)
        sup.restartable_kinds = ("rollout", "gen_fleet", "reward")
        sup.spawn(spec(pkg, "gen_fleet", "gen_fleet"))
        sup.spawn(spec(pkg, "reward0", "reward"))
        sup._entries["gen_fleet"].proc.die(-9)
        sup._entries["reward0"].proc.die(-9)
        sup.check()
        assert _alive(nr, keys) == set(keys)  # nothing before the respawn
        t[0] = 1.0
        sup.check()
        left[pkg] = _alive(nr, keys)
    assert left["ref"] == {"hb_rollout", "url_reward"}
    assert left["port"] == {"hb_rollout"}


def test_supervisor_respawns_sigkilled_process():
    """Real processes: SIGKILL a supervised child; the next sweeps see the
    death, back off and respawn incarnation 2."""
    for pkg in PKGS:
        mod = PKGS[pkg][0]
        sup = mod.Supervisor(f"supreal{pkg}", "t0", policy=mod.RestartPolicy(
            max_restarts=3, window_secs=60.0, backoff_base_secs=0.05,
            backoff_max_secs=0.2))
        try:
            sup.spawn(spec(pkg, "rollout0", "rollout"))
            e = sup._entries["rollout0"]
            pid1 = e.proc.pid
            os.kill(pid1, signal.SIGKILL)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                sup.check()
                if e.proc.pid != pid1 and e.proc.is_alive():
                    break
                time.sleep(0.02)
            assert e.proc.pid != pid1 and e.proc.is_alive()
            assert sup.restart_counts == {"rollout": 1}
            assert e.incarnation == 2
        finally:
            sup.shutdown(timeout=5.0, orderly=False)
        assert not any(p.is_alive() for p in sup.procs())


def test_supervisor_escalates_real_crash_loop():
    """A child exiting 3 on every start trips the breaker after
    max_restarts respawns."""
    for pkg in PKGS:
        mod = PKGS[pkg][0]
        sup = mod.Supervisor(f"supreal2{pkg}", "t0", policy=mod.RestartPolicy(
            max_restarts=1, window_secs=60.0, backoff_base_secs=0.02,
            backoff_max_secs=0.05))
        sup.spawn(mod.WorkerSpec(name="rollout0", kind="rollout",
                                 target=sys.exit, args=(3,)))
        deadline = time.monotonic() + 60
        try:
            with pytest.raises(mod.SupervisorEscalation, match="crash-loop"):
                while time.monotonic() < deadline:
                    sup.check()
                    time.sleep(0.02)
                pytest.fail("the circuit breaker never opened")
            assert sup.restart_counts == {"rollout": 1}
            assert sup._entries["rollout0"].proc.exitcode == 3
        finally:
            sup.shutdown(timeout=5.0, orderly=False)


def test_spawned_child_sees_its_incarnation_ttl_and_env(tmp_path):
    """The spawn snapshot carries the incarnation, the keepalive TTL and a
    spec's env (a reward worker's CUDA_VISIBLE_DEVICES=""); this process's
    environment is left as it was."""
    sup = tsup.Supervisor("supenv", "t0", keepalive_ttl=7.5)
    out = str(tmp_path / "env.json")
    code = ("import json, os, sys; json.dump({k: os.environ.get(k) for k in "
            "sys.argv[2:]}, open(sys.argv[1], 'w'))")
    keys = [twb.ENV_INCARNATION, twb.ENV_KEEPALIVE_TTL,
            "CUDA_VISIBLE_DEVICES"]
    before = {k: os.environ.get(k) for k in keys}
    sup.spawn(tsup.WorkerSpec(
        name="reward0", kind="reward", target=os.system,
        args=(" ".join([sys.executable, "-c", repr(code), out, *keys]),),
        required=False, env={"CUDA_VISIBLE_DEVICES": ""}))
    try:
        sup._entries["reward0"].proc.join(60)
        with open(out) as f:
            seen = json.load(f)
        assert seen == {twb.ENV_INCARNATION: "1",
                        twb.ENV_KEEPALIVE_TTL: "7.5",
                        "CUDA_VISIBLE_DEVICES": ""}
        assert {k: os.environ.get(k) for k in keys} == before
    finally:
        sup.shutdown(timeout=5.0, orderly=False)


def _fake_ctrl_worker(wb, exp, trial, name, events, stop_evt, commands=None):
    """An in-process worker serving a WorkerControl loop, recording its
    lifecycle."""
    ctrl = wb.WorkerControl(exp, trial, name)
    for cmd, result in (commands or {}).items():
        ctrl.on_command(
            cmd, lambda payload, c=cmd, r=result: events.append((name, c))
            or r)
    last = None
    while not stop_evt.is_set():
        ctrl.step()
        if ctrl.state != last:
            events.append((name, ctrl.state.value))
            last = ctrl.state
        if ctrl.should_exit:
            break
        time.sleep(0.005)
    ctrl.close()


def test_graceful_drain_sequence():
    """drain_experiment against in-process fakes: the master paused first,
    the rollouts paused, an out-of-band checkpoint while the master is
    paused, then the exits in order; both packages report alike."""
    reports = {}
    for pkg in PKGS:
        mod, nr, nm, wb = PKGS[pkg]
        exp, trial = f"drainfake{pkg}", "t0"
        events, stop = [], threading.Event()
        ck = {"saved": True, "dir": "/ck", "step": 3}
        threads = [threading.Thread(
            target=_fake_ctrl_worker, daemon=True,
            args=(wb, exp, trial, w, events, stop),
            kwargs={"commands": {"checkpoint": ck} if w == "master"
                    else None})
            for w in ("master", "rollout0")]
        for t in threads:
            t.start()
        try:
            panel = wb.WorkerControlPanel(exp, trial, timeout=2.0)
            deadline = time.monotonic() + 10
            while set(panel.list_workers()) != {"master", "rollout0"}:
                assert time.monotonic() < deadline
                time.sleep(0.02)
            panel.close()
            report = mod.drain_experiment(exp, trial, timeout=20.0)
            for t in threads:
                t.join(10)
                assert not t.is_alive()
            mevents = [e[1] for e in events if e[0] == "master"]
            assert mevents.index("checkpoint") < mevents.index("exiting")
            assert json.loads(nr.get(nm.drain_status(exp, trial)))[
                "phase"] == "done"
            reports[pkg] = (
                {w: r["state"] for w, r in report["paused"].items()},
                report["checkpoint"]["ok"], report["checkpoint"]["result"],
                sorted(report["exited"]))
        finally:
            stop.set()
    assert reports["port"] == reports["ref"] == (
        {"master": "paused", "rollout0": "paused"}, True,
        {"saved": True, "dir": "/ck", "step": 3}, ["master", "rollout0"])


def test_name_resolve_keepalive_lease_expiry_and_touch(tmp_path):
    """Both repositories of both packages: a leased key expires unless
    touched; touch extends it; an expired slot re-registers without
    replace; a re-registration without a lease sheds the old TTL. The
    lease is 0.6 s and the touches 0.1 s apart, so load cannot lapse it."""
    repos = [(jnr.MemoryNameRecordRepo(), jnr), (jnr.DEFAULT_REPO, jnr),
             (tnr.MemoryNameRecordRepo(), tnr), (tnr.DEFAULT_REPO, tnr)]
    for repo, nf in repos:
        repo.add("lease/a", "v1", keepalive_ttl=0.6, replace=True)
        repo.add("lease/b", "v2", replace=True)
        for _ in range(8):
            time.sleep(0.1)
            repo.touch("lease/a")
        assert repo.get("lease/a") == "v1"
        time.sleep(1.0)
        with pytest.raises(nf.NameEntryNotFoundError):
            repo.get("lease/a")
        with pytest.raises(nf.NameEntryNotFoundError):
            repo.touch("lease/a")
        assert repo.find_subtree("lease") == ["lease/b"]
        repo.add("lease/a", "v3", keepalive_ttl=0.6)
        repo.add("lease/a", "v4", replace=True)
        time.sleep(1.0)
        assert repo.get("lease/a") == "v4"
        repo.delete("lease/a")
        repo.delete("lease/b")


def test_worker_control_heartbeat_and_incarnation(monkeypatch):
    """A supervised worker (env TTL and incarnation) keeps its control key
    leased from its heartbeat thread, publishes a heartbeat the panel can
    age, reports its incarnation; close() withdraws both keys."""
    monkeypatch.setenv(twb.ENV_INCARNATION, "3")
    monkeypatch.setenv(twb.ENV_KEEPALIVE_TTL, "0.6")
    for pkg in PKGS:
        wb = PKGS[pkg][3]
        exp = f"hbexp{pkg}"
        stop = threading.Event()

        def worker():
            ctrl = wb.WorkerControl(exp, "t0", "w0")
            while not stop.is_set():
                ctrl.step()
                if ctrl.should_exit:
                    break
                time.sleep(0.01)
            ctrl.close()

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        panel = wb.WorkerControlPanel(exp, "t0", timeout=5.0)
        try:
            assert panel.status("w0")["incarnation"] == 3
            hbs = panel.heartbeats()
            assert hbs["w0"]["incarnation"] == 3
            assert hbs["w0"]["age_secs"] < 5.0
            time.sleep(1.2)  # twice the TTL: the heartbeat kept it
            assert panel.list_workers() == ["w0"]
            panel.exit("w0")
            t.join(5)
            assert not t.is_alive()
            assert panel.list_workers() == []
            assert panel.heartbeats() == {}
        finally:
            stop.set()
            panel.close()


def test_heartbeat_publishes_compile_inflight_while_a_build_runs():
    """The heartbeat rewrites names.compile_inflight while its
    ``inflight_fn`` reports a build and deletes it the beat after, in both
    packages; without an ``inflight_fn`` it writes nothing."""
    for pkg in PKGS:
        _, nr, nm, wb = PKGS[pkg]
        flag = threading.Event()
        key = nm.compile_inflight("hbc", "t0", "w0")

        def present():
            try:
                json.loads(nr.get(key))["ts"]
                return True
            except nr.NameEntryNotFoundError:
                return False

        hb = wb.HeartbeatThread("hbc", "t0", "w0", interval=0.05,
                                inflight_fn=flag.is_set)
        try:
            assert not present()
            flag.set()
            deadline = time.monotonic() + 10
            while not present():
                assert time.monotonic() < deadline
                time.sleep(0.02)
            flag.clear()
            while present():
                assert time.monotonic() < deadline
                time.sleep(0.02)
            flag.set()
            while not present():
                assert time.monotonic() < deadline
                time.sleep(0.02)
        finally:
            hb.close()
        assert not present()  # close() withdrew it
        quiet = wb.HeartbeatThread("hbc", "t0", "w1", interval=0.05)
        time.sleep(0.2)
        quiet.close()
        with pytest.raises(nr.NameEntryNotFoundError):
            nr.get(nm.compile_inflight("hbc", "t0", "w1"))


def test_consumed_log_fsync_and_torn_tail(tmp_path):
    """Every append is on disk before add() returns, and a torn tail is
    dropped and truncated away; both packages read one file alike."""
    from areal_tpu.system.rollout_worker import ConsumedLog as J
    from areal_tpu_torch.system.rollout_worker import ConsumedLog as T

    log = T(str(tmp_path), worker_index=0)
    log.add("q1")
    log.add("q2")
    with open(log.path) as f:
        assert f.read() == "q1\nq2\n"
    with open(log.path, "a") as f:
        f.write("q3@r")
    assert J(str(tmp_path / "x"), 0).seen == set()
    log2 = T(str(tmp_path), worker_index=0)
    assert log2.seen == {"q1", "q2"}
    log2.add("q4")
    assert T(str(tmp_path), 0).seen == J(str(tmp_path), 0).seen \
        == {"q1", "q2", "q4"}
    log.close()
    log2.close()


def test_run_experiment_relaunch_backoff_and_subtree_clear(monkeypatch):
    """The recover_mode=auto loop backs off between launches, clears the
    dead launch's name-resolve subtree and relaunches with resume; the
    backoff is capped and exponential; recover_mode=resume never
    relaunches."""
    from areal_tpu_torch.apps import launcher as L

    cfg = types.SimpleNamespace(
        experiment_name="rx", trial_name="t0", mode="local",
        recover_mode="auto", recover_retries=3, serving=None,
        fault_tolerance=types.SimpleNamespace(
            relaunch_backoff_secs=0.2, relaunch_backoff_max_secs=0.5))
    key = f"{tnames.trial_root('rx', 't0')}/stream/trainer"
    calls, sleeps, probes_seen = {"n": 0}, [], []

    class FakeLauncher:
        def __init__(self, exp_cfg, probes=None):
            probes_seen.append(probes)

        def run(self):
            calls["n"] += 1
            if calls["n"] == 1:
                tnr.add(key, "tcp://dead:1", replace=True)
                raise RuntimeError("worker died")
            with pytest.raises(tnr.NameEntryNotFoundError):
                tnr.get(key)
            assert cfg.recover_mode == "resume"
            if calls["n"] < 4:
                tnr.add(key, "tcp://dead:2", replace=True)
                raise tsup.SupervisorEscalation("trainer died")
            return {"steps": 7}

    monkeypatch.setattr(L, "LocalLauncher", FakeLauncher)
    monkeypatch.setattr(L.time, "sleep", lambda s: sleeps.append(s))
    probes = {"trainer": print}
    assert L.run_experiment(cfg, probes=probes) == {"steps": 7}
    assert calls["n"] == 4
    assert sleeps == [pytest.approx(0.2), pytest.approx(0.4),
                      pytest.approx(0.5)]
    assert probes_seen == [probes] * 4
    # retries spent: the last failure propagates
    calls["n"], cfg.recover_mode, cfg.recover_retries = 0, "auto", 1
    with pytest.raises(tsup.SupervisorEscalation):
        L.run_experiment(cfg)
    # resume and disabled never relaunch
    for mode in ("resume", "disabled"):
        calls["n"], cfg.recover_mode = 0, mode
        with pytest.raises(RuntimeError, match="worker died"):
            L.run_experiment(cfg)
        assert calls["n"] == 1


def test_supervisor_honors_shutdown_markers():
    """A commanded teardown (the master's end-of-run marker, or a drain's
    phase record) makes later deaths expected; a marker older than the
    supervisor (an earlier launch's) does not."""
    for pkg in PKGS:
        mod, nr, nm, _ = PKGS[pkg]
        t = [0.0]
        for key in (nm.experiment_status("supfake", "t0"),
                    nm.drain_status("supfake", "t0")):
            sup = fake_sup(pkg, lambda: t[0], backoff_base_secs=0.1)
            sup.spawn(spec(pkg, "trainer", "trainer"))
            nr.add(key, json.dumps({"status": "finishing", "phase": "done",
                                    "ts": time.time() + 1}), replace=True)
            sup._entries["trainer"].proc.die(0)
            sup.check()
            assert sup._entries["trainer"].done and sup._draining
            nr.delete(key)
            sup2 = fake_sup(pkg, lambda: t[0], backoff_base_secs=0.1)
            nr.add(key, json.dumps({"status": "finishing",
                                    "ts": time.time() - 3600}),
                   replace=True)
            sup2.spawn(spec(pkg, "trainer", "trainer"))
            sup2._entries["trainer"].proc.die(0)
            with pytest.raises(mod.SupervisorEscalation):
                sup2.check()
            nr.delete(key)


def test_heartbeat_reregisters_lapsed_lease():
    """A lapsed lease whose value the heartbeat knows is re-registered by
    the next beat."""
    for pkg in PKGS:
        _, nr, _, wb = PKGS[pkg]
        hb = wb.HeartbeatThread("hbre", "t0", "w0", interval=0.05)
        try:
            nr.add("hbre/k", "addr", keepalive_ttl=5.0, replace=True)
            hb.lease("hbre/k", "addr", 5.0)
            nr.delete("hbre/k")  # an expiry purge
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                try:
                    if nr.get("hbre/k") == "addr":
                        break
                except nr.NameEntryNotFoundError:
                    pass
                time.sleep(0.02)
            assert nr.get("hbre/k") == "addr"
        finally:
            hb.close()


def test_respawned_rollout_worker_returns_its_predecessors_quota():
    """A SIGKILLed rollout worker sends no /finish_rollout; the first
    allocation of its next incarnation returns what it held, and a booking
    that names no worker (the reference's body) keeps the reference's
    accounting, reply for reply."""
    from areal_tpu.system.gserver_manager import GserverManager as J
    from areal_tpu.system.gserver_manager import GserverManagerConfig as JC
    from areal_tpu_torch.system.gserver_manager import GserverManager as T
    from areal_tpu_torch.system.gserver_manager import (
        GserverManagerConfig as TC,
    )

    kw = dict(experiment="quota", trial="t0", train_batch_size=16,
              max_head_offpolicyness=4, max_concurrent_rollouts=64)
    t, j = T(TC(**kw)), J(JC(**kw))
    plain = [("allocate_rollout", {"n_samples": 16})] * 5 + [
        ("finish_rollout", {"accepted": True, "n_samples": 16})] * 2 + [
        ("allocate_rollout", {"n_samples": 16})]
    import asyncio

    class Req:
        def __init__(self, d):
            self.d = d

        async def json(self):
            return self.d

    for route, body in plain:
        got = getattr(t, route)(dict(body))[1]
        ref = asyncio.run(getattr(j, "handle_" + route)(Req(dict(body))))
        assert got == json.loads(ref.text), (route, body)
    assert (t.running_rollouts, t.accepted_rollouts) \
        == (j.running_rollouts, j.accepted_rollouts) == (48, 32)
    t2 = T(TC(**kw))
    who1 = {"worker": "rollout0", "incarnation": 1}
    for _ in range(3):
        assert t2.allocate_rollout({"n_samples": 16, **who1})[1]["allowed"]
    t2.finish_rollout({"accepted": True, "n_samples": 16, **who1})
    assert t2.running_rollouts == 32  # two bookings die with incarnation 1
    who2 = {"worker": "rollout0", "incarnation": 2}
    assert t2.allocate_rollout({"n_samples": 16, **who2})[1]["allowed"]
    assert t2.running_rollouts == 16 and t2.reclaimed_samples == 32
    t2.finish_rollout({"accepted": True, "n_samples": 16, **who2})
    assert t2.running_rollouts == 0 and t2.accepted_rollouts == 32


_LATE_WORKER = """
import sys, time
sys.path.insert(0, sys.argv[1])
time.sleep(3.0)  # longer than the shutdown panel's 2 s lookup
from areal_tpu_torch.base import name_resolve
from areal_tpu_torch.system.worker_base import WorkerControl

name_resolve.DEFAULT_REPO = name_resolve.NfsNameRecordRepo(sys.argv[2])
ctrl = WorkerControl("suplate", "t0", "genserver_dyn9")
give_up = time.monotonic() + 60
while not ctrl.should_exit and time.monotonic() < give_up:
    ctrl.step()
    time.sleep(0.01)
ctrl.close()
with open(sys.argv[3], "w") as f:
    f.write("commanded" if ctrl.should_exit else "gave up")
"""


def test_shutdown_asks_a_late_starting_worker_again(tmp_path):
    """A dynamic server the autoscaler spawned just before the run ended
    registers its control endpoint only once its process is up; the
    shutdown asks it again until it answers, so it exits on the command
    (and a server's record is sent) instead of being terminated when the
    exit window runs out."""
    script = tmp_path / "late.py"
    script.write_text(_LATE_WORKER)
    marker = tmp_path / "exit"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sup = tsup.Supervisor("suplate", "t0")
    sup.spawn(tsup.WorkerSpec(
        name="genserver_dyn9", kind="gen_server", target=os.system,
        args=(" ".join([sys.executable, str(script), root,
                        tnr.DEFAULT_REPO._root, str(marker)]),),
        required=False, expendable=True))
    t0 = time.monotonic()
    try:
        sup.shutdown(timeout=10.0, exit_secs=30.0)
        took = time.monotonic() - t0
    finally:
        sup.shutdown(timeout=5.0, orderly=False)
    assert marker.read_text() == "commanded"
    assert took < 25.0  # ended on the command, not at the window's end
    assert not any(p.is_alive() for p in sup.procs())
