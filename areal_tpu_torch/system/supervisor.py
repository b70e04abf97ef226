"""Launcher-level worker supervision: restart policy, crash-loop breaker,
liveness accounting and the graceful drain.

The port of ``areal_tpu/system/supervisor.py`` (reference
``realhf/apps/main.py:118-180``, which relaunches the whole experiment on
any death). Here a death is classified by failure domain first:

 - **Stateless** (rollout workers, the generation-fleet process, reward
   workers): their durable state lives elsewhere (the consumed-prompt log
   on disk, the weights at the trainer, the quota with the manager). They
   are respawned in place with exponential backoff and rejoin through
   name_resolve (the manager re-admits a respawned server and reconciles
   its weights). More than ``RestartPolicy.max_restarts`` restarts inside
   the rolling window opens the circuit breaker and escalates.
 - **Stateful** (the trainer): optimizer state and the step counter live
   there, and a respawn cannot rejoin a running step. Its death raises
   :class:`SupervisorEscalation`, which ``run_experiment``'s
   ``recover_mode=auto`` loop turns into a relaunch from the last recover
   checkpoint.

An unexpected clean exit (code 0 of a required worker never asked to exit)
is a failure too. Liveness rests on name-resolve keepalive leases: every
child gets its incarnation and TTL through the environment
(``system/worker_base.py`` reads them), workers heartbeat their keys from a
thread of their own, and before a respawn the dead incarnation's keys are
cleared so that nothing addresses a corpse. Restarts, deaths, the breaker,
heartbeat ages and the drain phase are exported through the telemetry
registry (``supervisor_*`` on the merged scrape).

A dynamic generation server (kind ``gen_server``, spawned by the
autoscaler's executor) is stateless and also *expendable*: a crash loop
removes it from supervision instead of escalating, and the executor, which
counts live workers with :meth:`Supervisor.alive_count`, spawns a fresh one
within the plan's bounds. A decoupled allocation's servers (kind
``gen_replica``) and their manager (kind ``gen_manager``) run in processes
of their own and are stateless too.

A meshed generation server runs one process per rank (its ``fsdp × pp ×
tp`` ranks), and its ranks are one failure domain (``WorkerSpec.group``): when one dies, the others
are killed and all respawn together, with one restart counted against the
breaker; only the leader (``rank`` 0) counts as a live worker and takes a
commanded exit (its followers end with it).

Processes are spawned, never forked, so no child inherits a CUDA context.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing as mp
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

from areal_tpu_torch.base import logging, name_resolve, names, telemetry

logger = logging.getLogger("system.supervisor")

# The failure domains the launcher restarts in place ("gen_server": a
# dynamic single server of the autoscaler, expendable as well), and those
# of a decoupled fleet (its servers, one process per rank, and its
# manager), stateless too.
STATELESS_KINDS = ("rollout", "gen_fleet", "reward", "gen_server")
DECOUPLED_KINDS = ("gen_replica", "gen_manager")
RESTARTABLE_KINDS = STATELESS_KINDS + DECOUPLED_KINDS

# Workers with a control endpoint that shutdown asks to exit, in this
# order, before it terminates anything: a rollout worker returns its quota,
# a reward worker withdraws its URL, a generation server its
# registration.
_ORDERLY_KINDS = ("rollout", "reward", "gen_server", "gen_replica")


class SupervisorEscalation(RuntimeError):
    """A death the supervisor cannot absorb: a stateful worker died, or a
    stateless one crash-looped past the breaker. The launcher lets it
    propagate so that ``run_experiment``'s recover loop relaunches."""


@dataclasses.dataclass
class RestartPolicy:
    """Per-worker respawn policy of the stateless domain."""

    max_restarts: int = 3  # per rolling window, then escalate
    window_secs: float = 300.0
    backoff_base_secs: float = 0.5
    backoff_max_secs: float = 30.0
    backoff_multiplier: float = 2.0

    def backoff(self, n_recent_restarts: int) -> float:
        return min(self.backoff_base_secs
                   * self.backoff_multiplier ** max(n_recent_restarts - 1, 0),
                   self.backoff_max_secs)

    @classmethod
    def from_config(cls, ft) -> "RestartPolicy":
        """From a FaultToleranceConfig-shaped object (getattr: plain test
        configs work too)."""
        return cls(
            max_restarts=getattr(ft, "max_restarts", 3),
            window_secs=getattr(ft, "restart_window_secs", 300.0),
            backoff_base_secs=getattr(ft, "backoff_base_secs", 0.5),
            backoff_max_secs=getattr(ft, "backoff_max_secs", 30.0),
            backoff_multiplier=getattr(ft, "backoff_multiplier", 2.0))


@dataclasses.dataclass
class WorkerSpec:
    """One supervised child process."""

    name: str  # worker-control name ("rollout0", "gen_fleet", "trainer")
    kind: str  # failure-domain key ("rollout" | "gen_fleet" | "trainer" ...)
    target: Callable  # a module-level function (spawn pickles it)
    args: Tuple = ()
    # A required worker exiting 0 without an exit request is a failure (the
    # master would wait for data forever, not crash).
    required: bool = True
    # Environment overrides in the child's spawn snapshot (a reward worker
    # hides every card: CUDA_VISIBLE_DEVICES="").
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    # A crash loop removes an expendable worker (a dynamic generation
    # server) for good instead of escalating: the autoscale plan replaces
    # it, and one flapping server never takes the run down.
    expendable: bool = False
    # One failure domain of several processes (a meshed generation
    # server's ranks): a death takes down and respawns every member.
    group: Optional[str] = None
    # this member's rank in its group (0 leads: the live count and the
    # commanded exit are its own)
    rank: int = 0


class _Entry:
    __slots__ = ("spec", "proc", "incarnation", "restarts", "respawn_due",
                 "done")

    def __init__(self, spec: WorkerSpec):
        self.spec = spec
        self.proc = None
        self.incarnation = 0
        self.restarts: List[float] = []  # clock() stamps, pruned to window
        self.respawn_due: Optional[float] = None
        self.done = False  # death already handled, or expected


class Supervisor:
    """Spawn and watch the launcher's children.

    ``check()`` runs from the launcher's monitor loop (~1 Hz) and never
    sleeps: a respawn is scheduled (``respawn_due``) and made by the first
    check past its backoff, so that tests drive the whole state machine
    with an injected clock and fake processes (``_make_proc``)."""

    def __init__(self, experiment: str, trial: str,
                 policy: Optional[RestartPolicy] = None,
                 keepalive_ttl: float = 0.0,
                 heartbeat_interval: float = 0.0,
                 restartable_kinds: Tuple[str, ...] = RESTARTABLE_KINDS,
                 clock: Callable[[], float] = time.monotonic):
        self.experiment = experiment
        self.trial = trial
        self.policy = policy or RestartPolicy()
        self.keepalive_ttl = keepalive_ttl
        self.heartbeat_interval = heartbeat_interval
        self.restartable_kinds = tuple(restartable_kinds)
        self.clock = clock
        self._entries: Dict[str, _Entry] = {}
        self._draining = False
        self.restart_counts: Dict[str, int] = {}  # kind -> total respawns
        # name -> wall time of each respawn (time.time(), for measurement)
        self.respawn_times: Dict[str, List[float]] = {}
        self._last_hb_export = 0.0
        # Shutdown markers older than this belong to an earlier incarnation
        # of the trial and must not suppress failure detection.
        self._t_start_wall = time.time()

    # ---------------- spawning ----------------

    def spawn(self, spec: WorkerSpec) -> None:
        entry = _Entry(spec)
        self._entries[spec.name] = entry
        self._start(entry)

    def _start(self, entry: _Entry) -> None:
        entry.incarnation += 1
        entry.done = False
        entry.proc = self._make_proc(entry.spec, entry.incarnation)
        logger.info(f"spawned {entry.spec.name} (kind={entry.spec.kind}, "
                    f"incarnation {entry.incarnation}, pid {entry.proc.pid})")

    def _make_proc(self, spec: WorkerSpec, incarnation: int):
        """Start the OS process (tests override this with fakes). The
        incarnation, the keepalive TTL and ``spec.env`` travel through the
        environment: the spawn snapshot carries them before the child
        imports anything."""
        from areal_tpu_torch.system import worker_base as wb

        env = {wb.ENV_INCARNATION: str(incarnation), **spec.env}
        if self.keepalive_ttl > 0:
            env[wb.ENV_KEEPALIVE_TTL] = repr(self.keepalive_ttl)
        if self.heartbeat_interval > 0:
            env[wb.ENV_HEARTBEAT_INTERVAL] = repr(self.heartbeat_interval)
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            p = mp.get_context("spawn").Process(
                target=spec.target, args=spec.args, daemon=True,
                name=spec.name)
            p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        return p

    # ---------------- monitoring ----------------

    def procs(self) -> List:
        return [e.proc for e in self._entries.values() if e.proc is not None]

    def entry(self, name: str) -> _Entry:
        return self._entries[name]

    def alive_count(self, kind: str) -> int:
        """Workers of ``kind`` still in the fleet: running, dead but not yet
        classified, or waiting for a respawn. Clean exits and removed
        (crash-looped expendable) workers do not count: that is how the
        autoscale executor sees capacity to replace."""
        return sum(1 for e in self._entries.values()
                   if e.spec.kind == kind and not e.done and e.spec.rank == 0)

    def begin_drain(self) -> None:
        """A planned teardown from here on: child exits (any code) are
        expected and never restarted or escalated."""
        self._draining = True
        for e in self._entries.values():
            e.respawn_due = None
        telemetry.set_gauge("supervisor/draining", 1.0)

    def check(self) -> None:
        """One sweep: make due respawns, classify new deaths, export
        heartbeat ages. Raises SupervisorEscalation for the stateful domain
        and for a tripped breaker."""
        now = self.clock()
        for entry in self._entries.values():
            if entry.respawn_due is not None:
                if now >= entry.respawn_due and not self._draining:
                    self._respawn(entry)
                continue
            p = entry.proc
            if p is None or entry.done or p.is_alive():
                continue
            code = p.exitcode
            if self._draining or (code == 0 and not entry.spec.required):
                entry.done = True
                continue
            if self._shutdown_signaled():
                # A commanded teardown this process did not start: the
                # master's end-of-run marker (the trainer's commanded exit
                # lands while the master finishes), or an external drain.
                logger.info(f"{entry.spec.name} exited during a signaled "
                            "shutdown or drain; treating it as expected")
                self.begin_drain()
                entry.done = True
                continue
            try:
                self._on_death(entry, code, now)
            finally:
                if entry.spec.group is not None:
                    self._follow_group(entry)
        self._export_heartbeats(now)

    def _follow_group(self, entry: _Entry) -> None:
        """The rest of ``entry``'s group goes as it went: killed now, then
        respawned at its respawn time, or left down (escalated, removed)."""
        for e in self._entries.values():
            if e is entry or e.spec.group != entry.spec.group:
                continue
            if e.proc is not None and e.proc.is_alive():
                e.proc.kill()
                e.proc.join(timeout=5)
            e.respawn_due = entry.respawn_due
            e.done = entry.done
        if entry.respawn_due is not None:
            logger.warning(f"group {entry.spec.group}: {entry.spec.name} "
                           "died; its other ranks go down and respawn with "
                           "it")

    def _shutdown_signaled(self) -> bool:
        """True iff a commanded teardown newer than this supervisor is
        advertised: the master's ``experiment_status`` marker or a drain
        phase written by :func:`drain_experiment` (possibly from another
        process). Read only when a death is classified."""
        for key in (names.experiment_status(self.experiment, self.trial),
                    names.drain_status(self.experiment, self.trial)):
            try:
                d = json.loads(name_resolve.get(key))
                if float(d.get("ts", 0.0)) >= self._t_start_wall:
                    return True
            except Exception:  # noqa: BLE001 — absent / torn: no signal
                pass
        return False

    def _on_death(self, entry: _Entry, code, now: float) -> None:
        spec = entry.spec
        reason = ("unexpected clean exit (exit 0 without an exit request)"
                  if code == 0 else f"exit code {code}")
        telemetry.inc(f"supervisor/deaths{{worker_kind={spec.kind}}}")
        if spec.kind not in self.restartable_kinds:
            self._escalate(entry, f"stateful worker {spec.name} died: "
                           f"{reason}; escalating to whole-experiment "
                           "recovery")
        entry.restarts = [t for t in entry.restarts
                          if now - t < self.policy.window_secs]
        if len(entry.restarts) >= self.policy.max_restarts:
            telemetry.set_gauge(
                f"supervisor/crash_loop_open{{worker_kind={spec.kind}}}", 1.0)
            msg = (f"{spec.name} crash-looped: {len(entry.restarts)} "
                   f"restarts inside {self.policy.window_secs:.0f}s (last "
                   f"death: {reason}); circuit breaker open")
            if spec.expendable:
                # out of the fleet for good, nothing escalates: the plan
                # notices the lost capacity and spawns a fresh worker
                entry.done = True
                self._clear_ghost_keys(spec)
                telemetry.inc(f"supervisor/removed{{worker_kind={spec.kind}}}")
                t = telemetry.get()
                if t.enabled:
                    t.event("supervisor/removed", worker=spec.name,
                            kind=spec.kind, reason=msg)
                logger.error(f"{msg}; removed (expendable): the autoscaler "
                             "replaces it within its bounds")
                return
            self._escalate(entry, msg)
        entry.restarts.append(now)
        backoff = self.policy.backoff(len(entry.restarts))
        entry.respawn_due = now + backoff
        logger.warning(f"{spec.name} (kind={spec.kind}) died: {reason}; "
                       f"respawning in {backoff:.2f}s "
                       f"({len(entry.restarts)}/{self.policy.max_restarts} "
                       "restarts in window)")

    def _escalate(self, entry: _Entry, msg: str) -> None:
        entry.done = True
        logger.error(msg)
        # Evidence before the teardown: this process's flight ring dumps
        # now; the workers' SIGTERM hooks dump theirs during shutdown.
        t = telemetry.get()
        if t.enabled:
            t.event("supervisor/escalate", worker=entry.spec.name,
                    kind=entry.spec.kind, reason=msg)
            t.flight_dump(reason=f"supervisor escalation: {msg}")
        raise SupervisorEscalation(msg)

    def _respawn(self, entry: _Entry) -> None:
        entry.respawn_due = None
        spec = entry.spec
        self._clear_ghost_keys(spec)
        self.restart_counts[spec.kind] = (
            self.restart_counts.get(spec.kind, 0) + 1)
        self.respawn_times.setdefault(spec.name, []).append(time.time())
        telemetry.inc(f"supervisor/restarts{{worker_kind={spec.kind}}}")
        self._start(entry)
        logger.warning(f"respawned {spec.name} (incarnation "
                       f"{entry.incarnation}); it rejoins through "
                       "name_resolve")

    def _clear_ghost_keys(self, spec: WorkerSpec) -> None:
        """Delete the dead incarnation's registrations before the respawn
        binds fresh ones, so that nothing resolves a corpse in the gap."""
        from areal_tpu_torch.system.worker_base import worker_control_key

        doomed = [worker_control_key(self.experiment, self.trial, spec.name),
                  names.worker_heartbeat(self.experiment, self.trial,
                                         spec.name)]
        if spec.kind == "reward" and spec.name.startswith("reward"):
            # Its discovery URL (registered as rw<i>): clients stop fanning
            # out to it now, not when its lease lapses.
            doomed.append(names.reward_worker(
                self.experiment, self.trial, "rw" + spec.name[len("reward"):]))
        if (spec.kind in ("gen_server", "gen_replica")
                and spec.name.startswith("genserver_")):
            # a server's discovery key, by its server_id
            doomed.append(names.gen_servers(
                self.experiment, self.trial, spec.name[len("genserver_"):]))
        if spec.kind == "gen_fleet":
            # The fleet process hosts the servers and the manager: clear
            # their discovery keys, so that rollout clients fail fast and
            # re-resolve instead of retrying dead sockets.
            try:
                name_resolve.clear_subtree(names.gen_server_root(
                    self.experiment, self.trial))
            except Exception:  # noqa: BLE001
                pass
            doomed.append(names.gen_server_manager(self.experiment,
                                                   self.trial))
            hb_root = names.worker_heartbeat_root(self.experiment, self.trial)
            for key in self._safe_find(hb_root):
                worker = key[len(hb_root.rstrip("/")) + 1:]
                if worker.startswith(("genserver_", "gserver_manager")):
                    doomed.append(key)
        if spec.kind == "gen_manager":
            doomed.append(names.gen_server_manager(self.experiment,
                                                   self.trial))
        for key in doomed:
            try:
                name_resolve.delete(key)
            except Exception:  # noqa: BLE001 — already gone
                pass

    @staticmethod
    def _safe_find(root: str) -> List[str]:
        try:
            return name_resolve.find_subtree(root)
        except Exception:  # noqa: BLE001
            return []

    def _export_heartbeats(self, now: float) -> None:
        """Heartbeat-age gauges (rate-limited: the walk is a directory
        scan). A live process whose heartbeat is stale is wedged, which
        process liveness cannot see."""
        if not telemetry.enabled() or self.keepalive_ttl <= 0:
            return
        if now - self._last_hb_export < max(self.keepalive_ttl / 3, 1.0):
            return
        self._last_hb_export = now
        from areal_tpu_torch.system.worker_base import read_heartbeats

        try:
            hbs = read_heartbeats(self.experiment, self.trial)
        except Exception:  # noqa: BLE001 — a name-resolve hiccup
            return
        for worker, d in hbs.items():
            age = d.get("age_secs")
            if age is None:
                continue
            telemetry.set_gauge(
                f"supervisor/heartbeat_age_secs{{worker={worker}}}", age)
            if age > 3 * self.keepalive_ttl:
                logger.warning(f"heartbeat of {worker} is {age:.0f}s old "
                               f"(ttl {self.keepalive_ttl:.0f}s): wedged?")

    # ---------------- teardown ----------------

    def shutdown(self, timeout: float = 10.0, orderly: bool = True,
                 exit_secs: Optional[float] = None,
                 stateful_secs: float = 0.0) -> None:
        """Orderly first: ask the live rollout workers to exit (each returns
        its quota), then the reward workers (a rollout's last grades still
        find the fleet), giving each wave ``exit_secs`` (default
        ``timeout / 2``); give the workers that are not restartable (the
        trainer, which exits on the master's word) ``stateful_secs``; then
        terminate what remains and kill what outlives ``timeout / 2``.
        ``orderly=False`` goes straight to terminate."""
        self.begin_drain()
        if orderly:
            for kind in _ORDERLY_KINDS:
                self._ask_exit(kind, timeout / 2 if exit_secs is None
                               else exit_secs)
        if stateful_secs > 0:
            deadline = time.monotonic() + stateful_secs
            for e in self._entries.values():
                if (e.proc is not None
                        and e.spec.kind not in self.restartable_kinds
                        and e.spec.kind not in _ORDERLY_KINDS):
                    e.proc.join(timeout=max(0.05,
                                            deadline - time.monotonic()))
        procs = self.procs()
        for p in procs:
            if p.is_alive():
                p.terminate()
        deadline = time.monotonic() + timeout / 2
        for p in procs:
            p.join(timeout=max(0.05, deadline - time.monotonic()))
            if p.is_alive():
                logger.warning(f"{p.name} outlived SIGTERM; killing it")
                p.kill()
                p.join(timeout=timeout / 2)

    def _ask_exit(self, kind: str, secs: float) -> None:
        """Command every live worker of ``kind`` to exit and give them
        ``secs`` in all to end. A worker that does not answer is asked
        again while it lives and the window lasts: one still starting has
        not registered its control endpoint yet (a dynamic server spawned
        just before the run ended), and one a drain already told to exit
        no longer answers (it ends within the window all the same)."""
        live = [e for e in self._entries.values()
                if e.proc is not None and e.proc.is_alive()
                and e.spec.kind == kind]
        if not live:
            return
        # a group's followers end with their leader: only leaders are asked
        followers = [e for e in live if e.spec.rank > 0]
        live = [e for e in live if e.spec.rank == 0]
        deadline = time.monotonic() + secs
        try:
            from areal_tpu_torch.system.worker_base import WorkerControlPanel

            panel = WorkerControlPanel(self.experiment, self.trial,
                                       timeout=2.0)
            try:
                pending = live
                while True:
                    pending = [
                        e for e in pending if e.proc.is_alive()
                        and not panel.try_command(e.spec.name,
                                                  "exit").get("ok")]
                    if not pending or time.monotonic() >= deadline:
                        break
                    time.sleep(0.2)
            finally:
                panel.close()
        except Exception:  # noqa: BLE001 — terminate covers it
            pass
        for entry in live + followers:
            entry.proc.join(timeout=max(0.05, deadline - time.monotonic()))


# --------------------------------------------------------------------------
# graceful drain (SIGTERM / preemption)
# --------------------------------------------------------------------------


def _set_drain_phase(experiment: str, trial: str, phase: str) -> None:
    try:
        name_resolve.add(
            names.drain_status(experiment, trial),
            json.dumps({"phase": phase, "ts": time.time()}),
            replace=True, delete_on_exit=False)
    except Exception:  # noqa: BLE001 — the status is advisory
        pass
    telemetry.event("supervisor/drain_phase", phase=phase)


def drain_experiment(experiment: str, trial: str,
                     timeout: float = 60.0, panel=None) -> Dict:
    """Graceful drain of a live experiment:

      1. pause the master first: the pause lands at a step boundary
         (retried while it is inside a step, whose data producers still
         run); paused, it serves control commands and starts no step.
      2. pause every rollout worker: no new rollouts; those in flight
         finish.
      3. an out-of-band recover checkpoint through the master's
         ``checkpoint`` command, served while paused (no MFC in flight; the
         trainer is never paused: it serves this checkpoint and the exit).
      4. exit, in order: the master (it leaves its loop without another
         step and tells the trainer to exit), then the rollout workers.

    The generation fleet and the reward workers have no step to drain; the
    launcher tears them down after the master returns. Works against any
    live run through name_resolve: the launcher's SIGTERM handler and
    ``tools/perf_probe.py drain`` both call it."""
    from areal_tpu_torch.system.worker_base import WorkerControlPanel

    own_panel = panel is None
    if panel is None:
        panel = WorkerControlPanel(experiment, trial,
                                   timeout=min(timeout / 4, 15.0))
    report: Dict = {"paused": {}, "checkpoint": None, "exited": []}
    deadline = time.monotonic() + timeout

    def _retry_command(worker: str, cmd: str) -> Dict:
        """Retry an idempotent command while the worker is busy in a step
        (its control channel is served between iterations)."""
        while True:
            try:
                return panel.command(worker, cmd)
            except TimeoutError as e:
                if time.monotonic() >= deadline:
                    return {"ok": False, "error": str(e)}

    try:
        workers = panel.list_workers()
        rollouts = [w for w in workers if w.startswith("rollout")]
        _set_drain_phase(experiment, trial, "pausing")
        if "master" in workers:
            report["paused"]["master"] = _retry_command("master", "pause")
        for w in rollouts:
            report["paused"][w] = panel.try_command(w, "pause")
        if "master" in workers:
            _set_drain_phase(experiment, trial, "checkpoint")
            # Sent once, on a panel whose receive window is the remaining
            # budget: a retry would queue redundant full checkpoints.
            ck_panel = WorkerControlPanel(
                experiment, trial,
                timeout=max(deadline - time.monotonic(), 1.0))
            try:
                report["checkpoint"] = ck_panel.command("master",
                                                        "checkpoint")
            except TimeoutError as e:
                report["checkpoint"] = {
                    "ok": False,
                    "error": f"{e} (the checkpoint may still be running; "
                             "not re-sent: it is not cheap to repeat)"}
            finally:
                ck_panel.close()
        _set_drain_phase(experiment, trial, "exiting")
        if "master" in workers:
            if panel.try_command("master", "exit").get("ok"):
                report["exited"].append("master")
        for w in rollouts:
            if panel.try_command(w, "exit").get("ok"):
                report["exited"].append(w)
        _set_drain_phase(experiment, trial, "done")
    finally:
        if own_panel:
            panel.close()
    logger.info(f"graceful drain complete: {report}")
    return report
