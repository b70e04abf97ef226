"""Generation-server manager: routing, the staleness gate, weight fanout and
fleet health.

The port of ``areal_tpu/system/gserver_manager.py`` (reference
``realhf/system/gserver_manager.py:32``), on the standard library: a
threaded HTTP server answers the rollout clients, a health thread probes
the fleet, a watcher thread fans new weight versions out; every piece of
lease, quota and version state sits under one lock.

 - Routing: ``/schedule_request`` hands out a lease on a server for a
   request class (``{"class": ...}``; an unknown one is ``rollout``):
   rollout by ``round_robin`` or ``least_requests``, interactive and eval
   to the server with the least interactive+eval leases (total leases
   break ties). ``/renew`` extends a lease, ``/release`` retires it by
   lease id or, unambiguously, by URL; leases expire after
   ``lease_ttl_secs``. The per-class lease counts are the
   ``gsmgr_inflight_{class}`` gauges.
 - The staleness gate (reference ``is_staled``): in sample units,
   ``(accepted + running) // train_batch_size`` may not exceed
   ``max_head_offpolicyness + version``; ``/allocate_rollout`` also denies
   at ``max_concurrent_rollouts``; ``/finish_rollout`` returns the booking.
   A booking that names its rollout worker and incarnation (``worker``,
   ``incarnation``) is also counted per worker: the first allocation of a
   respawned worker's new incarnation returns what its killed predecessor
   still held (a SIGKILL sends no ``/finish_rollout``; the reference leaks
   that quota until the manager restarts).
 - Fleet health: every ``health_check_interval_secs`` the manager reads the
   registrations under ``names.gen_servers`` and probes each server's
   ``/health``; ``health_failure_threshold`` consecutive failures evict a
   server (its leases drop), and a server that is back (or new) joins only
   after its weights are reconciled to the fleet's version.
 - Weights: a watcher polls ``names.model_version``; a new version goes to
   every routable server at once over ``/update_weights`` (the stream
   endpoint when the trainer publishes one under ``names.weight_stream``,
   else the disk path), each push bounded by ``fanout_timeout_secs`` and
   retried per ``fanout_retry``. A server that never acks is evicted; no
   ack at all holds the version; a server admitted during the fanout at an
   older version is demoted. Publish-to-swap seconds are anchored on
   ``names.model_version_time``; old disk versions are removed.

Observability (``telemetry``, off by default): a registry of the
manager's own with the fleet gauges, the probe, eviction and fanout
counters, the fanout ack histogram, an eviction event with a flight dump,
the ``gsmgr/alloc`` and ``gsmgr/finish`` spans of traced rollouts, and
``GET /metrics`` (Prometheus text), ``/metrics.json`` and
``/metrics_discovery`` (every metrics endpoint of the experiment, in
Prometheus http_sd format).

The elastic fleet (``system/autoscaler.py``): the **cordon** takes a
server out of the routing without dropping its leases (its rollouts drain
on them, or fail over), the health sweep never re-admits it, and
``uncordon`` sends it back through the health gate (probe and weight
reconcile); ``POST /cordon`` and ``/uncordon`` (``{url | server_id}``) are
the operator's preemption hook and work with the autoscaler off. With
``autoscale.enabled`` a loop every ``interval_secs`` feeds the
:class:`~areal_tpu_torch.system.autoscaler.AutoscalerCore` the fleet's
signals (utilization, queue depth, the staleness gate, TTFC and fanout
latency, stale heartbeats, the sentinel's inhibit hint), cordons a victim
to scale down (a drained dynamic server is told to exit over
WorkerControl), reclaims a cordoned server before asking for a new one, and
publishes the plan the launcher's executor spawns dynamic servers from;
the straggler sweep deprioritizes, then cordons, a server whose decode
EWMA stays past ``straggler_factor`` x its peers' median; and at
``max_servers`` under sustained saturation, capacity denials carry a
``retry_after`` hint. The ``autoscale/*`` gauges are on the scrape either
way.

Left out: the ``device`` transport.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import shutil
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Callable, Dict, List, Optional, Tuple

from areal_tpu_torch.api.train_config import AutoscaleConfig, TelemetryConfig
from areal_tpu_torch.base import (
    logging,
    name_resolve,
    names,
    network,
    telemetry,
)
from areal_tpu_torch.base.retry import FaultInjector, RetryPolicy, retry
from areal_tpu_torch.system import autoscaler as autoscale_mod
from areal_tpu_torch.system.http import FleetHTTPServer, request_json
from areal_tpu_torch.system.serving import REQUEST_CLASSES, normalize_class
from areal_tpu_torch.system.worker_base import (
    HeartbeatThread,
    default_heartbeat_interval,
    env_keepalive_ttl,
)

logger = logging.getLogger("system.gserver_mgr")

@dataclasses.dataclass
class GserverManagerConfig:
    experiment: str = "exp"
    trial: str = "trial"
    model_role: str = "actor"
    n_servers: int = 1
    train_batch_size: int = 8
    max_head_offpolicyness: int = 0
    max_concurrent_rollouts: int = 64
    schedule_policy: str = "round_robin"  # or least_requests
    realloc_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "areal_tpu", "realloc"))
    weight_poll_secs: float = 1.0
    port: Optional[int] = None
    keep_last_versions: int = 2
    # A lease the client neither renews nor releases expires.
    lease_ttl_secs: float = 120.0
    health_check_interval_secs: float = 2.0
    health_check_timeout_secs: float = 2.0
    # Consecutive /health failures before a server leaves the routing.
    health_failure_threshold: int = 3
    # Each /update_weights attempt is bounded by fanout_timeout_secs and
    # retried per fanout_retry before the server is evicted.
    fanout_timeout_secs: float = 60.0
    fanout_retry: RetryPolicy = dataclasses.field(
        default_factory=lambda: RetryPolicy(
            max_attempts=2, base_delay_secs=0.2, max_delay_secs=2.0))
    telemetry: TelemetryConfig = dataclasses.field(
        default_factory=TelemetryConfig)
    # The elastic fleet, straggler defense and overload backpressure; the
    # cordon routes work with it off.
    autoscale: AutoscaleConfig = dataclasses.field(
        default_factory=AutoscaleConfig)


@dataclasses.dataclass
class _ServerHealth:
    """Per-server fleet-membership state (keyed by url)."""

    routable: bool = True  # in the routing set
    consecutive_failures: int = 0
    acked_version: int = 0  # last weight version this server confirmed
    evicted_reason: str = ""
    # The last probe or push failure, kept so an eviction can say why.
    last_failure: str = ""
    reconciling: bool = False  # re-admission weight push in flight
    # Cordoned: out of the routing but not forgotten; its leases stay valid
    # so that rollouts drain on them, and the health sweep keeps probing
    # without re-admitting it until an uncordon.
    cordoned: bool = False
    cordon_reason: str = ""
    cordon_deadline: float = 0.0  # monotonic; 0: no drain in progress
    exit_commanded: bool = False  # a dynamic server told to exit
    # Uncordoned, not yet re-admitted: pending capacity, so that the plan
    # does not ask for a replacement in the one-sweep gap.
    uncordon_pending: bool = False
    # from the /health bodies
    server_id: str = ""
    queue_depth: int = 0
    ttfc_ewma_secs: float = 0.0
    # a straggler: routed only when no faster server is left
    deprioritized: bool = False


# the read-only state of a url that raced out of ``health``
_DEFAULT_HEALTH = _ServerHealth()


class GserverManager:
    def __init__(self, cfg: GserverManagerConfig,
                 fault_injector: Optional[FaultInjector] = None):
        self.cfg = cfg
        self.servers: List[str] = []  # healthy, routable urls
        self.health: Dict[str, _ServerHealth] = {}  # every known url
        self.version = 0
        self._rr = 0
        self._inflight: Dict[str, int] = {}  # url -> outstanding leases
        self._leases: Dict[str, Tuple[str, float]] = {}  # id -> (url, expiry)
        self._lease_seq = 0
        # Each lease's request class, and the leases per url and class:
        # one fleet carries rollout and interactive/eval traffic.
        self._lease_class: Dict[str, str] = {}
        self._inflight_cls: Dict[str, Dict[str, int]] = {}
        # Both staleness terms count samples: an allocation of group_size
        # samples adds group_size to running.
        self.running_rollouts = 0
        self.accepted_rollouts = 0
        # worker -> [incarnation, samples it holds]: bookings that name
        # their worker, so that a respawn returns its predecessor's quota
        self._booked: Dict[str, List[int]] = {}
        self.reclaimed_samples = 0
        self.faults = fault_injector
        # Weight-sync latency: (version, fanout secs, publish-to-swap secs)
        self.sync_history: List[tuple] = []
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._pool = concurrent.futures.ThreadPoolExecutor(
            16, thread_name_prefix="gsmgr")
        self._http: Optional[FleetHTTPServer] = None
        self._hb = None
        self._url: Optional[str] = None
        self.telemetry = (
            telemetry.Telemetry(cfg.experiment, cfg.trial, "gserver_manager",
                                0, cfg=cfg.telemetry)
            if cfg.telemetry.enabled else telemetry.NULL)
        # The slow scaling controller beside this router, and the straggler
        # tracker (it needs only the health sweep).
        ac = cfg.autoscale
        self.autoscaler = (autoscale_mod.AutoscalerCore(ac) if ac.enabled
                           else None)
        self.straggler = (
            autoscale_mod.StragglerTracker(
                factor=ac.straggler_factor,
                min_probes=ac.straggler_min_probes,
                slow_sweeps=ac.straggler_slow_sweeps,
                cordon_sweeps=ac.straggler_cordon_sweeps,
                floor_secs=ac.straggler_floor_secs)
            if ac.enabled and ac.straggler_defense else None)
        self._overloaded = False  # pinned at max_servers and saturated

    # ---------------- discovery ----------------

    def wait_for_servers(self, timeout: float = 300.0) -> None:
        deadline = time.monotonic() + timeout
        root = names.gen_server_root(self.cfg.experiment, self.cfg.trial)
        while time.monotonic() < deadline:
            urls = sorted(name_resolve.get_subtree(root))
            if len(urls) >= self.cfg.n_servers:
                with self._lock:
                    self.servers = urls
                    self._inflight = {u: 0 for u in urls}
                    self.health = {u: _ServerHealth() for u in urls}
                logger.info(f"found {len(urls)} generation servers")
                return
            time.sleep(0.2)
        raise TimeoutError(
            f"{self.cfg.n_servers} generation servers did not register "
            f"within {timeout:.0f}s")

    # ---------------- fleet membership (under the lock) ----------------

    def _drop_server_leases(self, url: str) -> int:
        dropped = [lid for lid, (u, _) in self._leases.items() if u == url]
        for lid in dropped:
            del self._leases[lid]
            self._lease_class.pop(lid, None)
        self._inflight.pop(url, None)
        self._inflight_cls.pop(url, None)
        return len(dropped)

    def _evict(self, url: str, reason: str) -> None:
        """Out of routing: leases dropped, inflight slots freed. The url
        stays in ``health`` so probes can re-admit it."""
        with self._lock:
            st = self.health.setdefault(url, _ServerHealth())
            # (a cordoned server keeps its leases until it drains: evicting
            # one must still drop them)
            if (not st.routable and url not in self.servers
                    and url not in self._inflight
                    and not any(u == url for u, _ in self._leases.values())):
                return  # already out
            st.routable = False
            st.evicted_reason = reason
            if url in self.servers:
                self.servers.remove(url)
            dropped = self._drop_server_leases(url)
            last_failure = st.last_failure
            why = (f"; last failure: {last_failure}"
                   if last_failure and last_failure not in reason else "")
            logger.warning(f"evicted {url} ({reason}{why}); dropped {dropped} "
                           f"leases, {len(self.servers)} servers remain")
        self.telemetry.inc("gsmgr/evictions")
        # Post-mortem evidence, written outside the lock: the eviction lands
        # in the flight ring as an event, and the ring is dumped (with a
        # flight_dir).
        self.telemetry.event("gsmgr/evict", url=url, reason=reason,
                             last_failure=last_failure,
                             dropped_leases=dropped)
        self.telemetry.flight_dump(reason=f"evict {url}: {reason}")

    def _admit(self, url: str) -> None:
        with self._lock:
            st = self.health.get(url)
            if st is None:
                return  # deregistered while reconciling: stay forgotten
            if st.cordoned:
                return  # only an uncordon lets the health gate route it
            st.routable = True
            st.consecutive_failures = 0
            st.evicted_reason = ""
            st.uncordon_pending = False
            if url not in self.servers:
                self.servers.append(url)
                self.servers.sort()
            self._inflight.setdefault(url, 0)

    # ---------------- cordon and drain ----------------

    def cordon(self, url: str, reason: str, source: str = "operator") -> bool:
        """Take ``url`` out of the routing without dropping its leases: new
        requests stop landing, rollouts in flight drain on their leases (or
        fail over if it dies), and the health sweep keeps probing but never
        re-admits it. Scale-down, straggler defense and preemption notices
        all come here."""
        with self._lock:
            st = self.health.get(url)
            if st is None or st.cordoned:
                return False
            st.cordoned = True
            st.cordon_reason = reason
            st.routable = False
            st.deprioritized = False
            st.exit_commanded = False
            st.uncordon_pending = False
            st.cordon_deadline = (time.monotonic()
                                  + self.cfg.autoscale.drain_timeout_secs)
            if url in self.servers:
                self.servers.remove(url)
            if self.straggler is not None:
                self.straggler.forget(url)
            inflight = self._inflight.get(url, 0)
            n_routable = len(self.servers)
        self.telemetry.inc("autoscale/cordons")
        self.telemetry.inc(f"autoscale/cordons_{source}")
        self.telemetry.event("autoscale/cordon", url=url, reason=reason,
                             source=source, inflight=inflight)
        logger.warning(f"cordoned {url} ({reason}, source={source}); "
                       f"{inflight} requests in flight draining, "
                       f"{n_routable} servers remain routable")
        self._update_fleet_gauges()
        return True

    def uncordon(self, url: str) -> bool:
        """Lift a cordon. The server does not route at once: it goes back
        through the health gate (probe and weight reconcile), as a new
        server does; its weights may be several versions old by now."""
        with self._lock:
            st = self.health.get(url)
            if st is None or not st.cordoned:
                return False
            st.cordoned = False
            st.cordon_reason = ""
            st.cordon_deadline = 0.0
            st.exit_commanded = False
            st.consecutive_failures = 0
            st.uncordon_pending = True
        self.telemetry.inc("autoscale/uncordons")
        self.telemetry.event("autoscale/uncordon", url=url)
        logger.info(f"uncordoned {url}; re-admission through the health gate")
        return True

    def _server_draining_load(self, url: str) -> int:
        """The work that pins a cordoned server: its live leases, or the
        in-flight slots they hold."""
        with self._lock:
            leases = sum(1 for u, _ in self._leases.values() if u == url)
            return max(leases, self._inflight.get(url, 0))

    def _cordoned_count(self) -> int:
        with self._lock:
            return sum(1 for st in self.health.values() if st.cordoned)

    # ---------------- weights ----------------

    def _current_weight_path(self) -> str:
        return os.path.join(self.cfg.realloc_dir, self.cfg.model_role,
                            str(self.version))

    def _update_payload(self, v: int, path: str) -> Dict:
        """The /update_weights body for version ``v``: the trainer's stream
        endpoint when it registered one under ``names.weight_stream``, else
        the disk checkpoint at ``path``."""
        try:
            endpoint = name_resolve.get(names.weight_stream(
                self.cfg.experiment, self.cfg.trial, self.cfg.model_role))
        except name_resolve.NameEntryNotFoundError:
            endpoint = None
        if endpoint:
            return {"endpoint": endpoint, "version": v}
        return {"path": path, "version": v}

    def _push_weights_one(self, url: str, v: int, path: str,
                          payload: Optional[Dict] = None) -> bool:
        """POST /update_weights to one server, each attempt bounded by
        ``fanout_timeout_secs``, retried per ``fanout_retry``. True on an
        ack."""
        if payload is None:
            payload = self._update_payload(v, path)

        t0 = time.monotonic()

        def post():
            if self.faults is not None:
                self.faults.maybe_fail("fanout", url=url, version=v)
            status, _ = request_json(f"{url}/update_weights", payload,
                                     timeout=self.cfg.fanout_timeout_secs)
            if status != 200:
                raise RuntimeError(f"/update_weights status {status}")

        try:
            retry(post, self.cfg.fanout_retry, on_retry=lambda n, e:
                  logger.warning(f"weight push v{v} -> {url} attempt {n} "
                                 f"failed: {e}"))
        except Exception as e:  # noqa: BLE001 — an ack failure, not fatal
            with self._lock:
                st = self.health.get(url)
                if st is not None:
                    st.last_failure = f"weight push v{v}: {e!r}"
            self.telemetry.inc("gsmgr/fanout_failures")
            logger.warning(f"weight push v{v} -> {url} gave up: {e}")
            return False
        self.telemetry.observe("gsmgr/fanout_ack_secs",
                               time.monotonic() - t0)
        with self._lock:
            st = self.health.get(url)
            if st is not None:
                st.acked_version = v
        return True

    def fanout_weights(self, v: int, path: str) -> List[str]:
        """Push version ``v`` to every routable server at once. The version
        moves only when at least one server acked; a server that exhausts
        its retries is evicted. Returns the acked urls."""
        with self._lock:
            targets = list(self.servers)
        # One payload for the whole fanout: every server gets the same
        # transport for version v.
        payload = self._update_payload(v, path)
        results = list(self._pool.map(
            lambda u: self._push_weights_one(u, v, path, payload), targets))
        acked = [u for u, ok in zip(targets, results) if ok]
        if not acked:
            # Systemic (a bad or late path): evicting the whole fleet would
            # flap; hold the version and retry on the next poll.
            logger.error(f"weight v{v}: no server acked; version held at "
                         f"{self.version} for retry next poll")
            return []
        for u, ok in zip(targets, results):
            if not ok:
                self._evict(u, f"no ack for weight v{v}")
        with self._lock:
            self.version = v
            # A server admitted while this fanout ran reconciled to the old
            # version and is not in targets: demote it until it is at v.
            stale = [u for u in self.servers
                     if u not in targets and self.health.get(u) is not None
                     and self.health[u].acked_version < v]
        for u in stale:
            self._evict(u, f"admitted mid-fanout at stale "
                           f"v{self.health[u].acked_version} (< v{v})")
        return acked

    def _reconcile_weights(self, url: str, server_version: int) -> bool:
        """Bring a (re)joining server to the fleet's version before it
        serves: a stale server would tag rollouts with old versions."""
        if self.version == 0 or server_version >= self.version:
            with self._lock:
                st = self.health.get(url)
                if st is not None:
                    st.acked_version = self.version
            return True
        ok = self._push_weights_one(url, self.version,
                                    self._current_weight_path())
        if not ok:
            logger.warning(f"{url} failed weight reconcile to "
                           f"v{self.version}; not re-admitting yet")
        return ok

    def _watch_weights_once(self) -> None:
        key = names.model_version(self.cfg.experiment, self.cfg.trial,
                                  self.cfg.model_role)
        try:
            v = int(name_resolve.get(key))
        except name_resolve.NameEntryNotFoundError:
            return  # nothing published yet
        if v <= self.version or not self.servers:
            return
        path = os.path.join(self.cfg.realloc_dir, self.cfg.model_role, str(v))
        t0 = time.monotonic()
        if not self.fanout_weights(v, path):
            return
        fanout_secs = time.monotonic() - t0
        # publish start (the trainer's anchor) -> every server swapped
        e2e_secs = None
        try:
            pub_ts = float(name_resolve.get(names.model_version_time(
                self.cfg.experiment, self.cfg.trial, self.cfg.model_role)))
            e2e_secs = max(time.time() - pub_ts, fanout_secs)
        except name_resolve.NameEntryNotFoundError:
            pass
        self.sync_history.append((v, fanout_secs, e2e_secs))
        self._update_fleet_gauges()
        logger.info(f"weight sync v{v}: fanout {fanout_secs:.2f}s over "
                    f"{len(self.servers)} servers"
                    + (f", publish->swap {e2e_secs:.2f}s"
                       if e2e_secs is not None else ""))
        self._gc_old_versions(v)

    def _gc_old_versions(self, current: int) -> None:
        root = os.path.join(self.cfg.realloc_dir, self.cfg.model_role)
        if not os.path.isdir(root):
            return
        for d in os.listdir(root):
            try:
                v = int(d)
            except ValueError:
                continue
            if v <= current - self.cfg.keep_last_versions:
                shutil.rmtree(os.path.join(root, d), ignore_errors=True)

    # ---------------- fleet health ----------------

    def _check_one(self, url: str) -> None:
        with self._lock:
            st = self.health.setdefault(url, _ServerHealth())
            # The fleet version at probe time: a fanout finishing while the
            # GET is in flight must not make a just-updated server look
            # stale.
            version_at_probe = self.version
        try:
            if self.faults is not None:
                self.faults.maybe_fail("health", url=url)
            status, body = request_json(
                f"{url}/health", timeout=self.cfg.health_check_timeout_secs)
            if status != 200:
                raise RuntimeError(f"/health status {status}")
        except Exception as e:  # noqa: BLE001 — any probe failure counts
            self.telemetry.inc("gsmgr/health_probe_failures")
            with self._lock:
                st.consecutive_failures += 1
                st.last_failure = f"health probe: {e!r}"
                dead = (st.consecutive_failures
                        >= self.cfg.health_failure_threshold)
                evict = st.routable and dead
                if st.cordoned and dead:
                    # A cordoned server died mid-drain: its clients fail
                    # over by chunk replay; retire its leases now instead of
                    # at their expiry.
                    self._drop_server_leases(url)
                if dead:
                    st.uncordon_pending = False  # dead, not pending capacity
            if evict:
                self._evict(url, f"{st.consecutive_failures} consecutive "
                                 f"health failures ({e})")
            return
        self.telemetry.inc("gsmgr/health_probe_ok")
        with self._lock:
            st.consecutive_failures = 0
            st.last_failure = ""
            # the load and latency the autoscale signals and the straggler
            # EWMAs read come with the probe
            st.server_id = str(body.get("server_id", st.server_id) or "")
            st.queue_depth = int(body.get("queue_depth", 0) or 0)
            st.ttfc_ewma_secs = float(body.get("ttfc_ewma_secs", 0.0) or 0.0)
            decode_ewma = body.get("decode_ewma_secs")
            if (self.straggler is not None and st.routable
                    and decode_ewma is not None):
                self.straggler.observe(url, float(decode_ewma))
            server_version = int(body.get("version", 0))
            restarted = st.routable and server_version < version_at_probe
        if restarted:
            # A routable server at an old version was restarted in place;
            # the reconcile below brings it back at the current version.
            self._evict(url, f"reports v{server_version} < fleet "
                             f"v{version_at_probe} (in-place restart?)")
        with self._lock:
            # a cordoned server never re-admits here: uncordon first
            if st.routable or st.reconciling or st.cordoned:
                return
            st.reconciling = True
        # Detached: a slow reconcile must not stall the sweep.
        t = threading.Thread(target=self._readmit, args=(url, server_version),
                             daemon=True, name="gsmgr-readmit")
        t.start()

    def _readmit(self, url: str, server_version: int) -> None:
        st = self.health.get(url)
        try:
            if not self._reconcile_weights(url, server_version):
                return
            with self._lock:
                cur = self.health.get(url)
                # deregistered, or a fanout moved past the version just
                # reconciled to: the next sweep reconciles again
                if cur is None or cur.acked_version < self.version:
                    return
            self._admit(url)
            logger.info(f"re-admitted {url} at weight v{self.version}")
        finally:
            if st is not None:
                st.reconciling = False

    def check_fleet(self) -> None:
        """One health sweep: new registrations join through the health
        gate, deregistered urls are forgotten, every known server is
        probed."""
        root = names.gen_server_root(self.cfg.experiment, self.cfg.trial)
        registered = set(name_resolve.get_subtree(root))
        for url in registered:
            with self._lock:
                if url not in self.health:
                    # routed only after a passing probe and a reconcile
                    self.health[url] = _ServerHealth(routable=False)
                    logger.info(f"discovered new server {url}")
        for url in list(self.health):
            if url not in registered:
                self._evict(url, "deregistered from name_resolve")
                with self._lock:
                    self.health.pop(url, None)
        list(self._pool.map(self._check_one, list(self.health)))
        self._straggler_sweep()
        self._update_fleet_gauges()

    def _straggler_sweep(self) -> None:
        """Score every routable server's decode EWMA against its peers: a
        persistently slow one is deprioritized, then cordoned, before it
        pins the oldest rollouts on the slowest decode and wedges the
        staleness gate."""
        if self.straggler is None:
            return
        with self._lock:
            if len(self.servers) < 2:
                return
            verdicts = self.straggler.sweep(list(self.servers))
        factor = self.cfg.autoscale.straggler_factor
        for url, verdict in verdicts.items():
            with self._lock:
                st = self.health.get(url)
                if st is None or st.cordoned:
                    continue
                ewma_ms = (self.straggler.ewma(url) or 0.0) * 1e3
                newly_slow = verdict == "slow" and not st.deprioritized
                recovered = verdict == "ok" and st.deprioritized
                if newly_slow:
                    st.deprioritized = True
                elif recovered:
                    st.deprioritized = False
            if verdict == "cordon":
                self.telemetry.inc("autoscale/straggler_cordons")
                self.cordon(url, f"straggler: decode EWMA {ewma_ms:.1f}ms "
                                 "vs peers", source="straggler")
            elif newly_slow:
                self.telemetry.inc("autoscale/straggler_deprioritized")
                self.telemetry.event("autoscale/deprioritize", url=url,
                                     ewma_secs=ewma_ms / 1e3)
                logger.warning(f"{url} deprioritized: decode EWMA "
                               f"{ewma_ms:.1f}ms is {factor:.0f}x over the "
                               "peer median")
            elif recovered:
                logger.info(f"{url} back within peer latency; restored to "
                            "full routing priority")

    def _update_fleet_gauges(self) -> None:
        t = self.telemetry
        if not t.enabled:
            return
        with self._lock:
            last = self.sync_history[-1] if self.sync_history else None
            t.set_gauge("gsmgr/healthy_servers", len(self.servers))
            t.set_gauge("gsmgr/known_servers", len(self.health))
            t.set_gauge("autoscale/cordoned_servers", self._cordoned_count())
            t.set_gauge("autoscale/current_size", len(self.servers))
            if self.autoscaler is not None:
                t.set_gauge("autoscale/target_size", self._target())
                t.set_gauge("autoscale/overloaded", float(self._overloaded))
            t.set_gauge("gsmgr/lease_depth", len(self._leases))
            t.set_gauge("gsmgr/running_rollouts", self.running_rollouts)
            t.set_gauge("gsmgr/accepted_rollouts", self.accepted_rollouts)
            t.set_gauge("gsmgr/weight_version", self.version)
            for c, n in self._inflight_by_class().items():
                t.set_gauge(f"gsmgr/inflight_{c}", n)
        if last is not None:
            t.set_gauge("gsmgr/weight_sync_fanout_secs", last[1])
            if last[2] is not None:
                t.set_gauge("gsmgr/weight_sync_e2e_secs", last[2])

    def _loop(self, interval: float, step: Callable[[], None],
              what: str) -> None:
        while not self._stop.wait(interval):
            try:
                step()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                logger.warning(f"{what} error: {e!r}")

    # ---------------- the elastic fleet ----------------

    def _target(self) -> int:
        t = self.autoscaler.target if self.autoscaler is not None else None
        return t if t is not None else len(self.servers)

    def _stale_heartbeat_urls(self, routable) -> set:
        """Routable servers whose heartbeat went stale (alive to the OS,
        wedged to the lease): not capacity, so the plan replaces them at a
        constant target."""
        ttl = env_keepalive_ttl() or 0.0
        if ttl <= 0 or not routable:
            return set()
        try:
            from areal_tpu_torch.system.worker_base import read_heartbeats

            hbs = read_heartbeats(self.cfg.experiment, self.cfg.trial)
        except Exception:  # noqa: BLE001 — a name-resolve hiccup
            return set()
        stale_ids = set()
        for worker, d in hbs.items():
            if not worker.startswith("genserver_"):
                continue
            age = d.get("age_secs")
            if age is not None and age > 3 * ttl:
                stale_ids.add(worker[len("genserver_"):])
        with self._lock:
            return {u for u in routable
                    if self.health.get(u, _DEFAULT_HEALTH).server_id
                    in stale_ids}

    def _autoscale_signals(self, stale_urls: set
                           ) -> "autoscale_mod.FleetSignals":
        ac = self.cfg.autoscale
        with self._lock:
            routable = list(self.servers)
            qd = slo_frac = 0.0
            if routable:
                sts = [self.health.get(u, _DEFAULT_HEALTH) for u in routable]
                qd = sum(st.queue_depth for st in sts) / len(routable)
                if ac.slo_ttfc_secs > 0:
                    slo_frac = sum(1 for st in sts if st.ttfc_ewma_secs
                                   > ac.slo_ttfc_secs) / len(routable)
            last = self.sync_history[-1] if self.sync_history else None
            return autoscale_mod.FleetSignals(
                current_size=len(routable),
                cordoned=self._cordoned_count(),
                utilization=(self.running_rollouts
                             / max(self.cfg.max_concurrent_rollouts, 1)),
                queue_depth=qd, staled=self.is_staled(),
                slo_miss_frac=slo_frac,
                fanout_ack_secs=(last[1] if last else 0.0) or 0.0,
                stale_heartbeats=len(stale_urls))

    def _pick_scale_down_victim(self) -> Optional[str]:
        with self._lock:
            if len(self.servers) <= 1:
                return None  # never cordon the last routable server

            def key(u):
                st = self.health.get(u, _DEFAULT_HEALTH)
                return (0 if st.deprioritized else 1,  # slow servers first
                        # dynamic before baseline: a baseline server shares
                        # the fleet process and can only idle, never exit
                        0 if st.server_id.startswith("dyn") else 1,
                        self._inflight.get(u, 0))  # least left to drain

            return min(self.servers, key=key)

    def _autoscale_tick(self) -> None:
        """One interval of the scaling controller: feed the core the
        signals, act on its verdict (cordon a victim, or reclaim a cordoned
        server), and publish the plan the launcher's executor spawns
        from."""
        ac = self.cfg.autoscale
        with self._lock:
            routable = list(self.servers)
        stale_urls = self._stale_heartbeat_urls(routable)
        sig = self._autoscale_signals(stale_urls)
        # The sentinel's inhibit hint (a critical training-health alert is
        # live): no scale-up while it lasts; more decode capacity cannot fix
        # a diverging trainer.
        inhibit = autoscale_mod.read_inhibit(self.cfg.experiment,
                                             self.cfg.trial)
        sig.inhibited = inhibit is not None
        self.telemetry.set_gauge("autoscale/inhibited",
                                 1.0 if inhibit else 0.0)
        if inhibit:
            logger.debug(f"autoscale: scale-up inhibited by sentinel rule "
                         f"{inhibit.get('rule')!r}")
        with self._lock:
            action = self.autoscaler.observe(sig)
            self._overloaded = self.autoscaler.overloaded
            target = self._target()
            n_routable = len(self.servers)
        if action is not None:
            self.telemetry.inc("autoscale/scale_up" if action["action"] == "up"
                               else "autoscale/target_down")
            self.telemetry.event("autoscale/retarget", **action)
            logger.info(f"autoscale: target -> {action['target']} "
                        f"({action['action']}: {action['reason']})")
        if n_routable > target:
            victim = self._pick_scale_down_victim()
            if victim is not None:
                self.cordon(victim, f"scale-down to {target}",
                            source="autoscaler")
        elif n_routable < target:
            # the cheapest capacity first: a healthy server cordoned for
            # scale-down still holds near-current weights (never one told
            # to exit: a passing probe could route leases onto a corpse)
            with self._lock:
                reclaim = next(
                    (url for url, st in self.health.items()
                     if st.cordoned
                     and st.cordon_reason.startswith("scale-down")
                     and st.consecutive_failures == 0
                     and not st.exit_commanded), None)
            if reclaim is not None:
                self.uncordon(reclaim)
        # A wedged (stale-heartbeat) server stays routable (eviction is the
        # health sweep's call) but is not counted: the plan asks for a
        # replacement without moving the target.
        with self._lock:
            baseline_alive = sum(
                1 for url, st in self.health.items()
                if not st.cordoned and url not in stale_urls
                and (st.routable or st.reconciling or st.uncordon_pending)
                and not st.server_id.startswith("dyn"))
            overloaded = self._overloaded
        dynamic = max(0, min(target, ac.max_servers) - baseline_alive)
        autoscale_mod.publish_plan(self.cfg.experiment, self.cfg.trial, {
            "target": target, "dynamic": dynamic, "overloaded": overloaded,
            "ts": time.time()})
        self._update_fleet_gauges()

    def _command_server_exit(self, server_id: str) -> bool:
        """The commanded exit of a drained dynamic server: the supervisor
        sees the clean exit of a worker that is not required, and never
        respawns it."""
        from areal_tpu_torch.system.worker_base import WorkerControlPanel

        panel = WorkerControlPanel(self.cfg.experiment, self.cfg.trial,
                                   timeout=5.0)
        try:
            return bool(panel.try_command(f"genserver_{server_id}",
                                          "exit").get("ok"))
        except Exception as e:  # noqa: BLE001 — endpoint gone / resolving
            logger.warning(f"exit command to genserver_{server_id} failed: "
                           f"{e}")
            return False
        finally:
            panel.close()

    def _drain_cordoned(self) -> None:
        """Walk the cordoned servers: once one holds no lease (or its drain
        deadline passed; clients fail over by chunk replay), count the
        scale-down and command a dynamic server's exit."""
        now = time.monotonic()
        for url in list(self.health):
            with self._lock:
                st = self.health.get(url)
                if st is None or not st.cordoned or st.exit_commanded:
                    continue
                load = self._server_draining_load(url)
                if load > 0 and now < st.cordon_deadline:
                    continue
                if load > 0:
                    logger.warning(f"{url} drain deadline passed with {load} "
                                   "leases outstanding; going ahead "
                                   "(clients fail over by chunk replay)")
                    self._drop_server_leases(url)
                sid = st.server_id
            dynamic = sid.startswith("dyn")
            if dynamic and not self._command_server_exit(sid):
                continue  # again next interval
            with self._lock:
                st.exit_commanded = True
            self.telemetry.inc("autoscale/scale_down")
            self.telemetry.event("autoscale/drained", url=url,
                                 reason=st.cordon_reason, forced=load > 0)
            logger.info(f"cordoned server {url} drained ({st.cordon_reason}); "
                        + ("exit commanded" if dynamic
                           else "idling in the baseline fleet process"))

    def _autoscale_loop(self) -> None:
        """The scaling controller's thread: a tick at once, then one every
        ``interval_secs``."""
        while True:
            try:
                self._autoscale_tick()
                self._drain_cordoned()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                logger.warning(f"autoscale tick error: {e!r}")
            if self._stop.wait(self.cfg.autoscale.interval_secs):
                return

    # ---------------- scheduling (under the lock) ----------------

    def _drop_lease_class(self, lid: str, url: str) -> None:
        cls = self._lease_class.pop(lid, "rollout")
        by = self._inflight_cls.get(url)
        if by and by.get(cls, 0) > 0:
            by[cls] -= 1

    def _expire_leases(self) -> None:
        now = time.monotonic()
        for lid in [lid for lid, (_, exp) in self._leases.items()
                    if exp < now]:
            url, _ = self._leases.pop(lid)
            if self._inflight.get(url, 0) > 0:
                self._inflight[url] -= 1
            self._drop_lease_class(lid, url)
            logger.warning(f"lease {lid} on {url} expired (client gone?)")

    def _cls_inflight(self, url: str, classes) -> int:
        by = self._inflight_cls.get(url, {})
        return sum(by.get(c, 0) for c in classes)

    def _inflight_by_class(self) -> Dict[str, int]:
        return {c: sum(by.get(c, 0) for by in self._inflight_cls.values())
                for c in REQUEST_CLASSES}

    def _pick_server(self, cls: str = "rollout") -> Optional[str]:
        self._expire_leases()
        if not self.servers:
            return None
        # Straggler defense: a deprioritized server is routed only when no
        # faster peer is left.
        pool = [u for u in self.servers
                if not self.health.get(u, _DEFAULT_HEALTH).deprioritized
                ] or self.servers
        if cls != "rollout":
            # latency-sensitive classes go where the least interactive and
            # eval load is (total leases break ties); bulk rollout keeps
            # the configured policy
            return min(pool, key=lambda u: (
                self._cls_inflight(u, ("interactive", "eval")),
                self._inflight.get(u, 0)))
        if self.cfg.schedule_policy == "least_requests":
            return min(pool, key=lambda u: self._inflight.get(u, 0))
        url = pool[self._rr % len(pool)]
        self._rr += 1
        return url

    def is_staled(self) -> bool:
        expected = ((self.accepted_rollouts + self.running_rollouts)
                    // max(self.cfg.train_batch_size, 1))
        return expected > self.cfg.max_head_offpolicyness + self.version

    # ---------------- handlers: (status, reply) ----------------

    def schedule_request(self, d: Dict, headers=None) -> Tuple[int, Dict]:
        cls = normalize_class(d.get("class"))
        with self._lock:
            url = self._pick_server(cls)
            if url is None:
                # The whole fleet is out: clients back off and retry.
                return 503, {"url": None, "reason": "no_healthy_servers"}
            self._inflight[url] += 1
            self._lease_seq += 1
            lease_id = f"l{self._lease_seq}"
            self._leases[lease_id] = (
                url, time.monotonic() + self.cfg.lease_ttl_secs)
            self._lease_class[lease_id] = cls
            by = self._inflight_cls.setdefault(url, {})
            by[cls] = by.get(cls, 0) + 1
            self.telemetry.inc(f"gsmgr/scheduled_{cls}")
            return 200, {"url": url, "version": self.version,
                         "lease_id": lease_id, "class": cls}

    def renew(self, d: Dict, headers=None) -> Tuple[int, Dict]:
        lid = d.get("lease_id")
        with self._lock:
            if lid in self._leases:
                url, _ = self._leases[lid]
                self._leases[lid] = (
                    url, time.monotonic() + self.cfg.lease_ttl_secs)
                return 200, {"ok": True}
        return 200, {"ok": False, "reason": "unknown lease"}

    def release(self, d: Dict, headers=None) -> Tuple[int, Dict]:
        with self._lock:
            lid = d.get("lease_id")
            if lid is not None:
                if lid in self._leases:
                    u, _ = self._leases.pop(lid)
                    if self._inflight.get(u, 0) > 0:
                        self._inflight[u] -= 1
                    self._drop_lease_class(lid, u)
                return 200, {"ok": True}
            # By url: retire the lease too, but only when exactly one
            # lease is on it (never guess another client's); with several
            # only the counts move, each lease expiring on its own later.
            u = d.get("url")
            matches = [l for l, (lu, _) in self._leases.items() if lu == u]
            if len(matches) == 1:
                del self._leases[matches[0]]
                self._drop_lease_class(matches[0], u)
            elif matches:
                # No lease retired, but the class count moves with the
                # total: a rollout lease's class first (by-url clients
                # predate classes).
                lid2 = next((l for l in matches
                             if self._lease_class.get(l, "rollout")
                             == "rollout"), matches[0])
                cls = self._lease_class.get(lid2, "rollout")
                by = self._inflight_cls.get(u)
                if by and by.get(cls, 0) > 0:
                    by[cls] -= 1
            if u in self._inflight and self._inflight[u] > 0:
                self._inflight[u] -= 1
            return 200, {"ok": True}

    def allocate_rollout(self, d: Dict, headers=None) -> Tuple[int, Dict]:
        n = int(d.get("n_samples", 1))
        with self._lock:
            self._reclaim_predecessor(d)
            if self.running_rollouts >= self.cfg.max_concurrent_rollouts:
                reply = {"allowed": False, "reason": "capacity"}
                if self._overloaded:
                    # pinned at max_servers and still saturated: polling
                    # every 0.5 s will not open the gate sooner
                    reply["retry_after"] = (
                        self.cfg.autoscale.backpressure_retry_secs)
                    self.telemetry.inc("autoscale/backpressure_denials")
                return 200, reply
            if self.is_staled():
                return 200, {"allowed": False, "reason": "staleness"}
            self.running_rollouts += n
            self._book(d, n)
            version = self.version
        # The gate's admission joins the rollout's trace (denials stay
        # counters on the rollout worker: a closed gate is polled often).
        self._trace_event("gsmgr/alloc", headers, n_samples=n,
                          version=version)
        return 200, {"allowed": True, "version": version}

    def finish_rollout(self, d: Dict, headers=None) -> Tuple[int, Dict]:
        # n_samples mirrors what /allocate_rollout booked; n_accepted is
        # how many of them went to the trainer.
        n = int(d.get("n_samples", 1))
        n_accepted = int(d.get("n_accepted", n if d.get("accepted") else 0))
        with self._lock:
            self.running_rollouts = max(0, self.running_rollouts - n)
            self.accepted_rollouts += n_accepted
            self._book(d, -n)
        self._trace_event("gsmgr/finish", headers, n_samples=n,
                          n_accepted=n_accepted)
        return 200, {"ok": True}

    def _reclaim_predecessor(self, d: Dict) -> None:
        """A booking from a newer incarnation of a worker returns what the
        older one still held (under the lock)."""
        worker = d.get("worker")
        if worker is None:
            return
        inc = int(d.get("incarnation", 0))
        held = self._booked.get(worker)
        if held is not None and held[0] < inc:
            if held[1] > 0:
                self.running_rollouts = max(0, self.running_rollouts
                                            - held[1])
                self.reclaimed_samples += held[1]
                logger.warning(f"{worker} incarnation {inc} replaces "
                               f"{held[0]}: returned the {held[1]} samples "
                               "of quota it still held")
                self.telemetry.inc("gsmgr/reclaimed_samples", held[1])
            self._booked[worker] = [inc, 0]

    def _book(self, d: Dict, n: int) -> None:
        worker = d.get("worker")
        if worker is None:
            return
        inc = int(d.get("incarnation", 0))
        held = self._booked.setdefault(worker, [inc, 0])
        if held[0] == inc:
            held[1] = max(0, held[1] + n)

    def _trace_event(self, name: str, headers, **attrs) -> None:
        if not self.telemetry.enabled or headers is None:
            return
        ctx = telemetry.extract_headers(headers)
        if ctx is not None:
            self.telemetry.add_span(name, time.time(), 0.0, trace=ctx,
                                    **attrs)

    def get_model_version(self, d: Dict, headers=None) -> Tuple[int, Dict]:
        return 200, {"version": self.version}

    def _resolve_server(self, d: Dict) -> Optional[str]:
        """A ``{url}`` or ``{server_id}`` body -> a known url."""
        with self._lock:
            url = d.get("url")
            if url:
                return url if url in self.health else None
            sid = str(d.get("server_id") or "")
            if sid:
                return next((u for u, st in self.health.items()
                             if st.server_id == sid), None)
            return None

    def handle_cordon(self, d: Dict, headers=None) -> Tuple[int, Dict]:
        """The operator's (preemption-notice) cordon:
        ``{url | server_id, reason}``."""
        url = self._resolve_server(d)
        if url is None:
            return 404, {"ok": False, "reason": "unknown server"}
        ok = self.cordon(url, str(d.get("reason") or "operator request"),
                         source="operator")
        return 200, {"ok": ok, "url": url,
                     "draining": self._server_draining_load(url),
                     "already_cordoned": not ok}

    def handle_uncordon(self, d: Dict, headers=None) -> Tuple[int, Dict]:
        url = self._resolve_server(d)
        if url is None:
            return 404, {"ok": False, "reason": "unknown server"}
        return 200, {"ok": self.uncordon(url), "url": url}

    # ---------------- metrics ----------------

    def metrics_text(self) -> str:
        """``GET /metrics``: the fleet gauges plus the manager's registry
        (probe and fanout counters, histograms)."""
        with self._lock:
            gauges = {
                "gsmgr_weight_version": self.version,
                "gsmgr_running_rollouts": self.running_rollouts,
                "gsmgr_accepted_rollouts": self.accepted_rollouts,
                "gsmgr_healthy_servers": len(self.servers),
                "gsmgr_known_servers": len(self.health),
                "gsmgr_lease_depth": len(self._leases),
                "gsmgr_inflight_requests": sum(self._inflight.values()),
                # per-class lease load
                **{f"gsmgr_inflight_{c}": n
                   for c, n in self._inflight_by_class().items()},
                "gsmgr_staled": float(self.is_staled()),
                # the elastic fleet, on a bare scrape too
                "autoscale_cordoned_servers": self._cordoned_count(),
                "autoscale_current_size": len(self.servers),
            }
            if self.autoscaler is not None:
                gauges["autoscale_target_size"] = self._target()
                gauges["autoscale_overloaded"] = float(self._overloaded)
            last = self.sync_history[-1] if self.sync_history else None
        gauges["gsmgr_weight_sync_fanout_secs"] = last and last[1]
        gauges["gsmgr_weight_sync_e2e_secs"] = last and last[2]
        return telemetry.render_prometheus(
            self.telemetry.snapshot(reset=False), extra_gauges=gauges)

    def metrics_json(self, d: Dict = None, headers=None) -> Tuple[int, Dict]:
        with self._lock:
            last = self.sync_history[-1] if self.sync_history else None
            return 200, {
                "version": self.version,
                "running_rollouts": self.running_rollouts,
                "accepted_rollouts": self.accepted_rollouts,
                "healthy_servers": len(self.servers),
                "known_servers": len(self.health),
                "inflight_by_class": self._inflight_by_class(),
                "autoscale": {
                    "enabled": self.cfg.autoscale.enabled,
                    "target_size": (self.autoscaler.target
                                    if self.autoscaler is not None else None),
                    "current_size": len(self.servers),
                    "cordoned": self._cordoned_count(),
                    "overloaded": self._overloaded},
                "fleet": {
                    u: {"routable": st.routable,
                        "consecutive_failures": st.consecutive_failures,
                        "acked_version": st.acked_version,
                        "evicted_reason": st.evicted_reason,
                        "last_failure": st.last_failure,
                        "server_id": st.server_id,
                        "cordoned": st.cordoned,
                        "cordon_reason": st.cordon_reason,
                        "deprioritized": st.deprioritized,
                        "queue_depth": st.queue_depth,
                        "draining": (self._server_draining_load(u)
                                     if st.cordoned else 0)}
                    for u, st in self.health.items()},
                "weight_sync_fanout_secs": last and last[1],
                "weight_sync_e2e_secs": last and last[2],
                "weight_sync_history": [
                    {"version": v, "fanout_secs": f, "e2e_secs": e}
                    for v, f, e in self.sync_history[-20:]],
            }

    def metrics_discovery(self, d: Dict = None,
                          headers=None) -> Tuple[int, List[Dict]]:
        """Every metrics endpoint of this experiment (the servers' and
        this manager's) in Prometheus http_sd format."""
        def host(u: str) -> str:
            return u.split("//", 1)[-1]

        labels = {"experiment": self.cfg.experiment, "trial": self.cfg.trial}
        with self._lock:
            groups = [{"targets": [host(u) for u in self.servers],
                       "labels": {**labels, "role": "generation_server"}}]
        if self._url:
            groups.append({"targets": [host(self._url)],
                           "labels": {**labels, "role": "gserver_manager"}})
        return 200, groups

    # ---------------- lifecycle ----------------

    def start(self) -> str:
        """Wait for the fleet, start the HTTP server, the health and weight
        threads, register under ``names.gen_server_manager``; returns the
        URL."""
        self.wait_for_servers()
        routes = {
            ("POST", "/schedule_request"): self.schedule_request,
            ("POST", "/renew"): self.renew,
            ("POST", "/release"): self.release,
            ("POST", "/allocate_rollout"): self.allocate_rollout,
            ("POST", "/finish_rollout"): self.finish_rollout,
            ("GET", "/get_model_version"): self.get_model_version,
            ("POST", "/cordon"): self.handle_cordon,
            ("POST", "/uncordon"): self.handle_uncordon,
            ("GET", "/metrics.json"): self.metrics_json,
            ("GET", "/metrics_discovery"): self.metrics_discovery,
        }
        mgr = self

        class Handler(BaseHTTPRequestHandler):
            def _serve(self, method: str):
                fn = routes.get((method, self.path))
                ctype = "application/json"
                if (method, self.path) == ("GET", "/metrics"):
                    data = mgr.metrics_text().encode()
                    status, ctype = 200, "text/plain; version=0.0.4"
                elif fn is None:
                    status, reply = 404, {"ok": False, "error": "not found"}
                else:
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        body = json.loads(self.rfile.read(n) or b"{}")
                        status, reply = fn(body if isinstance(body, dict)
                                           else {}, self.headers)
                    except Exception as e:  # noqa: BLE001 — report, serve on
                        status, reply = 500, {"ok": False, "error": repr(e)}
                if ctype == "application/json":
                    data = json.dumps(reply).encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):  # noqa: N802 (http.server naming)
                self._serve("POST")

            def do_GET(self):  # noqa: N802
                self._serve("GET")

            def log_message(self, *args):
                pass

        self._http = FleetHTTPServer(
            (network.bind_addr(), self.cfg.port or 0), Handler)
        self._threads = [
            threading.Thread(target=self._http.serve_forever, daemon=True,
                             name="gsmgr-http"),
            threading.Thread(target=self._loop, daemon=True,
                             name="gsmgr-weights",
                             args=(self.cfg.weight_poll_secs,
                                   self._watch_weights_once, "weight watch")),
            threading.Thread(target=self._loop, daemon=True,
                             name="gsmgr-health",
                             args=(self.cfg.health_check_interval_secs,
                                   self.check_fleet, "health sweep")),
        ]
        if self.autoscaler is not None:
            self._threads.append(threading.Thread(
                target=self._autoscale_loop, daemon=True,
                name="gsmgr-autoscale"))
        for t in self._threads:
            t.start()
        self._url = f"http://{network.gethostip()}:{self._http.server_address[1]}"
        ttl = env_keepalive_ttl() or 0.0
        key = names.gen_server_manager(self.cfg.experiment, self.cfg.trial)
        name_resolve.add(key, self._url, replace=True,
                         keepalive_ttl=ttl or None)
        if ttl:
            self._hb = HeartbeatThread(
                self.cfg.experiment, self.cfg.trial, "gserver_manager",
                interval=default_heartbeat_interval(ttl))
            self._hb.lease(key, self._url, ttl)
        logger.info(f"gserver manager at {self._url}"
                    + (f" (keepalive {ttl:.0f}s)" if ttl else ""))
        return self._url

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the threads and the HTTP server, withdraw the
        registration."""
        self._stop.set()
        if self._hb is not None:
            self._hb.close()
            self._hb = None
        if self._http is not None:
            try:
                name_resolve.delete(names.gen_server_manager(
                    self.cfg.experiment, self.cfg.trial))
            except name_resolve.NameEntryNotFoundError:
                pass
            self._http.shutdown()
            self._http.server_close()
            self._http = None
        for t in self._threads:
            t.join(timeout)
        self._threads = []
        self._pool.shutdown(wait=False, cancel_futures=True)
        self.telemetry.close()
