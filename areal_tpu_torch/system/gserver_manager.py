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

Left out: the autoscaler (and its ``autoscale/*`` metrics), cordon and
drain, the straggler sweep and the ``device`` transport (ROADMAP.md).
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

from areal_tpu_torch.api.train_config import TelemetryConfig
from areal_tpu_torch.base import (
    logging,
    name_resolve,
    names,
    network,
    telemetry,
)
from areal_tpu_torch.base.retry import FaultInjector, RetryPolicy, retry
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
            if (not st.routable and url not in self.servers
                    and url not in self._inflight):
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
            st.routable = True
            st.consecutive_failures = 0
            st.evicted_reason = ""
            if url not in self.servers:
                self.servers.append(url)
                self.servers.sort()
            self._inflight.setdefault(url, 0)

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
                evict = (st.routable and st.consecutive_failures
                         >= self.cfg.health_failure_threshold)
            if evict:
                self._evict(url, f"{st.consecutive_failures} consecutive "
                                 f"health failures ({e})")
            return
        self.telemetry.inc("gsmgr/health_probe_ok")
        with self._lock:
            st.consecutive_failures = 0
            st.last_failure = ""
            server_version = int(body.get("version", 0))
            restarted = st.routable and server_version < version_at_probe
        if restarted:
            # A routable server at an old version was restarted in place;
            # the reconcile below brings it back at the current version.
            self._evict(url, f"reports v{server_version} < fleet "
                             f"v{version_at_probe} (in-place restart?)")
        with self._lock:
            if st.routable or st.reconciling:
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
        self._update_fleet_gauges()

    def _update_fleet_gauges(self) -> None:
        t = self.telemetry
        if not t.enabled:
            return
        with self._lock:
            last = self.sync_history[-1] if self.sync_history else None
            t.set_gauge("gsmgr/healthy_servers", len(self.servers))
            t.set_gauge("gsmgr/known_servers", len(self.health))
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
        if cls != "rollout":
            # latency-sensitive classes go where the least interactive and
            # eval load is (total leases break ties); bulk rollout keeps
            # the configured policy
            return min(self.servers, key=lambda u: (
                self._cls_inflight(u, ("interactive", "eval")),
                self._inflight.get(u, 0)))
        if self.cfg.schedule_policy == "least_requests":
            return min(self.servers, key=lambda u: self._inflight.get(u, 0))
        url = self.servers[self._rr % len(self.servers)]
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
                return 200, {"allowed": False, "reason": "capacity"}
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
            }
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
                "fleet": {
                    u: {"routable": st.routable,
                        "consecutive_failures": st.consecutive_failures,
                        "acked_version": st.acked_version,
                        "evicted_reason": st.evicted_reason,
                        "last_failure": st.last_failure}
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
