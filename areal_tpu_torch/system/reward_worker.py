"""Reward worker: the sixth worker kind, a member of the sandbox fleet.

The port of ``areal_tpu/system/reward_worker.py``: one
:class:`~areal_tpu_torch.rewards.service.RewardService` registered under
``names.reward_worker`` (with a keepalive lease under a supervisor), its
``/health`` and Prometheus ``/metrics``, per-task-kind telemetry pushed to
the master's aggregator, a liveness heartbeat named after the launcher's
worker (``reward{i}``), and WorkerControl (pause, resume, exit, status).
Under the launcher's supervisor it is a restartable stateless domain: a
dead reward worker respawns in place while clients retry on the
surviving replicas (``rewards/client.py``).

CPU only by design: untrusted code grades on spare host cores, never on the
card that trains. The launcher spawns the process with every card hidden
(``CUDA_VISIBLE_DEVICES=""``); the package's import of torch opens no CUDA
context, and nothing this worker runs asks torch for a device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

from areal_tpu_torch.api.train_config import (
    RewardServiceConfig,
    TelemetryConfig,
)
from areal_tpu_torch.base import logging, name_resolve, names, network
from areal_tpu_torch.base import telemetry
from areal_tpu_torch.rewards.service import RewardService

logger = logging.getLogger("system.reward_worker")


@dataclasses.dataclass
class RewardWorkerConfig:
    experiment: str = "exp"
    trial: str = "trial"
    worker_index: int = 0
    # Fixed port of worker 0 (0 = a free port); discovery goes through
    # name_resolve either way.
    port: int = 0
    reward: RewardServiceConfig = dataclasses.field(
        default_factory=RewardServiceConfig)
    telemetry: TelemetryConfig = dataclasses.field(
        default_factory=TelemetryConfig)
    # Liveness lease on the reward_workers/ registration: a killed worker's
    # URL expires from discovery. 0 falls back to the supervisor's env TTL.
    keepalive_ttl_secs: float = 0.0


class RewardWorker:
    """One RewardService, its fleet registration and its control."""

    def __init__(self, cfg: RewardWorkerConfig, grade_fn=None):
        self.cfg = cfg
        self.worker_id = f"rw{cfg.worker_index}"
        # An instance of its own (not the process global): a test hosts
        # several workers in one process, each a distinct (kind, index) at
        # the aggregator.
        self.telemetry = (
            telemetry.Telemetry(cfg.experiment, cfg.trial, "reward",
                                cfg.worker_index, cfg=cfg.telemetry)
            if cfg.telemetry.enabled else telemetry.NULL)
        self.service = RewardService(cfg.reward, telemetry_sink=self.telemetry,
                                     grade_fn=grade_fn)
        self.url = ""
        self._t_start = time.monotonic()
        self._hb = None

    def _key(self) -> str:
        return names.reward_worker(self.cfg.experiment, self.cfg.trial,
                                   self.worker_id)

    def start(self) -> str:
        """Serve and register under ``names.reward_worker``; returns the
        URL."""
        from areal_tpu_torch.system.worker_base import (
            HeartbeatThread,
            default_heartbeat_interval,
            env_keepalive_ttl,
        )

        port = ((self.cfg.port + self.cfg.worker_index) if self.cfg.port
                else network.find_free_port())
        self.service.serve(
            network.bind_addr(), port,
            extra_metrics=lambda: {"reward_worker_uptime_secs":
                                   time.monotonic() - self._t_start},
            labels={"worker_id": self.worker_id})
        self.url = f"http://{network.gethostip()}:{port}"
        ttl = self.cfg.keepalive_ttl_secs or env_keepalive_ttl() or 0.0
        name_resolve.add(self._key(), self.url, replace=True,
                         keepalive_ttl=ttl or None)
        if ttl:
            # A thread of its own keeps the lease: a worker busy in a long
            # grade still looks alive; only a kill (which takes the thread)
            # lets it lapse. Named as the launcher names the worker, so the
            # supervisor's respawn purge finds the dead incarnation's beat.
            self._hb = HeartbeatThread(
                self.cfg.experiment, self.cfg.trial,
                f"reward{self.cfg.worker_index}",
                interval=default_heartbeat_interval(ttl))
            self._hb.lease(self._key(), self.url, ttl)
        logger.info(f"reward worker {self.worker_id} at {self.url} "
                    f"(pool={self.cfg.reward.pool_size}, "
                    f"languages={list(self.cfg.reward.languages)})"
                    + (f" (keepalive {ttl:.0f}s)" if ttl else ""))
        return self.url

    def stop(self) -> None:
        if self._hb is not None:
            self._hb.close()
            self._hb = None
        # Withdraw discovery first, so that client fanout forgets this URL
        # instead of spending a retry on a closing socket.
        try:
            name_resolve.delete(self._key())
        except Exception:  # noqa: BLE001 — already gone / repo reset
            pass
        self.service.close()
        self.telemetry.close()

    def status(self) -> dict:
        return {"url": self.url, "graded": self.service._graded,
                "inflight": self.service._inflight,
                "timeouts": self.service._timeouts}

    def run(self) -> None:
        """Serve until WorkerControl commands exit (the launcher's entry;
        tests drive start and stop directly). Pause gates nothing here: a
        reward worker holds no training state, and grades in flight
        finish either way."""
        from areal_tpu_torch.system.worker_base import WorkerControl

        self.start()
        ctrl = WorkerControl(self.cfg.experiment, self.cfg.trial,
                             f"reward{self.cfg.worker_index}")
        try:
            while True:
                ctrl.step(self.status, 200)
                if ctrl.should_exit:
                    break
        finally:
            ctrl.close()
            self.stop()
        logger.info(f"reward worker {self.worker_id} done: "
                    f"{self.service._graded} graded, "
                    f"{self.service._timeouts} timeouts")


def resolve_fleet(experiment: str, trial: str) -> List[str]:
    """Live reward-worker URLs from name_resolve, sorted for a stable
    round-robin: the one discovery helper of clients and tools."""
    root = names.reward_worker_root(experiment, trial)
    try:
        return sorted(name_resolve.get_subtree(root))
    except Exception:  # noqa: BLE001 — an unreachable repo counts as empty
        return []

