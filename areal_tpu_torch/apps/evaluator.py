"""Automatic checkpoint evaluator.

The port of ``areal_tpu/apps/evaluator.py`` (reference
``realhf/scheduler/evaluator.py:160``, AutomaticEvaluator and
EvaluationStep): a watcher thread scans the run's save directory for new
checkpoints of one model role, runs at most ``max_concurrent_jobs`` eval
subprocesses (``python -m areal_tpu_torch.apps.eval_ckpt``) over them in
step order, and writes the scores through the metric writer. The launcher
starts one when ``auto_eval`` is on.

Differences:
 - the eval subprocess runs on the run's device (``--device``: ``cuda``
   unless the run is on the CPU), beside the trainer on the same card; the
   reference forces it onto the CPU because one process owns a TPU;
 - ``stop()`` ends an eval subprocess still running within
   ``STOP_TERMINATE_SECS`` (SIGTERM, then SIGKILL) and joins the watcher;
   the reference joins the watcher for 10 s and leaves a running
   subprocess behind (ROADMAP.md Queue 3);
 - the launcher passes the graph's trained role (SFT's ``default``), where
   the reference's always watches ``actor`` (ROADMAP.md Queue 3).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
from typing import Callable, Dict, List, Optional

from areal_tpu_torch.base import logging

logger = logging.getLogger("apps.evaluator")

_STEP_DIR = re.compile(r"^step(\d+)$")
# the package's parent directory, for the eval subprocess's import path
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclasses.dataclass
class EvaluationStep:
    """One checkpoint's eval lifecycle (reference evaluator.py:34)."""

    step: int
    ckpt_dir: str
    status: str = "pending"  # pending | running | done | failed
    scores: Optional[Dict] = None


def discover_new_steps(save_dir: str, role: str,
                       seen: set) -> List[EvaluationStep]:
    root = os.path.join(save_dir, role)
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _STEP_DIR.match(name)
        if not m or name in seen:
            continue
        d = os.path.join(root, name)
        # Only completed saves: save_hf_checkpoint writes
        # areal_tpu_config.json last, and load_hf_checkpoint reads it.
        if os.path.exists(os.path.join(d, "areal_tpu_config.json")):
            seen.add(name)
            out.append(EvaluationStep(step=int(m.group(1)), ckpt_dir=d))
    return sorted(out, key=lambda s: s.step)


class AutomaticEvaluator:
    """Watch, evaluate, write. ``run_eval`` is a test seam; the default
    runs ``python -m areal_tpu_torch.apps.eval_ckpt`` on ``device``."""

    # stop(): SIGTERM to a running eval subprocess, SIGKILL after this long
    STOP_TERMINATE_SECS = 10.0
    EVAL_TIMEOUT_SECS = 3600.0

    def __init__(
        self,
        cfg,  # AutomaticEvaluatorConfig
        save_dir: str,
        dataset_path: str,
        role: str = "actor",
        metric_writer=None,
        run_eval: Optional[Callable[[EvaluationStep], Dict]] = None,
        poll_secs: float = 5.0,
        mock_tokenizer: bool = False,
        reward_service: Optional[tuple] = None,
        device: Optional[str] = None,
    ):
        self.cfg = cfg
        self.save_dir = save_dir
        self.dataset_path = dataset_path
        self.role = role
        self.writer = metric_writer
        self.poll_secs = poll_secs
        self.mock_tokenizer = mock_tokenizer
        # (experiment, trial, nfs_name_resolve_root or "", config JSON or
        # ""): grade the eval generations on the reward fleet, under the
        # run's RewardServiceConfig.
        self.reward_service = reward_service
        self.device = device or "cuda"
        self._run_eval = run_eval or self._subprocess_eval
        # the metric writer is called from the eval pool's threads
        self._writer_lock = threading.Lock()
        self._seen: set = set()
        self.steps: List[EvaluationStep] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._procs: set = set()
        self._procs_lock = threading.Lock()

    # -------------- eval execution --------------

    def _command(self, step: EvaluationStep, out_path: str) -> List[str]:
        cmd = [
            sys.executable, "-m", "areal_tpu_torch.apps.eval_ckpt",
            "--ckpt", step.ckpt_dir,
            "--dataset", self.dataset_path,
            "--output", out_path,
            "--max-gen-tokens", str(self.cfg.max_gen_tokens),
            "--device", self.device,
        ]
        # k > 1: pass@1 / pass@k / pass^k per task kind; k = 1: the greedy
        # accuracy.
        k = int(getattr(self.cfg, "eval_k", 1) or 1)
        if k > 1:
            cmd += ["--k", str(k), "--temperature",
                    str(getattr(self.cfg, "temperature", 0.6))]
        if self.mock_tokenizer:
            cmd.append("--mock-tokenizer")
        return cmd

    def _subprocess_eval(self, step: EvaluationStep) -> Dict:
        with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as f:
            out_path = f.name
        cmd = self._command(step, out_path)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, env.get("PYTHONPATH")) if p)
        if self.reward_service is not None:
            exp, trial, nr_root, cfg_json = self.reward_service
            cmd += ["--reward-service", exp, trial]
            if cfg_json:
                cmd += ["--reward-service-config", cfg_json]
            if nr_root:
                env["AREAL_NAME_RESOLVE_ROOT"] = nr_root
        try:
            with self._procs_lock:
                if self._stop.is_set():
                    raise RuntimeError("evaluator stopped")
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True,
                                        env=env)
                self._procs.add(proc)
            try:
                _, err = proc.communicate(timeout=self.EVAL_TIMEOUT_SECS)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                raise
            finally:
                with self._procs_lock:
                    self._procs.discard(proc)
            if proc.returncode != 0:
                raise RuntimeError(f"exit {proc.returncode}: {err[-800:]}")
            with open(out_path) as f:
                return json.load(f)
        finally:
            os.unlink(out_path)

    # -------------- watcher loop --------------

    def _eval_one(self, step: EvaluationStep) -> bool:
        try:
            step.scores = self._run_eval(step)
            step.status = "done"
            logger.info(f"eval step {step.step}: {step.scores}")
            if self.writer is not None:
                metrics = {f"eval/{k}": v
                           for k, v in (step.scores or {}).items()
                           if isinstance(v, (int, float))}
                with self._writer_lock:
                    self.writer.write(metrics, step.step)
            return True
        except Exception as e:  # noqa: BLE001 — eval must not end training
            step.status = "failed"
            logger.error(f"eval step {step.step} failed: {e}")
            return False

    def poll_once(self) -> int:
        """Discover and evaluate new checkpoints; returns how many were
        evaluated. Up to ``max_concurrent_jobs`` run at once; a failed eval
        counts toward the cap, so that a bad checkpoint is not retried
        without bound within one poll."""
        from concurrent.futures import ThreadPoolExecutor

        self.steps.extend(discover_new_steps(self.save_dir, self.role,
                                             self._seen))
        cap = max(1, self.cfg.max_concurrent_jobs)
        batch = [s for s in self.steps if s.status == "pending"][:cap]
        if not batch:
            return 0
        for s in batch:
            s.status = "running"
        if len(batch) == 1:
            return int(self._eval_one(batch[0]))
        with ThreadPoolExecutor(max_workers=cap,
                                thread_name_prefix="eval") as pool:
            return sum(pool.map(self._eval_one, batch))

    def run_forever(self) -> None:
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self.poll_secs)

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run_forever, daemon=True,
                                        name="auto-eval")
        self._thread.start()

    def stop(self) -> None:
        """Stop watching; an eval subprocess still running gets SIGTERM,
        then SIGKILL after ``STOP_TERMINATE_SECS``; every subprocess is
        reaped and the watcher joined before this returns."""
        with self._procs_lock:
            self._stop.set()
            procs = list(self._procs)
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=self.STOP_TERMINATE_SECS)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if self._thread is not None:
            self._thread.join(timeout=self.STOP_TERMINATE_SECS)
        if self.writer is not None and hasattr(self.writer, "close"):
            self.writer.close()
