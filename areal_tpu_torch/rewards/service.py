"""The sandboxed reward service: the HTTP grading core of the reward worker.

The port of ``areal_tpu/rewards/service.py`` (reference: the standalone
functioncall service behind ``FUNCTIONCALL_SERVICE_DOMAIN``): a fleet
member that grades math and code tasks over HTTP, so that untrusted model
code never runs in the process that drives generation or training::

  POST /math_verify    {generated, solutions}            -> {score, verdict}
  POST /code_verify    {generated, input_output, ...}    -> {score, verdict}
  POST /batch_reward   {tasks: [...]}                    -> {scores, verdicts}
  GET  /health                                           liveness + load
  GET  /metrics[.json]                                   Prometheus / JSON

Grading runs on a bounded thread pool; every code grade also runs inside
``rewards/code_verify.py``'s rlimit-guarded subprocess (the sandbox
proper). A grade that overruns its wall budget answers score 0.0 with
verdict "timeout" and counts ``reward/timeouts``; its thread cannot be
killed and runs on, holding its admission permit until it ends (or until
the pool is replaced, once every admittable thread is such a zombie).

The reference serves on an asyncio loop with an ``asyncio.Semaphore``;
this service serves a thread per connection (``system/http.py
FleetHTTPServer``), so its admission is a ``threading.Semaphore`` and the
budget is ``future.result(timeout=...)``. The answers, the counters and the
order in which the self-heal restores permits are the reference's, with one
difference: below the admission limit a timed-out grade keeps its permit
until its thread ends, as the reference documents; the reference's
``wait_for`` cancels the future it watches, which restores the permit at
once (ROADMAP.md Queue 3).

The worker around this core (discovery, heartbeat, WorkerControl) is
``system/reward_worker.py``. Nothing here uses torch.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Any, Callable, Dict, List, Optional

from areal_tpu_torch.base import logging, telemetry
from areal_tpu_torch.rewards import code_verify, math_verify

logger = logging.getLogger("rewards.service")

# Verdicts, exported per task kind (reward_verdicts_total{task,verdict}).
VERDICTS = ("pass", "fail", "timeout", "error", "unsupported_language")

_LATENCY_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

# Worst-case sampled test cases per code grade: the code-task wall-budget
# floor derives from the grader's own cap.
_CODE_MAX_CASES = code_verify.MAX_CASES_DEFAULT


def task_budget_secs(task: Dict[str, Any], base_secs: float) -> float:
    """Wall budget for one task, shared by the service's grade timeout and
    the client's per-task HTTP timeout so the two never disagree:
    ``base_secs`` bounds a wedged grader; a code task floors at its legal
    worst case (per-case timeout x the cases it carries, capped at the
    grader's sample bound, + slack)."""
    budget = float(base_secs)
    if task.get("task", "math") == "code":
        n_cases = _CODE_MAX_CASES
        io = task.get("input_output")
        try:
            d = json.loads(io) if isinstance(io, str) else io
            n = len(d.get("inputs", []))
            if n:
                n_cases = min(n, _CODE_MAX_CASES)
        except Exception:  # noqa: BLE001 — malformed io grades 0.0 fast
            pass
        worst = float(task.get("timeout", 8.0)) * n_cases + 5.0
        budget = max(budget, worst)
    return budget


def grade_task(task: Dict[str, Any],
               languages: Optional[List[str]] = None) -> Dict[str, Any]:
    """Grade one {task, generated, solutions|input_output} dict ->
    {score, verdict}. ``languages`` is a service's language policy (None:
    no policy). A grader that raises (sympy missing among the causes) gives
    score 0.0 with verdict "error". The service and the local path run this
    one dispatch, so their answers agree bit for bit."""
    kind = task.get("task", "math")
    try:
        if kind in ("math", "stem"):
            score = math_verify.verify_math(
                task["generated"], task.get("solutions", []))
        elif kind == "code":
            language = task.get("language", "python")
            if (languages is not None and language not in languages) or \
                    language not in code_verify.GRADERS:
                return {"score": 0.0, "verdict": "unsupported_language"}
            score = code_verify.verify_code(
                task["generated"], task.get("input_output", "{}"),
                timeout=float(task.get("timeout", 8.0)), language=language)
        else:
            logger.warning(f"unknown reward task kind {kind}; 0 reward")
            return {"score": 0.0, "verdict": "error"}
    except Exception as e:  # noqa: BLE001 — a bad task must not fail a batch
        logger.warning(f"grading failed ({kind}): {e}")
        return {"score": 0.0, "verdict": "error"}
    return {"score": float(score),
            "verdict": "pass" if score > 0 else "fail"}


class RewardService:
    """One fleet member: bounded concurrent grading and its telemetry.

    ``grade_fn`` is the test seam (a slow or failing grader without real
    subprocesses); the default is :func:`grade_task` under the config's
    language policy."""

    def __init__(self, cfg, telemetry_sink=None,
                 grade_fn: Optional[Callable[[Dict], Dict]] = None):
        self.cfg = cfg  # RewardServiceConfig
        self.telemetry = (telemetry_sink if telemetry_sink is not None
                          else telemetry.NULL)
        self._grade_fn = grade_fn or (
            lambda task: grade_task(task, languages=list(cfg.languages)))
        self._pool = self._new_pool()
        # The admission bound and the self-heal threshold: with every
        # admitted grade wedged (each withholding its permit) the pool is
        # replaced; comparing against pool_size alone would deadlock a
        # config with max_inflight < pool_size.
        self._admit_limit = max(1, min(int(cfg.max_inflight),
                                       int(cfg.pool_size)))
        self._sem = threading.Semaphore(self._admit_limit)
        # Guards the counters, the pool, _withheld and _pool_gen: grades
        # run on the connections' threads.
        self._lock = threading.Lock()
        self._inflight = 0
        self._graded = 0
        self._timeouts = 0
        # Timed-out grades whose pool thread still runs. Each withholds its
        # admission permit until the thread ends or the pool is replaced,
        # so an admitted grade always has a free thread and its budget
        # never times queue wait.
        self._withheld = 0
        # Bumped on a pool replacement: a stale zombie's completion must
        # not release a permit the replacement already restored.
        self._pool_gen = 0
        self._t_start = time.monotonic()
        self._http = None
        self._http_thread: Optional[threading.Thread] = None

    def _new_pool(self) -> cf.ThreadPoolExecutor:
        return cf.ThreadPoolExecutor(max_workers=max(int(self.cfg.pool_size),
                                                     1),
                                     thread_name_prefix="reward-grade")

    # ---------------- grading ----------------

    def _replace_pool(self) -> None:
        """Self-heal from grader-thread leakage: once every admittable
        thread is a zombie, swap in a fresh pool (the old one drains on its
        own, bounded by the sandbox's rlimits) and restore every withheld
        permit."""
        with self._lock:
            old = self._pool
            self._pool = self._new_pool()
            self._pool_gen += 1
            restored, self._withheld = self._withheld, 0
        for _ in range(restored):
            self._sem.release()
        self.telemetry.set_gauge("reward/abandoned_threads", 0)
        self.telemetry.inc("reward/pool_replaced")
        logger.warning("reward grader pool replaced: every thread was "
                       "wedged past its grade budget (the zombie graders "
                       "drain off-pool)")
        old.shutdown(wait=False)

    def _withhold_permit(self, fut: cf.Future) -> None:
        """A grade's thread outlived its request: keep its permit withheld
        until the thread ends (the future's done callback restores it,
        unless a pool replacement did first). At the admission limit the
        pool is replaced; as in the reference, that happens before a
        completion already pending can restore its permit."""
        with self._lock:
            self._withheld += 1
            n = self._withheld
            gen = self._pool_gen
        self.telemetry.set_gauge("reward/abandoned_threads", n)
        if n >= self._admit_limit:
            self._replace_pool()

        def _zombie_done(_f, gen=gen):
            with self._lock:
                restore = self._pool_gen == gen and self._withheld > 0
                if restore:
                    self._withheld -= 1
                    n = self._withheld
            if restore:
                self.telemetry.set_gauge("reward/abandoned_threads", n)
                self._sem.release()

        fut.add_done_callback(_zombie_done)

    def grade(self, task: Dict[str, Any]) -> Dict[str, Any]:
        """Grade one task under the admission bound and its wall budget.
        An admitted task starts grading at once (admission is clamped to
        the thread count). A grader that raises propagates (the handler
        answers 500), as in the reference."""
        kind = task.get("task", "math")
        self._sem.acquire()
        withheld = False
        try:
            with self._lock:
                self._inflight += 1
                n = self._inflight
                fut = self._pool.submit(self._grade_fn, task)
            self.telemetry.set_gauge("reward/inflight", n)
            t0 = time.monotonic()
            try:
                out = fut.result(timeout=task_budget_secs(
                    task, self.cfg.grade_timeout_secs))
            except cf.TimeoutError:
                # The thread runs on; its permit stays withheld until it
                # ends, so no grade is admitted without a free thread.
                with self._lock:
                    self._timeouts += 1
                self.telemetry.inc("reward/timeouts")
                self._withhold_permit(fut)
                withheld = True
                out = {"score": 0.0, "verdict": "timeout"}
            finally:
                with self._lock:
                    self._inflight -= 1
                    n = self._inflight
                self.telemetry.set_gauge("reward/inflight", n)
        finally:
            if not withheld:
                self._sem.release()
        dt = time.monotonic() - t0
        with self._lock:
            self._graded += 1
        self.telemetry.inc("reward/requests")
        self.telemetry.inc(
            f"reward/verdicts{{task={kind},verdict={out['verdict']}}}")
        self.telemetry.observe(f"reward/grade_latency_secs{{task={kind}}}",
                               dt, buckets=_LATENCY_BUCKETS)
        return out

    def grade_batch(self, tasks: List[Dict[str, Any]]) -> List[Dict]:
        """Every task at once, each under the admission bound (the
        reference gathers them on its loop); answers in task order."""
        if not tasks:
            return []
        with cf.ThreadPoolExecutor(max_workers=min(len(tasks), 256),
                                   thread_name_prefix="reward-batch") as ex:
            return list(ex.map(self.grade, tasks))

    # ---------------- HTTP ----------------

    def health(self) -> Dict[str, Any]:
        return {
            "ok": True,
            "inflight": self._inflight,
            "graded_total": self._graded,
            "timeouts_total": self._timeouts,
            "languages": list(self.cfg.languages),
            "uptime_secs": time.monotonic() - self._t_start,
        }

    def metrics_dict(self) -> Dict[str, Any]:
        return {
            "reward_graded": self._graded,
            "reward_timeout_count": self._timeouts,
            "reward_inflight": self._inflight,
            "reward_pool_size": self.cfg.pool_size,
        }

    def handle(self, method: str, path: str, body: Optional[bytes],
               extra_metrics: Optional[Callable[[], Dict]] = None,
               labels: Optional[Dict[str, str]] = None):
        """One request -> (status, JSON body or Prometheus text). The
        reference's routes and bodies; a grader that raises answers 500."""
        if method == "GET":
            if path == "/health":
                return 200, self.health()
            gauges = {**self.metrics_dict(),
                      **(extra_metrics() if extra_metrics else {})}
            if path == "/metrics.json":
                return 200, gauges
            if path == "/metrics":
                return 200, telemetry.render_prometheus(
                    self.telemetry.snapshot(reset=False),
                    extra_gauges=gauges, labels=labels)
            return 404, {"error": "not found"}
        kinds = {"/math_verify": "math", "/code_verify": "code"}
        if path in kinds:
            try:
                task = json.loads(body or b"")
                if not isinstance(task, dict):
                    raise ValueError("not an object")
            except ValueError:
                return 400, {"score": 0.0, "verdict": "error",
                             "error": "bad json"}
            task.setdefault("task", kinds[path])
            return 200, self.grade(task)
        if path == "/batch_reward":
            try:
                parsed = json.loads(body or b"")
                tasks = parsed["tasks"] if isinstance(parsed, dict) \
                    else parsed
                if not isinstance(tasks, list):
                    raise ValueError("not a list")
            except (ValueError, KeyError, TypeError):
                return 400, {"error": "expected {tasks: [...]} or a JSON "
                                      "list"}
            outs = self.grade_batch(tasks)
            return 200, {"scores": [o["score"] for o in outs],
                         "verdicts": [o["verdict"] for o in outs]}
        return 404, {"error": "not found"}

    def serve(self, host: str, port: int,
              extra_metrics: Optional[Callable[[], Dict]] = None,
              labels: Optional[Dict[str, str]] = None):
        """Serve the routes on ``(host, port)`` (0: a free port) from a
        thread of their own; returns the bound (host, port).
        ``extra_metrics`` / ``labels`` let the wrapping worker add its
        identity to the exposition."""
        from areal_tpu_torch.system.http import FleetHTTPServer

        service = self

        class Handler(BaseHTTPRequestHandler):
            def _dispatch(self, method: str) -> None:
                body = None
                if method == "POST":
                    n = int(self.headers.get("Content-Length", 0) or 0)
                    body = self.rfile.read(n)
                try:
                    status, out = service.handle(method, self.path, body,
                                                 extra_metrics, labels)
                except Exception as e:  # noqa: BLE001 — report, keep serving
                    status, out = 500, {"error": repr(e)}
                if isinstance(out, str):
                    data = out.encode()
                    ctype = "text/plain; charset=utf-8"
                else:
                    data = json.dumps(out).encode()
                    ctype = "application/json"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                if isinstance(out, str):
                    self.send_header("X-Prometheus-Version", "0.0.4")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 (http.server naming)
                self._dispatch("GET")

            def do_POST(self):  # noqa: N802
                self._dispatch("POST")

            def log_message(self, *args):
                pass

        self._http = FleetHTTPServer((host, port), Handler)
        self._http_thread = threading.Thread(
            target=self._http.serve_forever, name="reward-http", daemon=True)
        self._http_thread.start()
        return self._http.server_address[:2]

    def close(self) -> None:
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None
        self._pool.shutdown(wait=False, cancel_futures=True)
