"""Probes of a live fleet, from any host that can reach it.

The port's counterparts of the reference's ``tools/perf_probe.py``
``scrape`` (:195), ``decode_bench`` (:245), ``reward_bench`` (:317),
``flight_dump`` (:502), ``spool_status`` (:511), ``fleet_status`` (:750),
``cordon`` (:856) and ``drain`` (:890), on
the standard library (``urllib`` on a thread pool: the card's machine has
no ``aiohttp``)::

    python -m areal_tpu_torch.tools.perf_probe scrape <url>
    python -m areal_tpu_torch.tools.perf_probe decode-bench <url> [n] [max_tokens]
    python -m areal_tpu_torch.tools.perf_probe reward-bench <exp> <trial> [n]
    python -m areal_tpu_torch.tools.perf_probe reward-bench <url> [n]
    python -m areal_tpu_torch.tools.perf_probe fleet-status <exp> <trial>
    python -m areal_tpu_torch.tools.perf_probe spool-status <exp> <trial>
    python -m areal_tpu_torch.tools.perf_probe cordon <exp> <trial> <server> [why]
    python -m areal_tpu_torch.tools.perf_probe uncordon <exp> <trial> <server>
    python -m areal_tpu_torch.tools.perf_probe drain <exp> <trial>
    python -m areal_tpu_torch.tools.perf_probe flight-dump <exp> <trial> <dir>

The commands that take ``<exp> <trial>`` find the run through name_resolve
(``AREAL_NAME_RESOLVE_ROOT`` or the repository's default root).

``scrape`` prints a worker's ``/metrics`` (Prometheus text as an aligned
table, histograms as count and mean; JSON as it is). ``decode-bench`` fires
``n`` concurrent ``/generate`` requests of mixed classes (rollout,
rollout, interactive, eval, ...) with seeded prompt lengths and budgets at
a generation server, then prints the client's tokens/s, each class's
latency and the server's own counters from ``/metrics.json``. Non-200
replies (429 admission, 413 too long, 5xx) are counted, not fatal; a
server that cannot be reached raises. ``reward-bench`` fans ``n`` seeded
math and code tasks (3:1) through the fleet client (local fallback off)
and prints the grades/s, each kind's p50 and p99 and the fleet's verdict
counters. ``fleet-status`` prints heartbeat ages and incarnations, the
control endpoints, the drain phase, the autoscale plan, the manager's
fleet map (routable, cordoned, deprioritized, draining leases) and the
``supervisor_*`` series of the merged scrape. ``spool-status`` prints each
rollout worker's spool depth, bytes and oldest unacked age and the fleet's
delivery counters, from the merged scrape. ``cordon`` (the preemption-
notice hook) and ``uncordon`` take a server id (``gen0``, ``dyn1``) or a
URL. ``drain`` runs the graceful
drain against a live run. ``flight-dump`` asks every live worker to dump
its flight-recorder ring into ``<dir>``.
"""

from __future__ import annotations

import concurrent.futures
import json
import random
import sys
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

# No proxy for any request: the fleet's URLs are its own hosts.
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))

CLASSES = ("rollout", "rollout", "interactive", "eval")


def _url(url: str) -> str:
    return url if url.startswith("http") else f"http://{url}"


def scrape(url: str) -> None:
    """Fetch and print a worker's /metrics (or /metrics.json)."""
    url = _url(url)
    if "/metrics" not in url:
        url = url.rstrip("/") + "/metrics"
    try:
        with _OPENER.open(url, timeout=10) as r:
            ctype = r.headers.get("Content-Type", "")
            body = r.read().decode()
    except OSError as e:
        sys.exit(f"scrape: cannot reach {url}: {e}\n"
                 f"(is the worker up, and telemetry enabled?)")
    if "json" in ctype:
        print(json.dumps(json.loads(body), indent=2, sort_keys=True))
        return
    rows: List[Tuple[str, Any]] = []
    hist: Dict[str, Dict[str, float]] = {}
    for line in body.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, val = line.rpartition(" ")
        base, _, labels = name.partition("{")
        labels = ("{" + labels) if labels else ""
        # histograms keyed by (family, labels): a merged scrape carries one
        # series per worker
        if base.endswith("_sum"):
            hist.setdefault(base[:-4] + labels, {})["sum"] = float(val)
        elif base.endswith("_count"):
            hist.setdefault(base[:-6] + labels, {})["count"] = float(val)
        elif base.endswith("_bucket"):
            continue  # summarised by _sum and _count
        else:
            rows.append((base + labels, float(val)))
    for h, d in sorted(hist.items()):
        n = d.get("count", 0)
        mean = (d.get("sum", 0.0) / n) if n else 0.0
        rows.append((f"{h} (hist)", f"n={n:g} mean={mean:.4g}"))
    w = max((len(r[0]) for r in rows), default=0)
    for k, v in sorted(rows):
        print(f"  {k:<{w}}  {v if isinstance(v, str) else f'{v:g}'}")


def _post(url: str, body: Dict[str, Any]) -> Tuple[int, Any]:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with _OPENER.open(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, None


def decode_bench(server_url: str, n_requests: int = 24,
                 max_tokens: int = 32) -> Dict[str, Any]:
    """A mixed-class burst of ``n_requests`` against a live generation
    server: every request at once, on a thread each. Prints and returns the
    client-side tokens/s, the non-200 replies, each class's latency (mean
    and p95) and the server's counters. Prompts of 4-48 tokens in [2, 90]
    and budgets of 4-max_tokens come from ``random.Random(0)`` in request
    order, as the reference's do."""
    url = _url(server_url).rstrip("/")
    rng = random.Random(0)
    bodies = []
    for i in range(n_requests):
        cls = CLASSES[i % len(CLASSES)]
        plen = rng.randint(4, 48)
        budget = rng.randint(4, max_tokens)
        bodies.append({
            "prompt_ids": [rng.randint(2, 90) for _ in range(plen)],
            "class": cls, "rid": f"bench{i}",
            "gconfig": {"max_new_tokens": budget, "greedy": False},
            "max_tokens": budget})

    def one(body) -> Tuple[str, Optional[float], int]:
        t0 = time.monotonic()
        status, out = _post(f"{url}/generate", body)
        if status != 200:
            # 429 backpressure, 413 too long, 5xx trouble: reported only
            return f"{body['class']}:http{status}", None, 0
        return body["class"], time.monotonic() - t0, len(out["output_ids"])

    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(max(n_requests, 1)) as pool:
        results = list(pool.map(one, bodies))
    wall = time.monotonic() - t0
    tokens = sum(n for _, _, n in results)
    errs = sorted(c for c, dt, _ in results if dt is None)
    print(f"[decode-bench] {n_requests} requests "
          f"({len(errs)} non-200: {', '.join(errs) or 'none'}), "
          f"{tokens} tokens in {wall:.2f}s -> "
          f"{tokens / max(wall, 1e-9):,.0f} tok/s")
    per_class = {}
    for cls in ("interactive", "eval", "rollout"):
        lats = sorted(dt for c, dt, _ in results
                      if c == cls and dt is not None)
        if lats:
            per_class[cls] = {
                "n": len(lats), "mean_ms": 1e3 * sum(lats) / len(lats),
                "p95_ms": 1e3 * lats[int(0.95 * (len(lats) - 1))]}
            print(f"[decode-bench] {cls:<12} n={len(lats)} "
                  f"mean={per_class[cls]['mean_ms']:.0f}ms "
                  f"p95={per_class[cls]['p95_ms']:.0f}ms")
    with _OPENER.open(f"{url}/metrics.json", timeout=10) as r:
        m = json.loads(r.read().decode())
    print(f"[decode-bench] server: tokens_per_sec={m['tokens_per_sec']:.0f} "
          f"compiled_shapes={m.get('compiled_shapes')} "
          f"kv_states={m.get('kv_states')} "
          f"queue_depth={m.get('queue_depth')} "
          f"prefill_tokens={m.get('prefill_tokens')}")
    return {"requests": n_requests, "non_200": errs, "tokens": tokens,
            "wall_s": wall, "tokens_per_s": tokens / max(wall, 1e-9),
            "per_class": per_class, "server": m}


def reward_tasks(n_tasks: int) -> List[Dict[str, Any]]:
    """The reference's seeded workload: every fourth task code (a program
    that passes or fails two cases), the rest math (right or off by one)."""
    rng = random.Random(0)
    tasks = []
    for i in range(n_tasks):
        if i % 4 == 3:
            k = rng.randint(1, 9)
            ok = rng.random() < 0.5
            code = (f"```python\nx = int(input())\nprint(x + "
                    f"{k if ok else k + 1})\n```")
            tasks.append({"task": "code", "generated": code,
                          "input_output": json.dumps({
                              "inputs": ["1\n", "2\n"],
                              "outputs": [f"{1 + k}\n", f"{2 + k}\n"]})})
        else:
            v = rng.randint(0, 999)
            guess = v if rng.random() < 0.5 else v + 1
            tasks.append({"task": "math",
                          "generated": f"\\boxed{{{guess}}}",
                          "solutions": [f"\\boxed{{{v}}}"]})
    return tasks


def _get_text(url: str) -> str:
    with _OPENER.open(url, timeout=10) as r:
        return r.read().decode()


def reward_bench(exp_or_url: str, trial: str = "",
                 n_tasks: int = 32) -> Dict[str, Any]:
    """Grade latency of a live reward fleet (found through name_resolve, or
    one worker's URL): :func:`reward_tasks` through the fleet client (16 in
    flight, retry across replicas, local fallback off: a dead fleet shows
    as 0.0 scores, never as local grading here), each kind's p50 and p99,
    then the fleet's verdict counters from the merged scrape (or each
    worker's /metrics). Prints the reference's lines and returns them."""
    import asyncio

    from areal_tpu_torch.api.train_config import RewardServiceConfig
    from areal_tpu_torch.rewards.client import RewardServiceClient
    from areal_tpu_torch.system.http import AsyncHttp

    if exp_or_url.startswith("http"):
        urls = [exp_or_url.rstrip("/")]
    else:
        from areal_tpu_torch.system.reward_worker import resolve_fleet

        urls = resolve_fleet(exp_or_url, trial)
        if not urls:
            sys.exit(f"reward-bench: no reward workers registered for "
                     f"{exp_or_url}/{trial}.\nEither the fleet is down or "
                     "the service is disabled: relaunch with "
                     "reward_service.enabled=true, or probe one worker "
                     "directly: reward-bench <url>.")
    print(f"[reward-bench] fleet: {len(urls)} worker(s)")
    tasks = reward_tasks(n_tasks)
    client = RewardServiceClient(
        RewardServiceConfig(enabled=True, local_fallback=False), urls=urls)
    lats: Dict[str, List[float]] = {"math": [], "code": []}

    async def run():
        sem = asyncio.Semaphore(16)
        session = AsyncHttp(max_workers=16)

        async def one(t):
            t0 = time.monotonic()
            s = await client.grade_one(session, t, sem)
            lats[t["task"]].append(time.monotonic() - t0)
            return s

        try:
            t0 = time.monotonic()
            scores = await asyncio.gather(*[one(t) for t in tasks])
            return scores, time.monotonic() - t0
        finally:
            session.close()

    scores, wall = asyncio.run(run())
    out: Dict[str, Any] = {"tasks": n_tasks, "wall_s": wall,
                           "grades_per_s": n_tasks / max(wall, 1e-9),
                           "mean_score": sum(scores) / max(len(scores), 1),
                           "client": dict(client.counts)}
    print(f"[reward-bench] {n_tasks} tasks in {wall:.2f}s -> "
          f"{out['grades_per_s']:.1f} grades/s, "
          f"mean score {out['mean_score']:.3f}")
    for kind in ("math", "code"):
        ls = sorted(lats[kind])
        if ls:
            p50 = ls[len(ls) // 2] * 1e3
            p99 = ls[min(int(0.99 * len(ls)), len(ls) - 1)] * 1e3
            out[kind] = {"n": len(ls), "p50_ms": p50, "p99_ms": p99}
            print(f"[reward-bench] {kind:<5} n={len(ls)} p50={p50:.1f}ms "
                  f"p99={p99:.1f}ms")
    bodies = []
    if trial:
        from areal_tpu_torch.base import name_resolve, names

        try:
            murl = name_resolve.get(names.telemetry_http(exp_or_url, trial))
            bodies = [("merged", _get_text(f"{murl}/metrics"))]
        except Exception:  # noqa: BLE001 — no aggregator: per worker
            pass
    if not bodies:
        for u in urls:
            try:
                bodies.append((u, _get_text(f"{u}/metrics")))
            except OSError as e:
                print(f"[reward-bench] scrape {u} failed: {e}")
    verdicts: Dict[str, float] = {}
    for _, body in bodies:
        for ln in body.splitlines():
            if ln.startswith("areal_reward_verdicts_total{"):
                labels, _, val = ln.rpartition(" ")
                verdicts[labels] = verdicts.get(labels, 0.0) + float(val)
    out["verdicts"] = verdicts
    if verdicts:
        src = "merged scrape" if bodies[0][0] == "merged" else "per-worker"
        print(f"[reward-bench] fleet verdicts ({src}):")
        for k, v in sorted(verdicts.items()):
            print(f"  {k} {v:g}")
    else:
        print("[reward-bench] no verdict counters scraped "
              "(telemetry disabled on the fleet?)")
    return out


def fleet_status(experiment: str, trial: str) -> None:
    """The supervision view of a live run: heartbeat ages and incarnations
    (the liveness leases), control endpoints, the drain phase, the
    manager's fleet map and the supervisor series of the merged scrape."""
    from areal_tpu_torch.base import name_resolve, names
    from areal_tpu_torch.system.worker_base import WorkerControlPanel

    panel = WorkerControlPanel(experiment, trial, timeout=2.0)
    try:
        hbs = panel.heartbeats()
        if hbs:
            print("heartbeats (liveness leases):")
            w = max(len(k) for k in hbs)
            for worker, d in sorted(hbs.items()):
                age = d.get("age_secs")
                print(f"  {worker:<{w}}  "
                      f"age={'?' if age is None else f'{age:.1f}s'}  "
                      f"incarnation={d.get('incarnation', '?')}  "
                      f"pid={d.get('pid', '?')}")
        else:
            print("no heartbeats registered (run not supervised, or "
                  "fault_tolerance.keepalive_ttl_secs=0)")
        workers = panel.list_workers()
        print(f"control endpoints: {', '.join(workers) or 'none'}")
    finally:
        panel.close()
    try:
        d = json.loads(name_resolve.get(names.drain_status(experiment,
                                                           trial)))
        at = time.strftime("%H:%M:%S", time.localtime(d.get("ts", 0)))
        print(f"drain phase: {d.get('phase')} (at {at})")
    except Exception:  # noqa: BLE001 — no drain ever requested
        print("drain phase: none")
    try:
        plan = json.loads(name_resolve.get(names.autoscale_plan(experiment,
                                                                trial)))
        print(f"autoscale plan: target={plan.get('target')} "
              f"dynamic={plan.get('dynamic')} "
              f"overloaded={plan.get('overloaded')}")
    except Exception:  # noqa: BLE001 — autoscale off / no plan yet
        print("autoscale plan: none (autoscale disabled?)")
    try:
        mgr = name_resolve.get(names.gen_server_manager(experiment, trial))
        m = json.loads(_get_text(f"{mgr.rstrip('/')}/metrics.json"))
        asc = m.get("autoscale") or {}
        print(f"fleet: {m.get('healthy_servers')}/{m.get('known_servers')} "
              f"routable, {asc.get('cordoned', 0)} cordoned"
              + (f", target {asc.get('target_size')}"
                 if asc.get("enabled") else ""))
        for u, st in sorted((m.get("fleet") or {}).items()):
            state = ("cordoned" if st.get("cordoned")
                     else "routable" if st.get("routable") else "evicted")
            extra = [st["server_id"]] if st.get("server_id") else []
            if st.get("deprioritized"):
                extra.append("deprioritized(straggler)")
            if st.get("cordoned"):
                extra.append(f"reason={st.get('cordon_reason', '?')}")
                extra.append(f"draining={st.get('draining', 0)}")
            if st.get("evicted_reason") and state == "evicted":
                extra.append(st["evicted_reason"])
            print(f"  {u}  {state}" + ("  [" + ", ".join(extra) + "]"
                                       if extra else ""))
    except Exception as e:  # noqa: BLE001 — manager down
        print(f"fleet map: manager unreachable ({e})")
    try:
        url = name_resolve.get(names.telemetry_http(experiment, trial))
        lines = [ln for ln in _get_text(f"{url.rstrip('/')}/metrics")
                 .splitlines()
                 if "areal_supervisor_" in ln and not ln.startswith("#")]
        if lines:
            print("supervisor metrics (merged scrape):")
            for ln in lines:
                print(f"  {ln}")
        else:
            print("supervisor metrics: none yet (no restarts)")
    except Exception:  # noqa: BLE001 — telemetry off / no http port
        print("supervisor metrics: merged scrape unavailable "
              "(telemetry disabled or no http_port)")


def spool_status(experiment: str, trial: str) -> Dict[str, Any]:
    """The durable spool's delivery view of a live run, from the merged
    scrape: each rollout worker's depth, bytes on disk and oldest unacked
    age, and the fleet's delivery counters. ``appended == acked`` (and depth
    0 everywhere) means every spooled trajectory settled; a growing oldest
    unacked age means the ack path is wedged. Returns what it printed."""
    import re

    from areal_tpu_torch.base import name_resolve, names

    try:
        url = name_resolve.get(names.telemetry_http(experiment, trial))
        body = _get_text(f"{url.rstrip('/')}/metrics")
    except Exception as e:  # noqa: BLE001 — no aggregator / dead run
        sys.exit(f"spool-status: cannot scrape the merged telemetry endpoint "
                 f"of {experiment}/{trial}: {e}\nIt needs "
                 "telemetry.enabled=true and telemetry.http_port on the "
                 "master. For a dead run, open the spools under "
                 "recover_dir/spool_<worker> (system/sample_spool.py).")
    lab_re = re.compile(r'(\w+)="([^"]*)"')
    gauges: Dict[str, Dict[str, float]] = {}  # worker_index -> metric
    totals: Dict[str, float] = {}
    gauge_families = {
        "areal_spool_depth": "depth", "areal_spool_bytes": "bytes",
        "areal_spool_oldest_unacked_age_secs": "oldest_unacked_s"}
    counter_families = (
        "areal_spool_appended_total", "areal_spool_acked_total",
        "areal_spool_replayed_total", "areal_spool_resent_total",
        "areal_spool_replay_stale_dropped_total",
        "areal_spool_duplicate_dropped_total",
        "areal_spool_backpressure_waits_total",
        "areal_stream_push_blocked_total",
        "areal_buffer_duplicate_dropped_total")
    for ln in body.splitlines():
        if not ln or ln.startswith("#"):
            continue
        name, _, val = ln.rpartition(" ")
        base, _, rest = name.partition("{")
        if base in gauge_families:
            w = dict(lab_re.findall(rest)).get("worker_index", "?")
            gauges.setdefault(w, {})[gauge_families[base]] = float(val)
        elif base in counter_families:
            totals[base] = totals.get(base, 0.0) + float(val)
    if not gauges and not totals:
        sys.exit("spool-status: no spool series on the merged scrape: the "
                 "spool is off (durability.enabled=false) or no rollout "
                 "worker has flushed its telemetry yet")
    if gauges:
        print("per-worker spool state:")
        print(f"  {'worker':>6}  {'depth':>7}  {'bytes':>12}  "
              f"{'oldest unacked':>14}")
        for w in sorted(gauges, key=lambda x: (len(x), x)):
            g = gauges[w]
            print(f"  {w:>6}  {g.get('depth', 0):>7g}  "
                  f"{g.get('bytes', 0):>12g}  "
                  f"{g.get('oldest_unacked_s', 0):>13.1f}s")
    if totals:
        print("fleet delivery totals:")
        width = max(len(k) for k in totals)
        for k in counter_families:
            if k in totals:
                print(f"  {k:<{width}}  {totals[k]:g}")
        appended = totals.get("areal_spool_appended_total", 0.0)
        if appended:
            in_flight = sum(g.get("depth", 0) for g in gauges.values())
            print(f"  settled {totals.get('areal_spool_acked_total', 0.0):g}"
                  f"/{appended:g} ({in_flight:g} durably queued on disk)")
    return {"workers": gauges, "totals": totals}


def cordon(experiment: str, trial: str, server: str,
           reason: str = "operator request", un: bool = False
           ) -> Dict[str, Any]:
    """Cordon (or uncordon) one generation server of a live run: the
    operator's preemption-notice hook. ``server`` is a server id (``gen0``,
    ``dyn1``) or its URL. A cordoned server gets no new lease, its rollouts
    drain, and the autoscale loop commands a drained dynamic server's exit;
    an uncordoned one re-admits through the health gate."""
    from areal_tpu_torch.base import name_resolve, names

    try:
        mgr = name_resolve.get(names.gen_server_manager(experiment, trial))
    except Exception as e:  # noqa: BLE001 — run down / wrong root
        sys.exit(f"cannot resolve the gserver manager of {experiment}/{trial}"
                 f": {e}\n(is the run up, and AREAL_NAME_RESOLVE_ROOT "
                 "pointing at its store?)")
    key = "url" if server.startswith("http") else "server_id"
    verb = "uncordon" if un else "cordon"
    status, d = _post(f"{mgr.rstrip('/')}/{verb}",
                      {key: server, "reason": reason})
    if status != 200:
        sys.exit(f"{verb} {server}: the manager said {status} ({d})")
    print(json.dumps(d, indent=2, sort_keys=True))
    if not un and d.get("ok"):
        print(f"{d.get('url')} cordoned; {d.get('draining', 0)} leases "
              f"draining (watch `fleet-status {experiment} {trial}`)")
    return d


def drain(experiment: str, trial: str) -> Dict[str, Any]:
    """The graceful drain against a live run: the launcher's SIGTERM path
    (pause, an out-of-band recover checkpoint, orderly exits)."""
    from areal_tpu_torch.system.supervisor import drain_experiment

    report = drain_experiment(experiment, trial)
    print(json.dumps(report, indent=2, sort_keys=True))
    ck = report.get("checkpoint") or {}
    res = ck.get("result") or {}
    if res.get("saved"):
        print(f"recover checkpoint: {res.get('dir')} (step {res.get('step')})")
    else:
        print("WARNING: no recover checkpoint was written "
              f"({ck.get('error') or res.get('reason') or 'master absent'})")
    return report


def flight_dump(experiment: str, trial: str, out_dir: str) -> str:
    """Ask every live worker to dump its flight-recorder ring."""
    from areal_tpu_torch.base import telemetry

    nonce = telemetry.request_flight_dump(experiment, trial, out_dir)
    print(f"flight-dump trigger {nonce} set for {experiment}/{trial}: "
          f"every worker dumps flight_<worker>.jsonl into {out_dir} "
          "within one telemetry flush interval (~2s at defaults)")
    return nonce


USAGE = """usage: python -m areal_tpu_torch.tools.perf_probe <command> ...
  scrape <url>                           print a worker's /metrics
  decode-bench <url> [n] [max_tokens]    mixed-class burst at a server
  reward-bench <exp> <trial> [n]         grade latency of a live reward fleet
  reward-bench <url> [n]                 ... of one reward worker
  fleet-status <exp> <trial>             heartbeats, drain, plan, fleet map
  spool-status <exp> <trial>             the durable spool's delivery state
  cordon <exp> <trial> <server> [why]    stop leasing to a server, drain it
  uncordon <exp> <trial> <server>        re-admit it through the health gate
  drain <exp> <trial>                    graceful drain of a live run
  flight-dump <exp> <trial> <dir>        every worker dumps its flight ring"""


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cmd = argv[0] if argv else ""
    try:
        if cmd == "scrape":
            scrape(argv[1])
        elif cmd == "decode-bench":
            decode_bench(argv[1], int(argv[2]) if len(argv) > 2 else 24,
                         int(argv[3]) if len(argv) > 3 else 32)
        elif cmd == "reward-bench" and argv[1].startswith("http"):
            reward_bench(argv[1],
                         n_tasks=int(argv[2]) if len(argv) > 2 else 32)
        elif cmd == "reward-bench":
            reward_bench(argv[1], argv[2],
                         int(argv[3]) if len(argv) > 3 else 32)
        elif cmd == "fleet-status":
            fleet_status(argv[1], argv[2])
        elif cmd == "spool-status":
            spool_status(argv[1], argv[2])
        elif cmd == "cordon":
            cordon(argv[1], argv[2], argv[3],
                   " ".join(argv[4:]) or "operator request")
        elif cmd == "uncordon":
            cordon(argv[1], argv[2], argv[3], un=True)
        elif cmd == "drain":
            drain(argv[1], argv[2])
        elif cmd == "flight-dump":
            flight_dump(argv[1], argv[2], argv[3])
        else:
            print(USAGE, file=sys.stderr)
            return 2
    except IndexError:
        print(f"missing operand for {cmd!r}\n\n{USAGE}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
