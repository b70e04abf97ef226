"""Probes of a live fleet, from any host that can reach it.

The port's counterparts of the reference's ``tools/perf_probe.py``
``scrape`` (:195) and ``decode_bench`` (:245), on the standard library
(``urllib`` on a thread pool: the card's machine has no ``aiohttp``)::

    python -m areal_tpu_torch.tools.perf_probe scrape <url>
    python -m areal_tpu_torch.tools.perf_probe decode-bench <url> [n] [max_tokens]

``scrape`` prints a worker's ``/metrics`` (Prometheus text as an aligned
table, histograms as count and mean; JSON as it is). ``decode-bench`` fires
``n`` concurrent ``/generate`` requests of mixed classes (rollout,
rollout, interactive, eval, ...) with seeded prompt lengths and budgets at
a generation server, then prints the client's tokens/s, each class's
latency and the server's own counters from ``/metrics.json``. Non-200
replies (429 admission, 413 too long, 5xx) are counted, not fatal; a
server that cannot be reached raises.
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


USAGE = """usage: python -m areal_tpu_torch.tools.perf_probe <command> ...
  scrape <url>                           print a worker's /metrics
  decode-bench <url> [n] [max_tokens]    mixed-class burst at a server"""


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) >= 2 and argv[0] == "scrape":
        scrape(argv[1])
        return 0
    if len(argv) >= 2 and argv[0] == "decode-bench":
        decode_bench(argv[1], int(argv[2]) if len(argv) > 2 else 24,
                     int(argv[3]) if len(argv) > 3 else 32)
        return 0
    print(USAGE, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
