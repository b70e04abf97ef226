"""The port's sentinel (``areal_tpu_torch/system/sentinel.py``) against the
reference's (``areal_tpu/system/sentinel.py``): fed the same series on the
same fake clocks, both engines write the same alerts for threshold, rate,
baseline and absence rules, with the same cooldowns and silences; a bad
rule pack fails at parse time with the same message naming the rule; an
alert's evidence bundle has the reference's layout. No real sleeps."""

import json
import os

import pytest

from areal_tpu.api.train_config import SentinelConfig as JCfg
from areal_tpu.base import name_resolve as jnr
from areal_tpu.base import names as jnames
from areal_tpu.system import sentinel as jsn
from areal_tpu_torch.api import cli_args as CA
from areal_tpu_torch.api.train_config import SentinelConfig as TCfg
from areal_tpu_torch.base import name_resolve as tnr
from areal_tpu_torch.base import names as tnames
from areal_tpu_torch.base import telemetry as ttel
from areal_tpu_torch.system import sentinel as tsn

pytestmark = pytest.mark.sentinel

PKGS = (("ref", jsn, JCfg, jnr, jnames), ("port", tsn, TCfg, tnr, tnames))


@pytest.fixture(autouse=True)
def memory_name_resolve():
    old = (jnr.DEFAULT_REPO, tnr.DEFAULT_REPO)
    jnr.DEFAULT_REPO = jnr.MemoryNameRecordRepo()
    tnr.DEFAULT_REPO = tnr.MemoryNameRecordRepo()
    try:
        yield
    finally:
        jnr.DEFAULT_REPO, tnr.DEFAULT_REPO = old


class Stitcher:
    def recent_trace_ids(self, n):
        return ["t1", "t2", "t3"][-n:]


def make(tmp_path, name, mod, cfg_cls, rules, **cfg_kw):
    t = {"mono": 0.0, "wall": 1000.0}
    side = {"flight": [], "profile": [], "inhibit": [], "pause": 0}

    def pause():
        side["pause"] += 1

    s = mod.Sentinel(
        cfg_cls(enabled=True, eval_interval_secs=0.1, **cfg_kw), "sx", "t0",
        rules=mod.parse_rules(rules), stitcher=Stitcher(),
        alerts_path=str(tmp_path / name / "alerts.jsonl"),
        evidence_dir=str(tmp_path / name / "evidence"),
        clock=lambda: t["mono"], wall=lambda: t["wall"],
        flight_fn=side["flight"].append,
        profile_fn=lambda d, secs: side["profile"].append((d, secs)),
        inhibit_fn=side["inhibit"].append, pause_fn=pause)
    return s, t, side


def run_both(tmp_path, rules, feeds, **cfg_kw):
    """Feed both engines ``feeds`` = [(mono, worker, gauges, counters)], a
    tick after each; returns each one's alert records, rule states,
    registry and side effects."""
    out = []
    for name, mod, cfg_cls, _, _ in PKGS:
        s, t, side = make(tmp_path, name, mod, cfg_cls, rules, **cfg_kw)
        for mono, worker, gauges, counters in feeds:
            t["mono"], t["wall"] = mono, 1000.0 + mono
            if worker is not None:
                s.feed(worker, gauges, counters)
            s.tick()
        s.close()
        path = tmp_path / name / "alerts.jsonl"
        alerts = ([json.loads(x) for x in open(path)]
                  if path.exists() else [])
        for a in alerts:  # the bundle's directory differs by package
            if "evidence_dir" in a:
                a["evidence_dir"] = os.path.relpath(a["evidence_dir"],
                                                    tmp_path / name)
        out.append({"alerts": alerts, "states": s.states(),
                    "registry": s.registry.snapshot(reset=False),
                    "side": {k: (len(v) if isinstance(v, list) else v)
                             for k, v in side.items()}})
    assert out[0] == out[1]
    return out[1]


def series(metric, values, worker="trainer:0", t0=0.0, dt=1.0,
           counter=False):
    return [(t0 + i * dt, worker, {} if counter else {metric: v},
             {metric: v} if counter else {}) for i, v in enumerate(values)]


def test_threshold_pending_firing_resolved_with_cooldown(tmp_path):
    rule = {"id": "kl", "metric": "train/approx_kl", "kind": "threshold",
            "op": "gt", "value": 1.0, "for": 2, "cooldown": 5,
            "severity": "critical"}
    vals = [0.1, 2.0, 2.0, 2.5, 3.0, 0.2, 0.1, 3.0, 3.0, 3.0, 3.0, 3.0,
            3.0, 3.0]
    got = run_both(tmp_path, [rule], series(
        "train/approx_kl{mfc=actor_train}", vals))
    events = [(a["event"], a["ts"]) for a in got["alerts"]]
    assert [e for e, _ in events] == ["firing", "resolved", "firing"]
    assert got["side"]["inhibit"] == 2 and got["side"]["flight"] == 2


def test_rate_rule_on_a_counter(tmp_path):
    rule = {"id": "storm", "metric": "compile/storm_events", "kind": "rate",
            "op": "gt", "value": 0.5, "for": 1, "window": 4,
            "severity": "warn"}
    vals = [0, 0, 0, 1, 3, 6, 9, 9, 9, 9, 9]
    got = run_both(tmp_path, [rule], series("compile/storm_events", vals,
                                            counter=True))
    assert [a["event"] for a in got["alerts"]] == ["firing", "resolved"]


def test_baseline_deviation(tmp_path):
    rule = {"id": "gn", "metric": "train/grad_norm", "kind": "baseline",
            "value": 8.0, "for": 1, "window": 60, "severity": "warn"}
    vals = [1.0, 1.1, 0.9, 1.05, 0.95, 1.0, 1.02, 0.98, 1.01, 1.0, 40.0,
            45.0, 1.0, 1.0]
    got = run_both(tmp_path, [rule], series("train/grad_norm", vals))
    assert [a["event"] for a in got["alerts"]] == ["firing", "resolved"]


def test_absence_and_agg_across_workers(tmp_path):
    rules = [
        {"id": "stalled", "metric": "train/optimizer_steps",
         "kind": "absence", "for": 3, "cooldown": 100, "severity": "critical",
         "unless": "compile/inflight"},
        {"id": "mean", "metric": "rollout/inflight", "kind": "threshold",
         "op": "ge", "value": 5, "for": 1, "agg": "mean",
         "severity": "info"},
    ]
    feeds = []
    for i in range(12):
        step = min(i, 4)  # the trainer stops stepping after t=4
        feeds.append((float(i), "trainer:0", {},
                      {"train/optimizer_steps": float(step)}))
        feeds.append((float(i), "rollout:0", {"rollout/inflight": 8.0}, {}))
        feeds.append((float(i), "rollout:1", {"rollout/inflight": 4.0}, {}))
    got = run_both(tmp_path, rules, feeds)
    fired = [(a["rule"], a["event"]) for a in got["alerts"]]
    assert ("stalled", "firing") in fired and ("mean", "firing") in fired


def test_silence_suppresses_until_expiry(tmp_path):
    rule = {"id": "kl", "metric": "train/approx_kl", "kind": "threshold",
            "op": "gt", "value": 1.0, "for": 1, "cooldown": 1,
            "severity": "warn"}
    for _, _, _, nr, nm in PKGS:
        nr.add(nm.sentinel_silence("sx", "t0", "kl"),
               json.dumps({"until": 1005.5, "rule": "kl"}), replace=True)
    got = run_both(tmp_path, [rule], series("train/approx_kl",
                                            [2.0] * 10))
    assert got["alerts"][0]["event"] == "firing"
    assert got["alerts"][0]["ts"] >= 1005.5
    assert got["registry"]["counters"]["sentinel/silenced{rule=kl}"] >= 1


@pytest.mark.parametrize("bad, needle", [
    ({"id": "x", "metric": "train/aprox_kl"}, "did you mean"),
    ({"id": "x", "metric": "train/approx_kl", "for": 0}, "'for'"),
    ({"id": "x", "metric": "train/approx_kl", "for": "5 parsecs"}, "bad"),
    ({"id": "x", "metric": "train/approx_kl", "kind": "median"}, "kind"),
    ({"id": "x", "metric": "train/approx_kl", "severity": "page"},
     "severity"),
    ({"id": "x", "metric": "train/approx_kl", "kind": "baseline"},
     "value > 0"),
    ({"id": "x", "metric": "train/approx_kl", "unless": "compile/inflight"},
     "absence"),
    ({"metric": "train/approx_kl"}, "without an 'id'"),
])
def test_parse_errors_name_the_rule(bad, needle):
    msgs = []
    for _, mod, _, _, _ in PKGS:
        with pytest.raises(mod.SentinelConfigError) as e:
            mod.parse_rules([bad])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and needle in msgs[1]
    if "id" in bad:
        assert "'x'" in msgs[1]


def test_duplicate_ids_and_the_default_packs():
    rule = {"id": "d", "metric": "master/step_secs"}
    for _, mod, _, _, _ in PKGS:
        with pytest.raises(mod.SentinelConfigError, match="duplicate"):
            mod.parse_rules([rule, rule])
    assert tsn.DEFAULT_RULES == jsn.DEFAULT_RULES
    assert tsn.COMPILE_RULES == jsn.COMPILE_RULES
    assert tsn.DURABILITY_RULES == jsn.DURABILITY_RULES
    assert tsn.METRIC_CATALOG == jsn.METRIC_CATALOG
    for compile_on in (False, True):
        got = [[r.id for r in mod.rules_from_config(
            cfg(rules=[rule]), compile_watch_enabled=compile_on)]
            for _, mod, cfg, _, _ in PKGS]
        assert got[0] == got[1] and got[1][-1] == "d"


def test_cli_front_runs_the_rule_pack():
    from areal_tpu_torch.experiments.async_ppo_math_exp import (
        AsyncPPOMATHConfig,
    )

    cfg = AsyncPPOMATHConfig()
    CA.apply_overrides(cfg, [
        "telemetry.enabled=true", "sentinel.enabled=true",
        'sentinel.rules=[{"id": "op", "metric": "master/step_secs", '
        '"value": 30}]'])
    CA.validate_config(cfg)
    assert cfg.sentinel.rules[0]["id"] == "op"
    CA.apply_overrides(cfg, ['sentinel.rules=[{"id": "op", '
                             '"metric": "master/step_sec"}]'])
    with pytest.raises(CA.ConfigError, match="'op'.*did you mean"):
        CA.validate_config(cfg)
    bare = AsyncPPOMATHConfig()
    CA.apply_overrides(bare, ["sentinel.enabled=true"])
    with pytest.raises(CA.ConfigError, match="requires telemetry"):
        CA.validate_config(bare)


def test_evidence_bundle_layout(tmp_path):
    rule = {"id": "kl", "metric": "train/approx_kl", "kind": "threshold",
            "op": "gt", "value": 1.0, "for": 1, "cooldown": 1,
            "severity": "critical"}
    got = run_both(tmp_path, [rule], series("train/approx_kl",
                                            [2.0, 2.0, 0.0] * 4),
                   profile_on_critical=True, profile_secs=2.0,
                   pinned_traces=2, max_evidence_bundles=2)
    firing = [a for a in got["alerts"] if a["event"] == "firing"]
    assert len(firing) >= 3 and got["side"]["profile"] == 2
    assert "evidence_dir" not in firing[-1]  # past the cap
    assert got["registry"]["counters"]["sentinel/evidence_skipped"] >= 1
    listings = []
    for name, *_ in PKGS:
        d = tmp_path / name / firing[0]["evidence_dir"]
        alert = json.load(open(d / "alert.json"))
        traces = json.load(open(d / "traces.json"))
        listings.append((sorted(os.listdir(d)), sorted(alert),
                         alert["sources"], traces))
    assert listings[0] == listings[1]
    assert listings[1][3] == {"pinned_trace_ids": ["t2", "t3"]}
    assert listings[1][2] == {"trainer:0|train/approx_kl": 2.0}


def test_aggregator_hosts_the_sentinel(tmp_path):
    """The engine fed by the port's aggregator ingest, an alert on the
    merged scrape (areal_alerts_total, areal_alert_active) and the
    default fleet hooks: a flight-dump request and the inhibit key."""
    s = tsn.Sentinel(TCfg(enabled=True, eval_interval_secs=0.01), "sx", "h",
                     rules=tsn.parse_rules([{
                         "id": "slow", "metric": "master/step_secs",
                         "kind": "threshold", "op": "gt", "value": 1.0,
                         "for": 0.01, "severity": "critical"}]),
                     alerts_path=str(tmp_path / "alerts.jsonl"),
                     evidence_dir=str(tmp_path / "evidence"))
    agg = ttel.TelemetryAggregator("sx", "h",
                                   jsonl_path=str(tmp_path / "t.jsonl"),
                                   sentinel=s)
    try:
        for t in (1.0, 2.0):
            agg._ingest({"worker_kind": "master", "worker_index": 0,
                         "time": t, "gauges": {"master/step_secs": 5.0},
                         "counters": {}, "hists": {}, "spans": []})
            s._last_eval = None
            s.tick(now=s.clock() + t)
        text = agg.render_prometheus()
    finally:
        agg.close()
    assert 'areal_alerts_total{rule="slow",severity="critical",' \
           'worker_index="0",worker_kind="sentinel"} 1' in text
    assert 'areal_alert_active{rule="slow",worker_index="0",' \
           'worker_kind="sentinel"} 1' in text
    req = json.loads(tnr.get(tnames.flight_dump_trigger("sx", "h")))
    assert req["dir"].startswith(str(tmp_path / "evidence" / "slow-"))
    inhibit = json.loads(tnr.get(tnames.autoscale_inhibit("sx", "h")))
    assert inhibit["rule"] == "slow"
