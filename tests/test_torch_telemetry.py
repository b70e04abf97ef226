"""The port's telemetry layer (``areal_tpu_torch/base/telemetry.py``) against
the reference's (``areal_tpu/base/telemetry.py``) on the same inputs.

 - ``render_prometheus`` is byte-identical for the same registry operations;
 - one pusher payload fed to both aggregators' ``_ingest`` gives the same
   ``merged()`` state and the same merged scrape;
 - the port's pusher reaches the port's aggregator over TCP: lazy
   discovery, the one pending snapshot when the socket is backlogged, and
   the plain-HTTP ``/metrics`` advertised under ``names.telemetry_http``;
 - trace headers and payloads are equal between the packages;
 - ``TraceStitcher`` writes the same lines after span ids are normalised;
 - flight dumps (the recorder, the fan-out trigger) and the profiler
   trigger (``torch.profiler`` on the CPU);
 - the disabled contract: no thread, socket, server or name-resolve key.

Every wait is bounded; nothing sleeps to let time pass.
"""

import copy
import json
import os
import threading
import time
import urllib.request

import pytest

from areal_tpu.base import name_resolve as jnr
from areal_tpu.base import telemetry as jtel
from areal_tpu_torch.api.train_config import TelemetryConfig
from areal_tpu_torch.base import name_resolve as tnr
from areal_tpu_torch.base import names as tnames
from areal_tpu_torch.base import telemetry as ttel

pytestmark = pytest.mark.telemetry

_NO_PROXY = urllib.request.build_opener(urllib.request.ProxyHandler({}))


@pytest.fixture(autouse=True)
def memory_name_resolve():
    old = (jnr.DEFAULT_REPO, tnr.DEFAULT_REPO)
    jnr.DEFAULT_REPO = jnr.MemoryNameRecordRepo()
    tnr.DEFAULT_REPO = tnr.MemoryNameRecordRepo()
    try:
        yield
    finally:
        jnr.DEFAULT_REPO, tnr.DEFAULT_REPO = old


class _Stuck:
    """A pusher socket whose sends raise ``exc`` (a socket's own methods
    are read-only)."""

    def __init__(self, sock, exc):
        self.sock, self.exc = sock, exc

    def send(self, _data):
        raise self.exc

    def close(self):
        self.sock.close()


def _wait(cond, secs: float = 10.0) -> bool:
    deadline = time.monotonic() + secs
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


# A sequence of registry operations: counters (inline labels and special
# characters in label values), labelled gauges, histograms on default and
# custom buckets, and spans (which also land in duration histograms).
_OPS = (
    ("inc", "gsmgr/evictions", 1.0),
    ("inc", "supervisor/restarts{worker_kind=rollout}", 2.0),
    ("inc", "supervisor/restarts{worker_kind=trainer}", 1.0),
    ("inc", "a/b-c.d", 0.5),
    ("set_gauge", "hbm/bytes_in_use{device=0}", 1.5e9),
    ("set_gauge", "hbm/limit_bytes{device=0}", 8.0e10),
    ("set_gauge", "train/grad_norm{mfc=actor_train}", 3.25),
    ("set_gauge", 'weird/label{note=a"b\\c}', 7.0),
    ("set_gauge", "9lives", 1.0),
    ("observe", "rollout/chunk_secs", 0.003),
    ("observe", "rollout/chunk_secs", 0.7),
    ("observe", "rollout/chunk_secs", 500.0),
    ("observe_b", "rollout/staleness_lag", 2.0),
    ("observe_b", "rollout/staleness_lag", 17.0),
)


def _apply(reg, ops):
    for op, name, v in ops:
        if op == "observe_b":
            reg.observe(name, v, buckets=(0.0, 1.0, 2.0, 4.0, 8.0, 16.0))
        else:
            getattr(reg, op)(name, v)


def _fixed_spans(snapshot):
    """Span durations and start times vary by run; the histograms they feed
    are rebuilt from one fixed duration so snapshots compare."""
    snap = copy.deepcopy(snapshot)
    for k, h in snap["hists"].items():
        if k.endswith("/secs"):
            h["sum"] = 0.125 * h["count"]
            h["counts"] = [0] * len(h["counts"])
            h["counts"][4] = h["count"]
    return snap


@pytest.mark.parametrize("n_ops", [0, 4, 9, len(_OPS)])
@pytest.mark.parametrize("labels", [None, {"server_id": "gen0"}])
def test_render_prometheus_byte_identical(n_ops, labels):
    outs = []
    for mod in (jtel, ttel):
        reg = mod.TelemetryRegistry()
        _apply(reg, _OPS[:n_ops])
        with reg.span("genserver/decode_chunk", batch_size=3):
            pass
        outs.append(mod.render_prometheus(
            _fixed_spans(reg.snapshot(reset=False)),
            extra_gauges={"genserver_weight_version": 3,
                          "genserver_inflight": True, "skipped": None,
                          "also_skipped": "text"},
            labels=labels))
    assert outs[0] == outs[1]
    assert "# TYPE areal_genserver_weight_version gauge" in outs[1]


def _payload():
    reg = ttel.TelemetryRegistry()
    _apply(reg, _OPS)
    reg.inc("goodput/secs{state=compute}", 4.0)
    reg.inc("goodput/secs{state=idle}", 1.0)
    reg.inc("compile/secs{fn=flash_attention}", 6.5)
    ctx = ttel.TraceContext("feedc0de00000001", "rollout:0/7")
    reg.add_span("trainer/train_sample", 1000.0, 0.5, trace=ctx,
                 sample_id="q1@0", weight_version=2)
    reg.add_span("trainer/mfc", 999.0, 2.0, mfc="actor_train")
    return {"worker_kind": "trainer", "worker_index": 0, "time": 1234.5,
            **reg.snapshot(reset=True)}


def test_aggregators_ingest_the_same_state(tmp_path):
    from areal_tpu.system.goodput import FleetGoodput as JFleet
    from areal_tpu_torch.system.goodput import FleetGoodput as TFleet

    aggs = [
        mod.TelemetryAggregator(
            "exp", f"agg_{name}", jsonl_path=str(tmp_path / name / "t.jsonl"),
            stitch_grace_secs=0.0, goodput=fleet(clock=lambda: 50.0))
        for name, mod, fleet in (("ref", jtel, JFleet), ("port", ttel, TFleet))]
    try:
        payload = _payload()
        for agg in aggs:
            agg._ingest(copy.deepcopy(payload))
            agg.stitcher.tick(force=True)
        merged = [agg.merged() for agg in aggs]
        assert merged[0] == merged[1]
        # derived hbm utilization joined the gauges
        assert merged[1]["trainer:0"]["gauges"][
            "hbm/utilization{device=0}"] == 1.5e9 / 8.0e10
        scrapes = [agg.render_prometheus() for agg in aggs]
        assert scrapes[0] == scrapes[1]
        assert 'areal_fleet_goodput{side="trainer",worker_index="0",' \
               'worker_kind="fleet"} 0.8' in scrapes[1]
        assert "areal_compile_secs_total" in scrapes[1]
    finally:
        for agg in aggs:
            agg.close()
    lines = [open(tmp_path / name / "traces.jsonl").read()
             for name in ("ref", "port")]
    assert lines[0] == lines[1] and lines[1].count("\n") == 1


def test_pusher_to_aggregator_over_tcp(tmp_path):
    from areal_tpu_torch.base.network import find_free_port

    reg = ttel.TelemetryRegistry()
    pusher = ttel.TelemetryPusher(reg, "exp", "tcp", "trainer", 0,
                                  flush_interval_secs=3600)
    agg = None
    try:
        reg.inc("a")
        with reg.span("s1"):
            pass
        # lazy discovery: no aggregator yet, nothing drained
        assert not pusher.flush()
        assert len(reg.snapshot(reset=False)["spans"]) == 1
        port = find_free_port()
        agg = ttel.TelemetryAggregator(
            "exp", "tcp", jsonl_path=str(tmp_path / "t.jsonl"), http_port=port)
        assert pusher.flush()
        assert _wait(lambda: "trainer:0" in agg.merged())
        assert agg.merged()["trainer:0"]["n_spans"] == 1
        # a backlogged socket: the snapshot stays pending and the registry
        # is not drained again until it goes out
        sock = pusher._sock
        pusher._sock = _Stuck(sock, BlockingIOError())
        with reg.span("s2"):
            pass
        assert not pusher.flush()
        pending = pusher._pending
        assert pending is not None
        with reg.span("s3"):
            pass
        assert not pusher.flush()
        assert pusher._pending is pending  # not replaced, not drained again
        assert [s["name"] for s in reg.snapshot(reset=False)["spans"]] \
            == ["s3"]
        pusher._sock = sock
        assert pusher.flush()  # the pending one, then a fresh one
        assert _wait(lambda: agg.merged()["trainer:0"]["n_spans"] == 3)
        # the merged scrape over plain HTTP, advertised for tools
        url = tnr.get(tnames.telemetry_http("exp", "tcp"))
        assert url.endswith(f":{port}")
        with _NO_PROXY.open(url + "/metrics", timeout=10) as r:
            body = r.read().decode()
        assert body == agg.render_prometheus()
        assert 'areal_a_total{worker_index="0",worker_kind="trainer"} 1' \
            in body
    finally:
        pusher.close()
        if agg is not None:
            agg.close()
    assert not any(t.name.startswith("telemetry")
                   for t in threading.enumerate())
    with pytest.raises(tnr.NameEntryNotFoundError):
        tnr.get(tnames.telemetry_aggregator("exp", "tcp"))


def test_pusher_resends_whole_after_a_broken_connection(tmp_path):
    reg = ttel.TelemetryRegistry()
    pusher = ttel.TelemetryPusher(reg, "exp", "brk", "rollout", 1,
                                  flush_interval_secs=3600)
    agg = ttel.TelemetryAggregator("exp", "brk",
                                   jsonl_path=str(tmp_path / "t.jsonl"))
    try:
        with reg.span("lost_once"):
            pass

        assert pusher._connect()
        pusher._sock = _Stuck(pusher._sock, ConnectionResetError())
        assert not pusher.flush()
        assert pusher._sock is None and pusher._pending is not None
        assert pusher.flush()  # reconnects and sends it whole
        assert _wait(lambda: agg.merged().get("rollout:1", {})
                     .get("n_spans") == 1)
    finally:
        pusher.close()
        agg.close()


@pytest.mark.parametrize("parent", [None, "rollout:0/3"])
def test_trace_headers_and_payloads_equal(parent):
    outs = []
    for mod in (jtel, ttel):
        sink = mod.configure("exp", "t", "rollout", 0,
                             cfg=_cfg(mod), push=False)
        try:
            with mod.trace_scope(mod.TraceContext("0123456789abcdef", parent)):
                h = mod.inject_headers()
                p = mod.inject_payload({"x": 1})
                with mod.span("rollout/generate"):
                    h_open = mod.inject_headers()
            outs.append({
                "headers": h, "payload": p,
                "open_parent": h_open[mod.TRACE_HEADER].split(";")[1]
                .split("/")[0],
                "extracted": [
                    (c.trace_id, c.parent_span) if c else None
                    for c in (mod.extract_headers(h),
                              mod.extract_headers({mod.TRACE_HEADER: ";x"}),
                              mod.extract_headers(None),
                              mod.extract_payload(dict(p)),
                              mod.extract_payload([1]))],
                "off": None,
            })
        finally:
            mod.shutdown()
        # disabled: nothing injected, the payload untouched
        with mod.trace_scope(mod.TraceContext("0123456789abcdef", parent)):
            outs[-1]["off"] = (mod.inject_headers(),
                               mod.inject_payload({"x": 1}))
        assert sink.enabled
    assert outs[0] == outs[1]
    assert outs[1]["off"] == ({}, {"x": 1})


def _cfg(mod):
    if mod is jtel:
        from areal_tpu.api.train_config import TelemetryConfig as JCfg

        return JCfg(enabled=True)
    return TelemetryConfig(enabled=True)


def _normalised(lines):
    """Stitched trace lines with per-process span ids (and the remote
    parent refs naming them) renumbered in order of appearance."""
    out = []
    for line in lines:
        d = json.loads(line)
        ids = {}
        for s in d["spans"]:
            ids.setdefault((s["worker"], s["span_id"]), len(ids) + 1)
        for s in d["spans"]:
            s["span_id"] = ids[(s["worker"], s["span_id"])]
            if s["parent_id"] is not None:
                s["parent_id"] = ids.get((s["worker"], s["parent_id"]), -1)
            if "remote_parent" in s:
                w, _, sid = s["remote_parent"].partition("/")
                s["remote_parent"] = ids.get((w, int(sid)), -1)
        out.append(d)
    return out


def test_trace_stitcher_lines_equal(tmp_path):
    lines = []
    for name, mod in (("ref", jtel), ("port", ttel)):
        workers = {k: mod.TelemetryRegistry()
                   for k in ("rollout:0", "generation_server:0", "trainer:0")}
        ctx = mod.TraceContext("ab" * 8)
        roll = workers["rollout:0"]
        rid = roll.add_span("rollout/rollout", 100.0, 9.0, trace=ctx)
        roll.add_span("rollout/gate", 100.0, 0.5, trace=ctx, parent_id=rid)
        gid = roll.add_span("rollout/generate", 100.5, 4.0, trace=ctx,
                            parent_id=rid)
        remote = mod.TraceContext(ctx.trace_id, f"rollout:0/{gid}")
        gen = workers["generation_server:0"]
        gen.add_span("genserver/queue_wait", 100.6, 0.25, trace=remote)
        gen.add_span("genserver/decode", 101.0, 3.0, trace=remote)
        workers["trainer:0"].add_span(
            "trainer/train_sample", 120.0, 2.0, trace=ctx, sample_id="q@0",
            weight_version=1)
        st = mod.TraceStitcher(str(tmp_path / name / "traces.jsonl"),
                               grace_secs=0.0)
        for w in ("rollout:0", "generation_server:0", "trainer:0"):
            st.feed(w, workers[w].snapshot(reset=True)["spans"])
        st.tick(force=True)
        reg = st.registry.snapshot(reset=False)
        st.close()
        lines.append(open(tmp_path / name / "traces.jsonl").readlines())
        assert reg["counters"]["trace/stitched"] == 1.0
        assert reg["hists"]["trace/stage_train_wait_secs"]["sum"] == 11.0
    assert _normalised(lines[0]) == _normalised(lines[1])
    assert len(lines[1]) == 1


def test_flight_recorder_dump_matches(tmp_path):
    recs = [{"name": "a", "v": 1}, {"name": "b", "attrs": {"x": [1, 2]}}]
    dumps = []
    for name, mod in (("ref", jtel), ("port", ttel)):
        fr = mod.FlightRecorder(maxlen=2)
        fr.record("event", {"name": "dropped"})
        for r in recs:
            fr.record("span", r)
        path = tmp_path / name / "flight.jsonl"
        assert fr.dump(str(path), reason="test") == 2
        lines = [json.loads(x) for x in open(path)]
        lines[-1].pop("time")
        dumps.append(lines)
    assert dumps[0] == dumps[1]


def test_flight_dump_trigger_fans_out(tmp_path):
    cfg = TelemetryConfig(enabled=True, flight_recorder_len=8)
    workers = [ttel.Telemetry("exp", "fl", kind, 0, cfg=cfg)
               for kind in ("trainer", "rollout")]
    try:
        for w in workers:
            w.event("checkpoint", step=1)
            assert w.pusher.check_flight_trigger() is None  # no request yet
        out = tmp_path / "dumps"
        nonce = ttel.request_flight_dump("exp", "fl", str(out))
        paths = [w.pusher.check_flight_trigger() for w in workers]
        assert sorted(os.path.basename(p) for p in paths) == [
            "flight_rollout0.jsonl", "flight_trainer0.jsonl"]
        for p in paths:
            lines = [json.loads(x) for x in open(p)]
            assert lines[0]["name"] == "checkpoint"
            assert lines[-1]["reason"] == f"trigger:{nonce}"
        # once per nonce: the flag is not consumed, not replayed either
        assert all(w.pusher.check_flight_trigger() is None for w in workers)
    finally:
        for w in workers:
            w.close()


def test_profiler_trigger_captures_a_chrome_trace(tmp_path):
    import torch

    out = tmp_path / "prof"
    watcher = ttel.ProfilerTriggerWatcher("exp", "prof", poll_secs=0.0)
    watcher.poll()
    assert not watcher.capturing and \
        ttel.read_profiler_status("exp", "prof") is None
    ttel.request_profiler_capture("exp", "prof", str(out), secs=0.0)
    watcher.poll()
    assert watcher.capturing
    assert ttel.read_profiler_status("exp", "prof")["state"] == "capturing"
    # a second request waits while one capture runs
    ttel.request_profiler_capture("exp", "prof", str(tmp_path / "p2"), secs=0)
    torch.ones(8).sum()
    watcher.poll()
    assert not watcher.capturing
    st = ttel.read_profiler_status("exp", "prof")
    assert st["state"] == "done" and st["dir"] == str(out)
    (trace,) = list(out.glob("trace_*.json"))
    assert json.load(open(trace))["traceEvents"]
    watcher.poll()  # the waiting request starts now
    assert watcher.capturing
    watcher.poll()
    assert list((tmp_path / "p2").glob("trace_*.json"))


def test_disabled_starts_nothing():
    before = set(threading.enumerate())
    sink = ttel.configure("exp", "off", "trainer", 0,
                          cfg=TelemetryConfig(enabled=False))
    assert sink is ttel.NULL and not ttel.enabled()
    ttel.inc("x")
    ttel.set_gauge("y", 1.0)
    ttel.observe("z", 1.0)
    with ttel.span("s") as attrs:
        attrs["k"] = 1
    assert ttel.add_span("s", 0.0, 1.0) == 0
    assert ttel.get().snapshot()["spans"] == []
    with ttel.start_trace() as ctx:
        assert ctx is None and ttel.inject_headers() == {}
    assert set(threading.enumerate()) == before
    with pytest.raises(tnr.NameEntryNotFoundError):
        tnr.get(tnames.telemetry_aggregator("exp", "off"))


def test_dump_trace_per_mfc(tmp_path):
    """``AREAL_DUMP_TRACE``: one MFC under its own torch.profiler capture,
    a Chrome trace under ``<dir>/<mfc>_<version>``."""
    import torch

    from areal_tpu_torch.system.trainer_worker import (
        TrainerWorker,
        TrainerWorkerConfig,
    )

    w = TrainerWorker(TrainerWorkerConfig(device="cpu"))
    w.device = torch.device("cpu")
    out = w._profiled_mfc(str(tmp_path / "actor_train_3"),
                          lambda a, b: (a @ b).sum(), torch.ones(4, 4),
                          torch.ones(4, 4))
    assert out.item() == 64.0
    events = json.load(open(tmp_path / "actor_train_3" / "trace.json"))[
        "traceEvents"]
    assert any("matmul" in str(ev.get("name")) for ev in events)
