"""The port's device-memory watch (``areal_tpu_torch/system/memwatch.py``)
against the reference's (``areal_tpu/system/memwatch.py``): the PyTorch
allocator's keys map onto the reference's gauges (``allocated_bytes.all.
current`` → ``hbm/bytes_in_use``, ``allocated_bytes.all.peak`` →
``hbm/peak_bytes``, the card's total → ``hbm/limit_bytes``), watermarks and
the rate limit behave alike on a fake clock, and without a card the watch
degrades once to the counter and exports no gauge. The kernel-build watch
(``areal_tpu_torch/base/compile_watch.py``) records each library's build
and load."""

import pytest
import torch

from areal_tpu.base import telemetry as jtel
from areal_tpu.system import memwatch as jmw
from areal_tpu_torch.api.train_config import CompileWatchConfig
from areal_tpu_torch.base import telemetry as ttel
from areal_tpu_torch.system import memwatch as tmw

pytestmark = pytest.mark.compilewatch


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class Sink:
    enabled = True

    def __init__(self, mod):
        self.registry = mod.TelemetryRegistry()

    def inc(self, name, n=1.0):
        self.registry.inc(name, n)

    def set_gauge(self, name, v):
        self.registry.set_gauge(name, v)

    def gauges(self):
        return self.registry.snapshot(reset=False)["gauges"]

    def counters(self):
        return self.registry.snapshot(reset=False)["counters"]


class JaxLikeDevice:
    """The reference's device: jax's ``memory_stats()`` keys."""

    def __init__(self, reading):
        self.reading = reading

    def memory_stats(self):
        cur, peak, total = self.reading
        return {"bytes_in_use": cur, "peak_bytes_in_use": peak,
                "bytes_limit": total}


@pytest.fixture
def fake_allocator(monkeypatch):
    """torch.cuda's statistics for device 0 from ``reading`` (current,
    peak, total) — what a card reports."""
    reading = [1 << 30, 3 << 30, 80 << 30]

    def memory_stats(index):
        assert index == 0
        return {"allocated_bytes.all.current": reading[0],
                "allocated_bytes.all.peak": reading[1],
                "reserved_bytes.all.current": reading[1] + 7}

    def mem_get_info(index):
        assert index == 0
        return (reading[2] - reading[0], reading[2])

    monkeypatch.setattr(torch.cuda, "memory_stats", memory_stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    return reading


def test_cuda_device_maps_to_the_reference_keys(fake_allocator):
    dev = tmw.CudaDevice(0)
    assert dev.memory_stats() == {
        "bytes_in_use": float(1 << 30), "peak_bytes_in_use": float(3 << 30),
        "bytes_limit": float(80 << 30)}


def test_gauges_and_watermarks_match_the_reference(fake_allocator):
    """One device at index 0: the same readings through both watches give
    the same gauges, watermarks and peaks."""
    watches = []
    for mod, tel, devices in (
            (jmw, jtel, lambda: [JaxLikeDevice(tuple(fake_allocator))]),
            (tmw, ttel, lambda: [tmw.CudaDevice(0)])):
        clock, sink = Clock(), Sink(tel)
        watches.append((mod.MemWatch(sink, sample_interval_secs=10.0,
                                     devices_fn=devices, clock=clock),
                        clock, sink))
    for step in range(4):
        fake_allocator[0] = (step + 1) << 30
        fake_allocator[1] = max(fake_allocator[1], (2 * step + 1) << 30)
        outs = []
        for w, clock, sink in watches:
            clock.t += 4.0
            top = w.sample()  # rate-limited: every 10 s of the fake clock
            with w.watermark("trainer/weight_publish"):
                pass
            outs.append((top, sink.gauges(), w.site_peaks(), w.peak_gb()))
        assert outs[0] == outs[1]
    gauges = outs[1][1]
    assert gauges["hbm/bytes_in_use{device=0}"] == 4 << 30
    assert gauges["hbm/peak_bytes{device=0}"] == 7 << 30
    assert gauges["hbm/limit_bytes{device=0}"] == 80 << 30
    assert gauges["hbm/watermark_bytes{site=trainer/weight_publish}"] \
        == 4 << 30


def test_degrades_once_without_a_card(caplog):
    """On the CPU the default devices are none: one warning, the counter
    once, no gauge — as the reference on a device without statistics."""
    assert not torch.cuda.is_initialized()
    outs = []
    for mod, tel, devices in ((jmw, jtel, lambda: []),
                              (tmw, ttel, tmw._default_devices)):
        sink = Sink(tel)
        w = mod.MemWatch(sink, sample_interval_secs=0.0, devices_fn=devices)
        for _ in range(3):
            assert w.sample() is None
            with w.watermark("train/fwd_bwd"):
                pass
        outs.append((sink.gauges(), sink.counters(), w.peak_gb()))
    assert outs[0] == outs[1] == (
        {}, {"hbm/memory_stats_unavailable": 1.0}, 0.0)
    assert sum("degraded" in r.getMessage() for r in caplog.records
               if r.name.startswith("areal_tpu_torch")) == 1


def test_configure_disabled_contract():
    sink = Sink(ttel)
    assert tmw.configure(None, sink) is tmw.NULL
    assert tmw.configure(CompileWatchConfig(), sink) is tmw.NULL
    with tmw.watermark("x"):
        pass
    assert tmw.sample() is None and sink.gauges() == {}
    w = tmw.configure(CompileWatchConfig(enabled=True,
                                         mem_sample_interval_secs=2.5), sink)
    try:
        assert tmw.get() is w and w.sample_interval_secs == 2.5
    finally:
        tmw.shutdown()
    assert tmw.get() is tmw.NULL


# ---------------- the kernel-build watch (base/compile_watch.py) ----------


def test_compile_watch_records_builds_and_cache_hits():
    from areal_tpu_torch.base import compile_watch as cw

    clock, sink = Clock(), Sink(ttel)
    w = cw.CompileWatch(sink, clock=clock)
    with w.compiling("flash_attention", "aaaa") as fwd:
        with w.compiling("flash_attention_bwd", "bbbb") as bwd:
            assert w.inflight() and sink.gauges()["compile/inflight"] == 2.0
            fwd["cache_hit"], bwd["cache_hit"] = True, False
            clock.t += 12.5
    assert not w.inflight() and sink.gauges()["compile/inflight"] == 0.0
    with pytest.raises(RuntimeError):  # a failed build is recorded too
        with w.compiling("flash_attention_bwd", "cccc"):
            clock.t += 1.0
            raise RuntimeError("nvcc failed")
    c = sink.counters()
    assert c["compile/events{fn=flash_attention}"] == 1.0
    assert c["compile/events{fn=flash_attention_bwd}"] == 2.0
    assert c["compile/secs{fn=flash_attention}"] == 12.5
    assert c["compile/secs{fn=flash_attention_bwd}"] == 13.5
    assert c["compile/cache_hits"] == 1.0 and c["compile/cache_misses"] == 1.0
    assert sink.gauges()["compile/distinct_shapes{fn=flash_attention}"] \
        == 1.0
    assert sink.gauges()["compile/distinct_shapes{fn=flash_attention_bwd}"] \
        == 2.0


def test_kernel_build_goes_through_the_watch(monkeypatch):
    """The flash-attention libraries' first use builds under the process's
    watch: one watched compile per source, named by its stem (here the
    build fails, as it does without nvcc, and is recorded all the same)."""
    from areal_tpu_torch.base import compile_watch as cw
    from areal_tpu_torch.ops import flash_attention as fa

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(fa, "build_libraries", no_nvcc)
    monkeypatch.setattr(fa, "_libs", {})
    sink = Sink(ttel)
    cw.configure(CompileWatchConfig(enabled=True), sink)
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            fa._library("fwd")
    finally:
        cw.shutdown()
    c = sink.counters()
    assert c["compile/events{fn=flash_attention}"] == 1.0
    assert c["compile/events{fn=flash_attention_bwd}"] == 1.0
    assert sink.gauges()["compile/inflight"] == 0.0
    assert cw.get() is cw.NULL and not cw.inflight()
