"""The port's goodput ledger (``areal_tpu_torch/system/goodput.py``) against
the reference's (``areal_tpu/system/goodput.py``): the same transitions on
a fake clock give the same totals and the same exported counters; the same
counter feeds give the same fleet gauges; ``MfuEmitter`` sets the same
gauges; ``resolve_peak_flops`` reads the card's name. No real sleeps."""

import pytest

from areal_tpu.base import telemetry as jtel
from areal_tpu.system import goodput as jgp
from areal_tpu_torch.api.train_config import GoodputConfig
from areal_tpu_torch.base import telemetry as ttel
from areal_tpu_torch.system import goodput as tgp

pytestmark = pytest.mark.goodput


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class Sink:
    """A Telemetry-like sink over a registry."""

    enabled = True

    def __init__(self, mod):
        self.registry = mod.TelemetryRegistry()

    def inc(self, name, n=1.0):
        self.registry.inc(name, n)

    def set_gauge(self, name, v):
        self.registry.set_gauge(name, v)


# (advance the clock by, then call) on a wall-partition ledger
_SCRIPT = (
    (0.5, ("enter", "data_wait")),
    (1.25, ("enter", "compute")),
    (0.25, ("add_overlap", "comm", 0.5)),
    (2.0, ("poll",)),
    (0.75, ("enter", "comm")),
    (0.125, ("enter", "idle")),
    (3.0, ("add", "compute", 0.375)),
    (0.0, ("flush",)),
)


def _run(mod, interval, initial="idle"):
    clock, sink = Clock(), Sink(jtel if mod is jgp else ttel)
    led = mod.GoodputLedger(sink, clock=clock, export_interval_secs=interval,
                            initial_state=initial)
    for dt, (op, *args) in _SCRIPT:
        clock.t += dt
        getattr(led, op)(*args)
    return led, sink.registry.snapshot(reset=False)["counters"]


@pytest.mark.parametrize("interval", [0.0, 1.0, 100.0])
@pytest.mark.parametrize("initial", ["idle", None])
def test_ledger_totals_and_exports_match(interval, initial):
    (jl, jc), (tl, tc) = _run(jgp, interval, initial), _run(tgp, interval,
                                                           initial)
    assert tl.totals() == jl.totals()
    assert tc == jc
    if initial is not None:
        # the wall partition: the states sum to the wall clock since the
        # ledger's origin (the add()ed 0.375 aside)
        wall = sum(dt for dt, _ in _SCRIPT)
        assert sum(tl.totals().values()) == pytest.approx(wall + 0.375)
        assert tl._t_cur - tl.t_start == pytest.approx(wall)
    assert tc["goodput/overlap_secs{state=comm}"] == 0.5


def test_make_ledger_disabled_contract():
    sink = Sink(ttel)
    assert tgp.make_ledger(None, sink) is tgp.NULL_LEDGER
    assert tgp.make_ledger(GoodputConfig(), sink) is tgp.NULL_LEDGER
    assert tgp.make_ledger(GoodputConfig(enabled=True), ttel.NULL) \
        is tgp.NULL_LEDGER
    led = tgp.make_ledger(GoodputConfig(enabled=True,
                                        export_interval_secs=5.0), sink,
                          initial_state=None)
    assert led.enabled and led._interval == 5.0
    with tgp.NULL_LEDGER.state("compute"):
        pass
    assert tgp.NULL_LEDGER.totals() == {}


def _feed(mod):
    clock = Clock()
    fleet = mod.FleetGoodput(window_secs=10.0, expiry_secs=20.0, clock=clock)
    out = []
    feeds = (
        (0.0, "trainer:0", {"compute": 1.0, "idle": 1.0}),
        (0.0, "generation_server:0", {"compute": 3.0, "idle": 1.0}),
        (1.0, "rollout:0", {"comm": 5.0, "data_wait": 2.0}),
        (4.0, "trainer:0", {"compute": 4.0, "idle": 2.0, "comm": 1.0}),
        (8.0, "generation_server:0", {"compute": 9.0, "idle": 3.0}),
        # a counter reset: the worker restarted
        (1.0, "trainer:0", {"compute": 0.5, "idle": 0.5}),
        # the server stops reporting and expires
        (25.0, "trainer:0", {"compute": 3.0, "idle": 0.5}),
        (0.0, "master:0", {}),
    )
    for dt, worker, totals in feeds:
        clock.t += dt
        out.append(fleet.update(worker, {
            f"goodput/secs{{state={s}}}": v for s, v in totals.items()}))
        out.append(fleet.gauges())
    return out


def test_fleet_goodput_gauges_match():
    got, want = _feed(tgp), _feed(jgp)
    assert got == want
    # the expired server's side is withdrawn, not pinned
    assert "fleet/goodput{side=generation}" not in got[-1]
    assert got[1]["fleet/goodput{side=trainer}"] == 0.5


@pytest.mark.parametrize("peak", [989e12, None])
def test_mfu_emitter_matches(peak):
    outs = []
    for mod, tel in ((jgp, jtel), (tgp, ttel)):
        sink = Sink(tel)
        em = mod.MfuEmitter(sink, peak, tflops_name="train/achieved_tflops",
                            mfu_name="train/mfu", context="trainer")
        for f in (0.0, 2.5e14, -1.0, 1e14):
            em.emit(f)
        outs.append(sink.registry.snapshot(reset=False)["gauges"])
    assert outs[0] == outs[1]
    assert outs[1]["train/achieved_tflops"] == 100.0
    assert ("train/mfu" in outs[1]) == (peak is not None)


def test_resolve_peak_flops():
    cfg = GoodputConfig()
    assert tgp.resolve_peak_flops(cfg, "NVIDIA H100 80GB HBM3") == 989e12
    assert tgp.resolve_peak_flops(cfg, "NVIDIA H100 PCIe") == 756e12
    assert tgp.resolve_peak_flops(cfg, "cpu") is None
    assert tgp.resolve_peak_flops(cfg, "TPU v5 lite") is None
    over = GoodputConfig(peak_flops_override=123e12)
    assert tgp.resolve_peak_flops(over, "NVIDIA H100 80GB HBM3") == 123e12
    assert tgp.resolve_peak_flops(over, "cpu") == 123e12
