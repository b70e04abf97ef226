"""Device-memory observatory: memory gauges + per-site high-water marks.

The port's copy of ``areal_tpu/system/memwatch.py`` over PyTorch's CUDA
caching allocator:

 - :meth:`MemWatch.sample` reads each device's statistics (rate-limited
   to ``sample_interval_secs``; piggybacked on existing worker cadences —
   the trainer's serve loop, the generation server's metrics endpoint —
   so no thread is spawned) and exports per-device
   ``hbm/bytes_in_use{device=i}``, ``hbm/peak_bytes{device=i}`` and
   ``hbm/limit_bytes{device=i}`` gauges.
 - :meth:`MemWatch.watermark` brackets the big allocators (weight publish
   and consume, the trainer's fwd/bwd) and records the max
   ``bytes_in_use`` observed at block exit as
   ``hbm/watermark_bytes{site=...}``.

The reference reads its devices' ``memory_stats()``; here
:class:`CudaDevice` gives a CUDA device the same ``memory_stats()``:

 - ``bytes_in_use``      = ``torch.cuda.memory_stats()["allocated_bytes.all.current"]``
 - ``peak_bytes_in_use`` = ``torch.cuda.memory_stats()["allocated_bytes.all.peak"]``
 - ``bytes_limit``       = the card's total from ``torch.cuda.mem_get_info``

Each figure is this process's allocator. Several processes on one card
each report their own use over the card's total; the card's pressure is
their sum.

Degradation contract: where no device reports statistics (the CPU) the
watch logs ONE warning, bumps the ``hbm/memory_stats_unavailable`` counter
once, and goes quiet — it never exports fake zero gauges that would read
as an empty card on the merged scrape.

Disabled contract: until :func:`configure` installs an enabled watch the
module-level API routes to a shared null object — no device polls, no
gauges.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

from areal_tpu_torch.base import logging, telemetry

logger = logging.getLogger("system.memwatch")


class CudaDevice:
    """A CUDA device with the reference's ``memory_stats()`` keys."""

    def __init__(self, index: int):
        self.index = index

    def memory_stats(self) -> Dict[str, float]:
        import torch

        stats = torch.cuda.memory_stats(self.index)
        _, total = torch.cuda.mem_get_info(self.index)
        return {
            "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak",
                                                 0)),
            "bytes_limit": float(total),
        }


def _default_devices() -> List[Any]:
    """This process's CUDA device (none on a CPU-only host or before the
    process touched the card: reading another device's statistics would
    create a context on it)."""
    import torch

    if not torch.cuda.is_initialized():
        return []
    return [CudaDevice(torch.cuda.current_device())]


class MemWatch:
    """Per-worker HBM sampler over injectable devices.

    ``devices_fn`` returns device-like objects exposing
    ``memory_stats() -> dict | None`` (:class:`CudaDevice` by default);
    tests inject fakes. ``telemetry_sink`` is any Telemetry-like object."""

    enabled = True

    def __init__(self, telemetry_sink=None, *,
                 sample_interval_secs: float = 10.0,
                 devices_fn: Callable[[], List[Any]] = _default_devices,
                 clock: Callable[[], float] = time.monotonic):
        self.tel = telemetry_sink if telemetry_sink is not None \
            else telemetry.get()
        self.sample_interval_secs = max(float(sample_interval_secs), 0.0)
        self._devices_fn = devices_fn
        self._clock = clock
        self._lock = threading.Lock()
        self._last_sample: Optional[float] = None
        self._unavailable = False
        self._peak_bytes = 0.0
        self._site_peaks: Dict[str, float] = {}

    # ---- polling ----

    def _poll(self) -> Optional[List[Dict[str, float]]]:
        """One reading per device: {bytes_in_use, peak_bytes, limit}.
        None once the backend proved it has no memory_stats."""
        if self._unavailable:
            return None
        try:
            devices = self._devices_fn()
        except Exception as e:  # noqa: BLE001 — no backend at all
            self._degrade(f"device enumeration failed: {e}")
            return None
        out: List[Dict[str, float]] = []
        for d in devices:
            stats_fn = getattr(d, "memory_stats", None)
            if stats_fn is None:
                continue
            try:
                stats = stats_fn()
            except Exception:  # noqa: BLE001 — backend stub raised
                continue
            if not stats:
                continue
            out.append({
                # the CUDA index; a fake's position among the reporting
                "device": getattr(d, "index", len(out)),
                "bytes_in_use": float(stats.get("bytes_in_use", 0.0)),
                "peak_bytes": float(
                    stats.get("peak_bytes_in_use",
                              stats.get("bytes_in_use", 0.0))
                ),
                "limit": float(stats.get("bytes_limit", 0.0)),
            })
        if not out:
            self._degrade(
                "no local device reports memory_stats() (CPU backend?)"
            )
            return None
        return out

    def _degrade(self, why: str) -> None:
        """One-time: warn, bump the degradation counter, go quiet —
        mirrors MfuEmitter's unknown-device path. Never exports zero
        gauges that would read as an empty chip."""
        if self._unavailable:
            return
        self._unavailable = True
        logger.warning(
            f"HBM gauges degraded to unavailable: {why} — "
            f"hbm/* gauges will not be exported by this worker"
        )
        self.tel.inc("hbm/memory_stats_unavailable")

    def sample(self, force: bool = False) -> Optional[float]:
        """Export per-device HBM gauges (rate-limited unless ``force``).
        Returns the max bytes_in_use across devices, or None when the
        backend has no stats / the interval has not elapsed."""
        now = self._clock()
        with self._lock:
            if (not force and self._last_sample is not None
                    and now - self._last_sample < self.sample_interval_secs):
                return None
            self._last_sample = now
        readings = self._poll()
        if readings is None:
            return None
        top = 0.0
        for r in readings:
            i = r["device"]
            self.tel.set_gauge(f"hbm/bytes_in_use{{device={i}}}",
                               r["bytes_in_use"])
            self.tel.set_gauge(f"hbm/peak_bytes{{device={i}}}",
                               r["peak_bytes"])
            if r["limit"] > 0:
                self.tel.set_gauge(f"hbm/limit_bytes{{device={i}}}",
                                   r["limit"])
            top = max(top, r["bytes_in_use"])
            with self._lock:
                self._peak_bytes = max(self._peak_bytes, r["peak_bytes"],
                                       r["bytes_in_use"])
        return top

    # ---- high-water marks ----

    @contextmanager
    def watermark(self, site: str):
        """Bracket a big allocator: the max ``bytes_in_use`` observed at
        block exit becomes the (monotonic) ``hbm/watermark_bytes{site=}``
        gauge. Cheap no-op on degraded backends."""
        try:
            yield
        finally:
            top = self.sample(force=True)
            if top is not None:
                with self._lock:
                    peak = max(self._site_peaks.get(site, 0.0), top)
                    self._site_peaks[site] = peak
                self.tel.set_gauge(f"hbm/watermark_bytes{{site={site}}}",
                                   peak)

    # ---- views ----

    def peak_gb(self) -> float:
        """Highest device-memory occupancy seen by any sample."""
        with self._lock:
            return self._peak_bytes / (1 << 30)

    def site_peaks(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._site_peaks)

    def close(self) -> None:
        pass


@contextmanager
def _null_ctx():
    yield


class _NullMemWatch:
    """Shared disabled sink: no device polls, no gauges."""

    enabled = False

    def sample(self, force: bool = False) -> Optional[float]:
        return None

    def watermark(self, site: str):
        return _null_ctx()

    def peak_gb(self) -> float:
        return 0.0

    def site_peaks(self) -> Dict[str, float]:
        return {}

    def close(self) -> None:
        pass


NULL = _NullMemWatch()
_GLOBAL: Any = NULL


def configure(cfg=None, telemetry_sink=None,
              devices_fn: Callable[[], List[Any]] = _default_devices,
              clock: Callable[[], float] = time.monotonic):
    """Install the process-global HBM watch (gated on the same
    ``compile_watch`` config group — one knob arms the whole
    compile-and-memory observatory). Disabled keeps the null sink."""
    global _GLOBAL
    if cfg is None or not getattr(cfg, "enabled", False):
        _GLOBAL = NULL
        return NULL
    _GLOBAL = MemWatch(
        telemetry_sink,
        sample_interval_secs=getattr(cfg, "mem_sample_interval_secs", 10.0),
        devices_fn=devices_fn,
        clock=clock,
    )
    return _GLOBAL


def get():
    return _GLOBAL


def enabled() -> bool:
    return _GLOBAL.enabled


def sample(force: bool = False) -> Optional[float]:
    return _GLOBAL.sample(force=force)


def watermark(site: str):
    """Module-level watermark context manager — call sites use
    ``with memwatch.watermark("trainer/weight_publish"): ...`` without
    re-checking whether the watch is armed."""
    return _GLOBAL.watermark(site)


def peak_gb() -> float:
    return _GLOBAL.peak_gb()


def shutdown() -> None:
    global _GLOBAL
    if _GLOBAL is not NULL:
        _GLOBAL.close()
        _GLOBAL = NULL
