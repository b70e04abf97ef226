"""Compile-event observatory over the port's one compile: the kernel build.

The port's counterpart of ``areal_tpu/base/compile_watch.py``'s registry
half (``CompileWatch``). The reference watches every jitted entry
point; the port jits nothing, and its only compile is the build of the
flash-attention libraries at first use (``ops/flash_attention.py
_library``: one ``nvcc`` per source, all started together, then a
``ctypes`` load). :meth:`CompileWatch.compiling` brackets that build and
load per library and records, on the worker's telemetry registry:

 - ``compile/events{fn=<library>}`` and ``compile/secs{fn=<library>}``
   counters and ``compile/distinct_shapes{fn=<library>}`` (the distinct
   source hashes built, one per process in practice);
 - the ``compile/inflight`` gauge, nonzero while a build runs;
 - ``compile/cache_hits`` / ``compile/cache_misses``: a library found
   already built under ``build/kernels/<hash>/`` is a hit, one ``nvcc``
   had to build is a miss.

:func:`inflight` is what a supervised worker's heartbeat
(``system/worker_base.py HeartbeatThread``) reads to publish
``names.compile_inflight`` while a build runs.

Left out with the pieces that need them: ``watched_jit`` and the
recompile-storm detector (no jitted function to watch).

Disabled contract: until :func:`configure` installs an enabled watch,
:func:`get` returns a shared null object whose :meth:`compiling` records
nothing.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Set

from areal_tpu_torch.base import telemetry


class CompileWatch:
    """Process-wide compile-event registry. ``telemetry_sink`` is any
    Telemetry-like object (``inc`` / ``set_gauge``); ``clock`` is
    injectable for fake-clock tests."""

    enabled = True

    def __init__(self, telemetry_sink=None, *,
                 clock: Callable[[], float] = time.monotonic):
        self.tel = telemetry_sink if telemetry_sink is not None \
            else telemetry.get()
        self._clock = clock
        self._lock = threading.Lock()
        self._inflight = 0
        self._signatures: Dict[str, Set[str]] = {}

    def inflight(self) -> bool:
        """True while any watched build runs."""
        return self._inflight > 0

    @contextmanager
    def compiling(self, name: str, sig: str):
        """Bracket one build (and load) of ``name`` from sources hashed to
        ``sig``. The caller sets ``rec["cache_hit"]`` (True: found built)
        on the yielded dict; a build that raises is recorded all the
        same, as the reference records a failed compile."""
        rec: Dict[str, Any] = {"cache_hit": None}
        with self._lock:
            self._inflight += 1
            self.tel.set_gauge("compile/inflight", float(self._inflight))
        t0 = self._clock()
        try:
            yield rec
        finally:
            secs = max(self._clock() - t0, 0.0)
            with self._lock:
                self._inflight -= 1
                self.tel.set_gauge("compile/inflight", float(self._inflight))
                sigs = self._signatures.setdefault(name, set())
                sigs.add(sig)
                n_sigs = len(sigs)
            self.tel.inc(f"compile/events{{fn={name}}}")
            self.tel.inc(f"compile/secs{{fn={name}}}", secs)
            self.tel.set_gauge(f"compile/distinct_shapes{{fn={name}}}",
                               float(n_sigs))
            if rec["cache_hit"] is True:
                self.tel.inc("compile/cache_hits")
            elif rec["cache_hit"] is False:
                self.tel.inc("compile/cache_misses")

    def close(self) -> None:
        pass


class _NullCompileWatch:
    """Shared disabled sink: nothing recorded."""

    enabled = False

    @contextmanager
    def compiling(self, name: str, sig: str):
        yield {"cache_hit": None}

    def inflight(self) -> bool:
        return False

    def close(self) -> None:
        pass


NULL = _NullCompileWatch()
_GLOBAL: Any = NULL


def configure(cfg=None, telemetry_sink=None,
              clock: Callable[[], float] = time.monotonic):
    """Install the process-global compile watch. A disabled (or absent)
    config keeps the null sink."""
    global _GLOBAL
    if cfg is None or not getattr(cfg, "enabled", False):
        _GLOBAL = NULL
        return NULL
    _GLOBAL = CompileWatch(telemetry_sink, clock=clock)
    return _GLOBAL


def get():
    return _GLOBAL


def enabled() -> bool:
    return _GLOBAL.enabled


def inflight() -> bool:
    return _GLOBAL.inflight()


def shutdown() -> None:
    global _GLOBAL
    if _GLOBAL is not NULL:
        _GLOBAL.close()
        _GLOBAL = NULL
