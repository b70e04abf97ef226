"""The native host ops: interval scatter and gather, first-fit-decreasing.

The port's counterpart of ``areal_tpu/ops/native.py``: ``scatter_intervals``,
``gather_intervals`` and ``ffd_assign`` over the port's own copy of the
C++ source (``ops/csrc/interval_ops.cpp``), built with ``g++`` at first use
into the repository's ``build/native/<source hash>/`` and loaded with
``ctypes``. This is host code (the packer's inner loops), not a kernel.

Every entry point returns False (scatter, gather) or None (``ffd_assign``)
when the library is not available, and its caller runs the NumPy path, the
plain version, which gives the same grids and the same bins
(``models/packing.py``, ``base/datapack.py``; each calls in only from the
size at which the native path was measured to win, ``NATIVE_MIN_SEQS``
and ``NATIVE_MIN_ITEMS``). :func:`available` says whether the library
loads; ``chip_smoke.py`` asserts it on the card's machine.
Intervals are checked against the grid and the flat buffer before any
pointer reaches the C loops (:func:`check_intervals`, the reference's
``_check_intervals:106``): the NumPy path would raise on the same input,
the raw loop would write out of bounds.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from areal_tpu_torch.base import logging

logger = logging.getLogger("ops.native")

_SRC = Path(__file__).resolve().parent / "csrc" / "interval_ops.cpp"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_off = 0  # inside disabled(): every entry point reports "not available"


def library_path() -> Path:
    """Where the library of the current source lives (keyed by its hash)."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_ROOT / tag / "libinterval_ops.so"


def _build() -> Optional[Path]:
    out = library_path()
    if out.exists():
        return out
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        r = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                            str(_SRC), "-o", str(tmp)],
                           capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.info(f"native interval ops not built ({e}); NumPy path")
        return None
    if r.returncode != 0:
        logger.warning(f"native interval ops build failed:\n{r.stderr[-500:]}")
        return None
    os.replace(tmp, out)
    return out


@contextlib.contextmanager
def disabled():
    """Every call inside takes the NumPy path (a measurement's plain
    version)."""
    global _off
    _off += 1
    try:
        yield
    finally:
        _off -= 1


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _off:
        return None
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            logger.warning(f"native interval ops not loaded ({e}); NumPy path")
            return None
        # raw addresses (``ndarray.ctypes.data``): a typed pointer per
        # argument costs more than the loop it feeds on small inputs
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        for fn in (lib.scatter_intervals, lib.gather_intervals):
            fn.argtypes = [ptr] * 6 + [i64] * 3
            fn.restype = None
        lib.ffd_assign.argtypes = [ptr, ptr, i64, i64, ptr, ptr, ptr]
        lib.ffd_assign.restype = ctypes.c_int64
        _lib = lib
        logger.info(f"native interval ops loaded from {path}")
        return _lib


def available() -> bool:
    """Whether the native library builds and loads here."""
    return _load() is not None


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def check_intervals(rows, cols, lens, offs, n_rows: int, n_cols: int,
                    flat_total: int) -> None:
    """Every interval inside the ``[n_rows, n_cols]`` grid and the flat
    buffer of ``flat_total`` elements, else ValueError."""
    if len(rows) == 0:
        return
    if not len(rows) == len(cols) == len(lens) == len(offs):
        raise ValueError(f"interval arrays disagree on length: rows="
                         f"{len(rows)} cols={len(cols)} lens={len(lens)} "
                         f"offs={len(offs)}")
    if int(lens.min()) < 0 or int(cols.min()) < 0 or int(offs.min()) < 0:
        raise ValueError("negative interval length/column/offset")
    if int(rows.min()) < 0 or int(rows.max()) >= n_rows:
        raise ValueError(f"row index out of range [0, {n_rows}): "
                         f"[{rows.min()}, {rows.max()}]")
    if int((cols + lens).max()) > n_cols:
        raise ValueError(f"interval exceeds grid width {n_cols}: max col+len "
                         f"{(cols + lens).max()}")
    if int((offs + lens).max()) > flat_total:
        raise ValueError(f"interval exceeds flat buffer size {flat_total}: "
                         f"max off+len {(offs + lens).max()}")


def _intervals(fn_name: str, grid: np.ndarray, flat: np.ndarray, src, dst,
               rows, cols, lens, offs) -> bool:
    lib = _load()
    if (lib is None or grid.ndim != 2 or flat.ndim != 1
            or not grid.flags.c_contiguous or not flat.flags.c_contiguous
            or grid.dtype != flat.dtype):
        return False
    rows, cols, lens, offs = map(_i64, (rows, cols, lens, offs))
    check_intervals(rows, cols, lens, offs, grid.shape[0], grid.shape[1],
                    flat.shape[0])
    getattr(lib, fn_name)(
        src.ctypes.data, dst.ctypes.data,
        *(a.ctypes.data for a in (rows, cols, lens, offs)),
        len(rows), grid.shape[1], grid.dtype.itemsize)
    return True


def scatter_intervals(packed: np.ndarray, out: np.ndarray,
                      rows, cols, lens, offs) -> bool:
    """``out[rows[i], cols[i]:cols[i]+lens[i]] = packed[offs[i]:...]`` for a
    1-D ``packed`` and a 2-D ``out`` of one dtype, both contiguous. False
    (the caller runs the NumPy path) when the library is not available or
    the arrays are not of that shape."""
    return _intervals("scatter_intervals", out, packed, packed, out,
                      rows, cols, lens, offs)


def gather_intervals(grid: np.ndarray, out: np.ndarray,
                     rows, cols, lens, offs) -> bool:
    """``out[offs[i]:offs[i]+lens[i]] = grid[rows[i], cols[i]:...]``; False
    as :func:`scatter_intervals`."""
    return _intervals("gather_intervals", grid, out, grid, out,
                      rows, cols, lens, offs)


def ffd_assign(sizes, capacity: int) -> Optional[np.ndarray]:
    """First-fit-decreasing bin id of each item (items taken in stable
    decreasing-size order, each into the first bin with room); None when
    the library is not available."""
    lib = _load()
    if lib is None:
        return None
    sizes = _i64(sizes)
    n = len(sizes)
    order = _i64(np.argsort(-sizes, kind="stable"))
    bin_of = np.empty(n, np.int64)
    loads = np.zeros(max(n, 1), np.int64)
    n_bins = np.zeros(1, np.int64)
    lib.ffd_assign(sizes.ctypes.data, order.ctypes.data, n, int(capacity),
                   bin_of.ctypes.data, loads.ctypes.data, n_bins.ctypes.data)
    return bin_of
