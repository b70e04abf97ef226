"""The port's native host ops (``areal_tpu_torch/ops/native.py`` over its own
``ops/csrc/interval_ops.cpp``) against the reference's (``areal_tpu/ops/
native.py`` over ``csrc/interval_ops.cpp``) and against the port's NumPy
path, on seeded inputs: the same grids, flat buffers and bins. The bounds
checks raise before any pointer reaches the C loops. Twin of
``tests/test_native_ops.py``; needs ``g++`` (present wherever the port's
tests run)."""

import numpy as np
import pytest

from areal_tpu.base import datapack as jdatapack
from areal_tpu.models import packing as jpacking
from areal_tpu.ops import native as jnative
from areal_tpu_torch.base import datapack
from areal_tpu_torch.models import packing
from areal_tpu_torch.ops import native


def _python_ffd(sizes, capacity):
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    bins, loads = [], []
    for i in order:
        s = int(sizes[i])
        for b in range(len(bins)):
            if loads[b] + s <= capacity:
                bins[b].append(i)
                loads[b] += s
                break
        else:
            bins.append([i])
            loads.append(s)
    return bins


def _intervals(rng, n=50, R=8, L=512):
    """Random non-overlapping placements of ``n`` sequences in ``[R, L]``."""
    lens = rng.integers(1, 40, n)
    rows, cols, offs = [], [], []
    cursor = {r: 0 for r in range(R)}
    off = 0
    for ln in lens:
        r = int(rng.integers(0, R))
        while cursor[r] + ln > L:
            r = (r + 1) % R
        rows.append(r)
        cols.append(cursor[r])
        cursor[r] += int(ln)
        offs.append(off)
        off += int(ln)
    return lens, rows, cols, offs


def test_native_builds_here():
    assert native.available()
    assert native.library_path().exists()
    assert "build" in native.library_path().parts


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.float64,
                                   np.int64])
def test_scatter_gather_match_reference_and_numpy(dtype):
    rng = np.random.default_rng(0)
    lens, rows, cols, offs = _intervals(rng)
    total = int(lens.sum())
    packed = rng.integers(0, 1000, total).astype(dtype)
    grid = np.zeros((8, 512), dtype)
    assert native.scatter_intervals(packed, grid, rows, cols, lens, offs)
    ref = np.zeros((8, 512), dtype)
    assert jnative.scatter_intervals(packed, ref, rows, cols, lens, offs)
    plain = np.zeros((8, 512), dtype)
    for r, c, ln, o in zip(rows, cols, lens, offs):
        plain[r, c:c + ln] = packed[o:o + ln]
    np.testing.assert_array_equal(grid, ref)
    np.testing.assert_array_equal(grid, plain)
    back = np.zeros(total, dtype)
    assert native.gather_intervals(grid, back, rows, cols, lens, offs)
    np.testing.assert_array_equal(back, packed)


def test_ffd_assign_matches_reference_and_python():
    rng = np.random.default_rng(1)
    for _ in range(10):
        sizes = rng.integers(1, 700, int(rng.integers(64, 400))).tolist()
        cap = int(rng.integers(700, 2000))
        bin_of = native.ffd_assign(sizes, cap)
        np.testing.assert_array_equal(bin_of, jnative.ffd_assign(sizes, cap))
        got = [[] for _ in range(int(bin_of.max()) + 1)]
        for i in sorted(range(len(sizes)), key=lambda i: -sizes[i]):
            got[int(bin_of[i])].append(i)
        assert got == _python_ffd(sizes, cap)


@pytest.mark.parametrize("bad", [
    dict(rows=[2]), dict(rows=[-1]), dict(cols=[4]), dict(lens=[-2]),
    dict(offs=[12])])
def test_scatter_gather_bounds_checked(bad):
    """Out-of-range intervals raise before the C loop runs: row past R,
    negative row, col+len past L, negative length, off+len past the flat
    buffer."""
    packed = np.arange(16, dtype=np.int32)
    out = np.zeros((2, 8), np.int32)
    ok = dict(rows=[0], cols=[0], lens=[8], offs=[0])
    assert native.scatter_intervals(packed, out, **ok)
    args = {k: np.asarray(v) for k, v in dict(ok, **bad).items()}
    with pytest.raises(ValueError):
        native.scatter_intervals(packed, out, **args)
    with pytest.raises(ValueError):
        native.gather_intervals(out, packed.copy(), **args)


def _count_calls(monkeypatch, name):
    calls = []
    real = getattr(native, name)

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(native, name, counted)
    return calls


@pytest.mark.parametrize("n_seqs", [40, 1100])
def test_batch_from_packed_native_equals_numpy_and_reference(monkeypatch,
                                                             n_seqs):
    """Below ``NATIVE_MIN_SEQS`` the NumPy loop runs, from it the native
    scatter; both give the reference's grid."""
    calls = _count_calls(monkeypatch, "scatter_intervals")
    rng = np.random.default_rng(2)
    seqlens = rng.integers(1, 30, n_seqs).tolist()
    layout = packing.plan_packing(seqlens, length_bucket=16, rows_multiple=2)
    packed = rng.integers(0, 100, sum(seqlens)).astype(np.int32)
    grid = packing.batch_from_packed(packed, layout)
    assert len(calls) == int(n_seqs >= packing.NATIVE_MIN_SEQS)
    with native.disabled():
        assert not native.available()
        plain = packing.batch_from_packed(packed, layout)
    jlayout = jpacking.plan_packing(seqlens, length_bucket=16,
                                    rows_multiple=2)
    np.testing.assert_array_equal(grid, plain)
    np.testing.assert_array_equal(grid, jpacking.batch_from_packed(
        packed, jlayout))
    np.testing.assert_array_equal(packing.packed_from_batch(grid, layout),
                                  packed)


@pytest.mark.parametrize("min_groups", [1, 12])
def test_ffd_allocate_native_equals_python_and_reference(monkeypatch,
                                                         min_groups):
    calls = _count_calls(monkeypatch, "ffd_assign")
    rng = np.random.default_rng(3)
    sizes = rng.integers(1, 500, 200).tolist()
    assert len(sizes) >= datapack.NATIVE_MIN_ITEMS
    bins = datapack.ffd_allocate(sizes, 1024, min_groups=min_groups)
    assert len(calls) == 1
    with native.disabled():
        assert bins == datapack.ffd_allocate(sizes, 1024,
                                             min_groups=min_groups)
    assert bins == jdatapack.ffd_allocate(sizes, 1024, min_groups=min_groups)
    assert sorted(i for b in bins for i in b) == list(range(200))
    for b in bins:
        assert sum(sizes[i] for i in b) <= 1024 or len(b) == 1
    # the two paths' bins and loads agree before the min_groups split
    assert datapack._ffd_native(sizes, 1024) == \
        datapack._ffd_python(sizes, 1024)
    # small inputs take the Python loop; the native bins agree all the same
    small = sizes[:10]
    before = len(calls)
    datapack.ffd_allocate(small, 600)
    assert len(calls) == before
    assert datapack._ffd_native(small, 600) == datapack._ffd_python(small, 600)
