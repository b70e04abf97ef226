"""The port's host-side packer (areal_tpu_torch/base/datapack.py,
models/packing.py, api/data.py, backend/microbatch.py) against the
reference's on the same samples: every layout, grid and split must be equal,
array for array (the packer is integer and numpy code, so exactly)."""

import dataclasses

import numpy as np
import pytest

from areal_tpu.api.data import MicroBatchSpec as JSpec
from areal_tpu.api.data import SequenceSample as JSample
from areal_tpu.backend import microbatch as jmb
from areal_tpu.base import datapack as jdp
from areal_tpu.base.testing import bench_trajectory_dist as j_bench_dist
from areal_tpu.base.testing import bench_trajectory_sample
from areal_tpu.models import packing as jpk
from areal_tpu_torch.api.data import MicroBatchSpec as TSpec
from areal_tpu_torch.api.data import SequenceSample as TSample
from areal_tpu_torch.backend import microbatch as tmb
from areal_tpu_torch.base import datapack as tdp
from areal_tpu_torch.base.testing import bench_trajectory_dist as t_bench_dist
from areal_tpu_torch.models import packing as tpk
from test_torch_train import _tsample
from test_uniform_prep import _make_batch


def _assert_mbs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert dataclasses.astuple(g.layout) == dataclasses.astuple(w.layout)
        assert g.sample_indices == w.sample_indices
        for name in ("grids", "scalars"):
            gd, wd = getattr(g, name), getattr(w, name)
            assert set(gd) == set(wd)
            for k in wd:
                np.testing.assert_array_equal(gd[k], wd[k], err_msg=k)
                assert gd[k].dtype == wd[k].dtype, k
        for name in ("seq_rows", "seq_first_cols", "seq_last_cols", "seq_mask"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name))


@pytest.mark.parametrize("seqlens,kw", [
    ([5, 9, 3, 14, 1, 30, 7], dict(length_bucket=16)),
    ([100, 20, 120, 9], dict(row_len=256, min_rows=3)),
    ([64] * 5 + [3, 2], dict(length_bucket=64, rows_multiple=4)),
])
def test_plan_packing_and_grids_match_reference(seqlens, kw):
    want = jpk.plan_packing(seqlens, **kw)
    got = tpk.plan_packing(seqlens, **kw)
    assert (got.n_rows, got.row_len, got.placements, got.seqlens) == (
        want.n_rows, want.row_len, want.placements, want.seqlens)
    for key, arr in jpk.make_grid(want).items():
        np.testing.assert_array_equal(tpk.make_grid(got)[key], arr)
    packed = np.arange(sum(seqlens), dtype=np.float32)
    grid = tpk.batch_from_packed(packed, got)
    np.testing.assert_array_equal(grid, jpk.batch_from_packed(packed, want))
    np.testing.assert_array_equal(tpk.packed_from_batch(grid, got), packed)


def test_datapack_matches_reference():
    rng = np.random.RandomState(0)
    sizes = rng.randint(1, 500, 40).tolist()
    for cap, k in ((600, 1), (900, 12), (3000, 3)):
        assert tdp.ffd_allocate(sizes, cap, min_groups=k) == \
            jdp.ffd_allocate(sizes, cap, min_groups=k, use_native=False)
    assert tdp.balanced_groups(sizes, 5) == jdp.balanced_groups(sizes, 5)
    assert tdp.partition_contiguous_balanced(sizes, 7) == \
        jdp.partition_contiguous_balanced(sizes, 7)


@pytest.mark.parametrize("spec,buckets", [
    (dict(max_tokens_per_mb=64), dict(length_bucket=16, rows_bucket=2, seqs_bucket=4)),
    (dict(max_tokens_per_mb=100, n_mbs=3), dict(length_bucket=32, seqs_bucket=8)),
    (dict(), dict(length_bucket=16, fill_bucket=8)),  # the fill sweep, uncapped
    (dict(max_tokens_per_mb=64), dict(length_bucket=16, row_len=24)),
])
def test_split_into_microbatches_matches_reference(spec, buckets):
    batch = _make_batch(n_seq=14, seed=4, with_values=True)
    want = jmb.split_into_microbatches(batch, JSpec(**spec), **buckets)
    got = tmb.split_into_microbatches(_tsample(batch), TSpec(**spec), **buckets)
    _assert_mbs_equal(got, want)
    assert tmb.pack_fill(got) == jmb.pack_fill(want)
    outs = [np.random.RandomState(i).randn(*mb.layout.shape).astype(np.float32)
            for i, mb in enumerate(want)]
    for a, b in zip(tmb.scatter_back(got, outs, batch.bs),
                    jmb.scatter_back(want, outs, batch.bs)):
        np.testing.assert_array_equal(a, b)
    assert tmb.worst_case_row_candidates(16, 8, 100) == \
        jmb.worst_case_row_candidates(16, 8, 100)


def test_bench_batch_packs_like_the_reference():
    """bench.py's batch under its buckets: 8 micro-batches of [2, 1792] at
    fill 0.961, in both packers."""
    rng_t, plens, glens = t_bench_dist(0, 32)
    rng_j, jp, jg = j_bench_dist(0, 32)
    np.testing.assert_array_equal(plens, jp)
    np.testing.assert_array_equal(glens, jg)
    assert rng_t.randint(0, 1 << 30) == rng_j.randint(0, 1 << 30)
    sample, seqlens = bench_trajectory_sample(0, 32)
    assert int(seqlens.sum()) == 27554
    kw = dict(length_bucket=512, rows_bucket=4, seqs_bucket=16)
    want = jmb.split_into_microbatches(sample, JSpec(max_tokens_per_mb=4096), **kw)
    got = tmb.split_into_microbatches(_tsample(sample), TSpec(max_tokens_per_mb=4096), **kw)
    _assert_mbs_equal(got, want)
    assert len(got) == 8 and got[0].layout.shape == (2, 1792)
    assert round(tmb.pack_fill(got), 3) == 0.961


def test_sequence_sample_split_matches_reference():
    batch = _make_batch(n_seq=11, seed=6)
    tb = _tsample(batch)
    for kw in (dict(k=3), dict(mb_spec=JSpec(n_mbs=2, max_tokens_per_mb=40))):
        tkw = dict(kw)
        if "mb_spec" in kw:
            tkw["mb_spec"] = TSpec(n_mbs=2, max_tokens_per_mb=40)
        want_s, want_g = batch.split(**kw)
        got_s, got_g = tb.split(**tkw)
        assert got_g == want_g
        for g, w in zip(got_s, want_s):
            assert g.ids == w.ids and g.seqlens == w.seqlens
            for key in w.keys:
                np.testing.assert_array_equal(g.data[key], w.data[key])
    gathered = TSample.gather(got_s)
    assert sorted(gathered.ids) == sorted(tb.ids)
    meta = JSample.from_default(ids=["a"], data={"x": np.zeros(3)}, seqlens=[3])
    assert TSample.from_default(ids=["a"], data={"x": np.zeros(3)},
                                seqlens=[3]).seqlens == meta.seqlens
