"""The port's reward-model training (areal_tpu_torch/algorithms/rw.py) and
its paired dataset against the reference's (areal_tpu/algorithms/rw.py,
datasets/jsonl.py) on the same records and one numpy-seeded set of
critic weights, in float32 on the CPU at ``tiny_config`` size.

Tolerances: the datasets and ``flatten_pairs`` exactly; ``_pairwise_loss``
and the stats of 3 train steps within 1e-4 relative (float32, a different
summation order; the issue's bound); scores within 1e-5 relative.
"""

import json

import numpy as np
import pytest
import torch

from areal_tpu.algorithms import rw as jrw
from areal_tpu.api.data import MicroBatchSpec as JSpec
from areal_tpu.api.data import SequenceSample as JSample
from areal_tpu.base.testing import MockTokenizer
from areal_tpu.datasets import jsonl as jjsonl
from areal_tpu_torch.algorithms import rw as trw
from areal_tpu_torch.api.data import MicroBatchSpec as TSpec
from areal_tpu_torch.api.data import SequenceSample as TSample
from areal_tpu_torch.api.model import make_interface
from areal_tpu_torch.base.testing import MockTokenizer as TMockTokenizer
from areal_tpu_torch.datasets import jsonl as tjsonl
from test_torch_trainer import model_pair

MBS = dict(max_tokens_per_mb=4096)
CRITIC = dict(cfg_kw=dict(is_critic=True, vocab_size=258))


def paired_jsonl(path, n=8, seed=0):
    """Seeded records of 2 pairs each: positives end in 'G', negatives in
    'B', answers of seeded lengths."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            words = [" ".join(["w%d" % rng.randint(100)
                               for _ in range(rng.randint(1, 6))])
                     for _ in range(2)]
            f.write(json.dumps({
                "query_id": f"q{i}", "prompt": f"question {i}: ",
                "pos_answers": [f"{w} G" for w in words],
                "neg_answers": [f"{w} B" for w in words],
            }) + "\n")


def datasets(tmp_path, n=8):
    p = str(tmp_path / "rw.jsonl")
    paired_jsonl(p, n=n)
    return (jjsonl.RewardModelingPairedDataset(dataset_path=p,
                                               tokenizer=MockTokenizer()),
            tjsonl.RewardModelingPairedDataset(dataset_path=p,
                                               tokenizer=TMockTokenizer()))


def _assert_samples_equal(got, want):
    assert got.ids == want.ids and got.keys == want.keys
    assert got.seqlens == want.seqlens
    assert got.metadata == want.metadata
    for k in want.keys:
        np.testing.assert_array_equal(got.data[k], want.data[k])
        assert got.data[k].dtype == want.data[k].dtype


def _batches(jds, tds):
    return (JSample.gather([jds[i] for i in range(len(jds))]),
            TSample.gather([tds[i] for i in range(len(tds))]))


def test_paired_dataset_samples_equal(tmp_path):
    jds, tds = datasets(tmp_path)
    assert len(jds) == len(tds) == 8
    for i in range(len(jds)):
        _assert_samples_equal(tds[i], jds[i])
        assert tds[i].metadata["n_pairs"] == [2]
        assert len(tds[i].seqlens["packed_input_ids"][0]) == 4


def test_flatten_pairs_equal(tmp_path):
    jb, tb = _batches(*datasets(tmp_path, n=4))
    want, got = jrw.flatten_pairs(jb), trw.flatten_pairs(tb)
    _assert_samples_equal(got, want)
    assert got.bs == 16  # 4 prompts x 2 pairs x 2 answers
    signs, idxs = got.data["_pair_sign"], got.data["_pair_idx"]
    for pid in np.unique(idxs):
        assert sorted(signs[idxs == pid].tolist()) == [-1.0, 1.0]


@pytest.mark.parametrize("split", [False, True])
def test_pairwise_loss_matches_reference(split):
    """Seeded values and a micro-batch's per-sequence arrays, padded to the
    seqs bucket; with ``split`` one pair's negative sits in another
    micro-batch (an orphan)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    R, L, S = 4, 32, 12
    values = rng.randn(R, L).astype(np.float32)
    n = 10
    idx = np.zeros(S, np.float32)
    sign = np.zeros(S, np.float32)
    idx[:n] = np.repeat(np.arange(5), 2)
    sign[:n] = np.tile([1.0, -1.0], 5)
    if split:
        idx[n - 1] = 99.0  # the last positive's partner is elsewhere
    mask = np.zeros(S, np.float32)
    mask[:n] = 1.0
    batch = {"seq_rows": rng.randint(0, R, S).astype(np.int32),
             "seq_last_cols": rng.randint(0, L, S).astype(np.int32),
             "seq_mask": mask, "_pair_idx": idx, "_pair_sign": sign}
    jl, js = jrw._pairwise_loss(jnp.asarray(values),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    tl, ts = trw._pairwise_loss(torch.from_numpy(values),
                                {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    assert float(tl) == pytest.approx(float(jl), rel=1e-4)
    assert set(ts) == set(js)
    for k in js:
        assert float(ts[k]) == pytest.approx(float(js[k]), rel=1e-4,
                                             abs=1e-6), k
    assert float(ts["orphan_pairs"]) == (2.0 if split else 0.0)


def test_rw_train_steps_match_reference(tmp_path):
    jds, tds = datasets(tmp_path)
    jb, tb = _batches(jds, tds)
    jm, tm = model_pair(**CRITIC)
    jif, tif = jrw.RewardModelingInterface(), make_interface("rw_paired")
    for _ in range(3):
        want = jif.train_step(jm, jb, JSpec(**MBS))
        got = tif.train_step(tm, tb, TSpec(**MBS))
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k
        assert got["orphan_pairs"] == 0.0 and got["n_pairs"] == 16.0
        assert np.isfinite(got["loss"]) and got["grad_norm"] > 0
    assert tm.version.global_step == 3

    # the serving path: a score per flat sequence
    flat = jrw.flatten_pairs(jb)
    flat = JSample.from_default(ids=flat.ids, data={
        "packed_input_ids": flat.data["packed_input_ids"]},
        seqlens=flat.total_lens().tolist())
    want = jif.inference(jm, flat, JSpec(**MBS))
    tflat = TSample.from_default(ids=flat.ids, data=dict(flat.data),
                                 seqlens=flat.total_lens().tolist())
    got = tif.inference(tm, tflat, TSpec(**MBS))
    assert got.ids == want.ids and got.keys == want.keys == {"scores"}
    np.testing.assert_allclose(got.data["scores"], want.data["scores"],
                               rtol=1e-5, atol=1e-6)


def test_rw_counts_orphans_across_micro_batches(tmp_path):
    """A cap that splits the batch into many micro-batches leaves pairs
    whose halves land apart: both packages count the same orphans and
    train on the rest."""
    jds, tds = datasets(tmp_path)
    jb, tb = _batches(jds, tds)
    jm, tm = model_pair(**CRITIC)
    spec = dict(max_tokens_per_mb=48)
    want = jrw.RewardModelingInterface().train_step(jm, jb, JSpec(**spec))
    got = trw.RewardModelingInterface().train_step(tm, tb, TSpec(**spec))
    assert got["orphan_pairs"] == want["orphan_pairs"]
    assert got["n_pairs"] == want["n_pairs"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
