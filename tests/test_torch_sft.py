"""The port's SFT interface (areal_tpu_torch/algorithms/sft.py) against the
reference's on one numpy-seeded set of weights, in float32 on the CPU at
``tiny_config`` size. Tolerances as tests/test_torch_train.py: stats,
perplexity and per-sample NLL at 1e-5 relative, updated masters at atol
2e-6 / rtol 2e-5.
"""

import numpy as np
import pytest

from areal_tpu.algorithms import sft as jsft
from areal_tpu.api.data import MicroBatchSpec as JSpec
from areal_tpu_torch.algorithms import sft as tsft
from areal_tpu_torch.api.data import MicroBatchSpec as TSpec
from test_torch_train import (
    SPEC,
    _assert_masters_match,
    _assert_stats_match,
    _tsample,
)
from test_torch_trainer import model_pair
from test_uniform_prep import _make_batch


@pytest.mark.parametrize("scope,chunk", [("global", 8), ("mb", None)])
def test_sft_train_step_matches_reference(scope, chunk):
    jm, tm = model_pair(remat="dots", logprob_chunk=chunk)
    for seed in (16, 17):
        batch = _make_batch(seed=seed)
        want = jsft.SFTInterface(scope).train_step(jm, batch, JSpec(**SPEC))
        got = tsft.SFTInterface(scope).train_step(tm, _tsample(batch),
                                                  TSpec(**SPEC))
        assert set(got) == set(want)
        _assert_stats_match(got, want)
        assert np.isfinite(got["ppl"]) and got["grad_norm"] > 0
        _assert_masters_match(jm.module, tm.module, tm.module.cfg)
    assert tm.version.global_step == 2 and tm.module.opt_step_count == 2


def test_sft_inference_matches_reference():
    jm, tm = model_pair(train=False)
    batch = _make_batch(seed=18)
    want = jsft.SFTInterface().inference(jm, batch, JSpec(**SPEC))
    got = tsft.SFTInterface().inference(tm, _tsample(batch), TSpec(**SPEC))
    assert got.ids == want.ids and got.keys == want.keys == {"eval_nll"}
    np.testing.assert_allclose(got.data["eval_nll"], want.data["eval_nll"],
                               rtol=1e-5)
    assert (got.data["eval_nll"] > 0).all()
