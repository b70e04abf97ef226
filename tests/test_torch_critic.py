"""The port's critic (the value head of areal_tpu_torch/models/transformer.py,
``ppo_functional.critic_loss``, ``RunningMoments`` and
``PPOCriticInterface`` in algorithms/ppo.py) against the reference's on one
numpy-seeded set of weights, in float32 on the CPU at ``tiny_config`` size.

Tolerances as tests/test_torch_train.py: values and losses at 1e-5
relative (float32, different summation order), stats at 1e-5 relative,
updated masters at atol 2e-6 / rtol 2e-5, the running moments at 1e-6
relative (float64 on the host from float32 returns).
"""

import numpy as np
import pytest
import torch

from areal_tpu.algorithms import ppo as jppo
from areal_tpu.algorithms import ppo_functional as jF
from areal_tpu.api.data import MicroBatchSpec as JSpec
from areal_tpu_torch.algorithms import ppo as tppo
from areal_tpu_torch.algorithms import ppo_functional as tF
from areal_tpu_torch.api.data import MicroBatchSpec as TSpec
from areal_tpu_torch.models import config as tconfig
from areal_tpu_torch.models.transformer import Transformer, init_params
from test_torch_train import (
    SPEC,
    _assert_masters_match,
    _assert_stats_match,
    _thp,
    _tsample,
)
from test_torch_trainer import model_pair
from test_uniform_prep import _make_batch

CRITIC = dict(cfg_kw=dict(is_critic=True))


def test_critic_forward_matches_reference():
    jm, tm = model_pair(train=False, **CRITIC)
    batch = _make_batch(seed=11)
    want = jm.module.forward(batch, JSpec(**SPEC), post_hook=jppo._values_hook)
    got = tm.module.forward(_tsample(batch), TSpec(**SPEC),
                            post_hook=tppo._values_hook)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)


def test_values_are_cast_after_the_head():
    """In bf16 the head multiplies in bf16 and the engine casts its [R, L]
    output to f32 afterwards: the f32 values are exactly the bf16 ones."""
    cfg = tconfig.tiny_config(is_critic=True)
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    model = Transformer.from_params(cfg, params)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16))
    pos = torch.arange(16).expand(2, 16)
    seg = torch.ones(2, 16, dtype=torch.int32)
    with torch.no_grad():
        values, _ = model(tokens, pos, seg, return_kv=False)
    assert values.shape == (2, 16) and values.dtype == torch.bfloat16
    from areal_tpu_torch.backend.torch_train import TorchTrainEngine

    eng = TorchTrainEngine(cfg, params, device="cpu")
    with torch.no_grad():
        out = eng._hidden_or_logits(
            eng._cast(), {"tokens": tokens, "positions": pos,
                          "segment_ids": seg}, return_hidden=False, remat=False)
    assert out.dtype == torch.float32
    assert torch.equal(out, values.float())


def test_critic_trunk_is_the_actors():
    """init_params draws in module order: a critic made from the actor's
    seed shares the actor's trunk, and its value head comes after it."""
    actor = init_params(tconfig.tiny_config(tie_word_embeddings=True), seed=3,
                        device="cpu")
    critic = init_params(tconfig.tiny_config(tie_word_embeddings=True,
                                             is_critic=True), seed=3,
                         device="cpu")
    assert set(critic) == set(actor) | {"value_head.weight"}
    for name, t in actor.items():
        assert torch.equal(critic[name], t), name
    assert critic["value_head.weight"].shape == (1, 32)


def test_critic_param_count_matches_reference():
    from areal_tpu.models import config as jconfig
    from areal_tpu.models import transformer as jtf
    from areal_tpu_torch.models.transformer import param_count

    for kw in (dict(is_critic=True), dict(is_critic=True,
                                          tie_word_embeddings=True)):
        cfg = tconfig.tiny_config(**kw)
        assert param_count(cfg) == jtf.param_count(jconfig.tiny_config(**kw))
        model = Transformer(cfg, device="meta")
        assert sum(p.numel() for p in model.parameters()) == param_count(cfg)


@pytest.mark.parametrize("loss_fn", ["huber", "mse"])
def test_critic_loss_matches_reference(loss_fn):
    rng = np.random.RandomState(12)
    value, old, ret = (rng.randn(3, 20).astype(np.float32) * 4 for _ in range(3))
    ret[0, :3] += 30.0  # beyond the Huber delta
    mask = rng.rand(3, 20) < 0.7
    want, wst = jF.critic_loss(value, old, ret, mask, value_eps_clip=0.2,
                               loss_fn=loss_fn)
    got, gst = tF.critic_loss(*(torch.from_numpy(a) for a in (value, old, ret,
                                                              mask)),
                              value_eps_clip=0.2, loss_fn=loss_fn)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert float(gst["value_clip_ratio"]) == pytest.approx(
        float(wst["value_clip_ratio"]), rel=1e-6)


def test_running_moments_match_reference():
    rng = np.random.RandomState(13)
    j, t = jppo.RunningMoments(0.9, 1e-5), tppo.RunningMoments(0.9, 1e-5)
    for _ in range(3):
        x, m = rng.randn(50) * 3 + 1, rng.rand(50) < 0.5
        j.update(x, m)
        t.update(x, m)
        assert t.state_dict() == j.state_dict() and t.var == j.var
    np.testing.assert_array_equal(t.normalize(x), j.normalize(x))
    np.testing.assert_array_equal(t.denormalize(x), j.denormalize(x))
    fresh = tppo.RunningMoments()
    fresh.load_state_dict(t.state_dict())
    assert fresh.state_dict() == t.state_dict()


def test_critic_inference_and_train_steps_match_reference():
    """Two rounds of inference (denormalised values) → train_step (returns
    normalised by the running moments, clipped Huber loss, minibatches
    through train_batch): stats, masters and the moments."""
    hp = jppo.PPOHyperparameters(ppo_n_minibatches=2, value_norm_beta=0.9)
    jm, tm = model_pair(remat="dots", **CRITIC)
    ji, ti = jppo.PPOCriticInterface(hp), tppo.PPOCriticInterface(_thp(hp))
    for seed in (14, 15):
        batch = _make_batch(seed=seed)
        jv = ji.inference(jm, batch, JSpec(**SPEC))
        tv = ti.inference(tm, _tsample(batch), TSpec(**SPEC))
        np.testing.assert_allclose(tv.data["values"], jv.data["values"],
                                   rtol=1e-5, atol=1e-6)
        jb = jppo.attach_keys(batch, {"values": jv.data["values"]})
        want = ji.train_step(jm, jb, JSpec(**SPEC))
        got = ti.train_step(tm, _tsample(jb), TSpec(**SPEC))
        assert set(got) == set(want)
        _assert_stats_match(got, want)
        assert got["grad_norm"] > 0 and np.isfinite(got["critic_loss"])
        for key, v in ji.state_dict()["rms"].items():
            assert ti.state_dict()["rms"][key] == pytest.approx(v, rel=1e-6)
        _assert_masters_match(jm.module, tm.module, tm.module.cfg)
    assert tm.module.opt_step_count == jm.module.opt_step_count == 4
    assert tm.version.global_step == 2
