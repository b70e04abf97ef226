"""The trainer's model functions of the port (areal_tpu_torch/backend/
torch_train.py ``forward``, ``train_batch``, ``generate``, the train-state
checkpoint; algorithms/ppo.py's host advantage path, ``inference``,
``generate``, ``LogprobInterface``; the registries) against the reference's
(JaxTrainEngine, algorithms/ppo.py) on one numpy-seeded set of weights, in
float32 on the CPU at ``tiny_config`` size.

Tolerances as tests/test_torch_train.py: 1e-5 relative on logprobs, stats
and grad norms (float32, different summation order); advantages and
returns at 1e-5 absolute (a different GAE scan tree), 1e-4 after the
whitening divides them by their standard deviation; updated masters at
atol 2e-6 / rtol 2e-5; greedy tokens equal and their logprobs at 1e-4
(the decode path's attention sums in another order). The train-state
round trip is exact.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from areal_tpu.algorithms import ppo as jppo
from areal_tpu.api import model as jmodel
from areal_tpu.api.data import MicroBatchSpec as JSpec
from areal_tpu.api.data import SequenceSample as JSample
from areal_tpu.backend import jax_train as jtrain
from areal_tpu.models import config as jconfig
from areal_tpu.models import hf as jhf
from areal_tpu.models import transformer as jtf
from areal_tpu_torch.algorithms import ppo as tppo
from areal_tpu_torch.api import model as tmodel
from areal_tpu_torch.api.data import MicroBatchSpec as TSpec
from areal_tpu_torch.api.train_config import OptimizerConfig as TOpt
from areal_tpu_torch.backend import torch_train  # noqa: F401 (registers the backends)
from areal_tpu_torch.models import config as tconfig
from areal_tpu_torch.models.convert import params_from_jax
from test_torch_model import _jparams
from test_torch_train import (
    ENGINE,
    NORM_SCALES,
    SPEC,
    _assert_masters_match,
    _assert_stats_match,
    _thp,
    _tsample,
)
from test_uniform_prep import _make_batch

CFG = dict(vocab_size=128, use_attention_bias=True, tie_word_embeddings=True)


def weights(seed=0, **cfg_kw):
    """(reference config, port config, flat numpy weights) of a tiny model:
    every parameter (norm scales around 1) from one numpy seed."""
    kw = {**CFG, **cfg_kw}
    jcfg = jconfig.tiny_config(**kw)
    shapes = jhf.flatten_pytree(jax.eval_shape(
        lambda: jtf.init_params(jcfg, jax.random.PRNGKey(0))))
    rng = np.random.RandomState(seed)
    flat = {}
    for key, a in shapes.items():
        base = 1.0 if key.split("/")[-1] in NORM_SCALES else 0.0
        flat[key] = (base + 0.1 * rng.randn(*a.shape)).astype(np.float32)
    return jcfg, tconfig.tiny_config(**kw), flat


def model_pair(train=True, opt=None, seed=0, cfg_kw=None, **engine_kw):
    """(reference Model, port Model) over the same weights; inference
    engines with ``train=False``."""
    jcfg, tcfg, flat = weights(seed, **(cfg_kw or {}))
    opt = dict(lr=1e-3, lr_scheduler_type="constant", **(opt or {}))
    kw = {**ENGINE, **engine_kw}
    jm = jtrain.JaxTrainBackend(
        optimizer=jtrain.OptimizerConfig(**opt), train=train, **kw,
    ).initialize(jmodel.Model("m", (jcfg, _jparams(flat))),
                 jmodel.FinetuneSpec(1, 8, 4))
    tm = tmodel.make_backend(
        "torch_train" if train else "torch_inference",
        optimizer=TOpt(**opt), device="cpu", **kw,
    ).initialize(tmodel.Model("m", (tcfg, params_from_jax(
        flat, tcfg, device="cpu"))), tmodel.FinetuneSpec(1, 8, 4))
    return jm, tm


def grouped_batch(n_seq=12, seed=0, extra=None, **kw):
    """_make_batch with prompt groups of 3 (metadata ``group``) and the
    ``extra`` keys."""
    b = _make_batch(n_seq=n_seq, seed=seed, **kw)
    return JSample.from_default(
        ids=b.ids, data={**b.data, **(extra or {})},
        seqlens=b.total_lens().tolist(),
        metadata={"group": [f"q{i // 3}" for i in range(n_seq)]})


def _close(got, want, **tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


# ---------------- forward / inference ----------------

@pytest.mark.parametrize("chunk", [8, None])
def test_forward_logprobs_match_reference(chunk):
    jm, tm = model_pair(train=False, logprob_chunk=chunk)
    batch = _make_batch(seed=1)
    want = jm.module.forward(batch, JSpec(**SPEC), post_hook=jppo._logprob_hook)
    got = tm.module.forward(_tsample(batch), TSpec(**SPEC),
                            post_hook=tppo._logprob_hook)
    _close(got, want, rtol=1e-5, atol=1e-6)
    assert not any(p.requires_grad for p in tm.module.params.values())
    assert tm.module.optimizer is None


def test_logprob_and_actor_inference_match_reference():
    """LogprobInterface (ref_inf) on an inference engine and the actor's
    inference (prox logprobs) on a train engine's f32 masters."""
    batch = _make_batch(seed=2)
    jm, tm = model_pair(train=False)
    want = jppo.LogprobInterface().inference(jm, batch, JSpec(**SPEC))
    ref = tmodel.make_interface("ref_logprob").inference(
        tm, _tsample(batch), TSpec(**SPEC))
    assert ref.keys == {"packed_ref_logprobs"} == want.keys
    assert ref.seqlens == want.seqlens
    np.testing.assert_allclose(ref.data["packed_ref_logprobs"],
                               want.data["packed_ref_logprobs"],
                               rtol=1e-5, atol=1e-6)
    ja, ta = model_pair(train=True)
    want = jppo.PPOActorInterface().inference(ja, batch, JSpec(**SPEC))
    got = tppo.PPOActorInterface().inference(ta, _tsample(batch),
                                             TSpec(**SPEC))
    np.testing.assert_allclose(got.data["prox_logprobs"],
                               want.data["prox_logprobs"], rtol=1e-5, atol=1e-6)
    # The same weights packed the same way: the train engine's masters and
    # the inference engine's weights give identical logprobs.
    np.testing.assert_array_equal(got.data["prox_logprobs"],
                                  ref.data["packed_ref_logprobs"])


def test_registries():
    assert isinstance(tmodel.make_interface("ppo_actor"), tppo.PPOActorInterface)
    assert isinstance(tmodel.make_interface("ppo_critic"), tppo.PPOCriticInterface)
    import areal_tpu_torch.algorithms.sft as tsft

    assert isinstance(tmodel.make_interface("sft"), tsft.SFTInterface)
    assert tmodel.make_backend("torch_inference").train is False
    with pytest.raises(KeyError, match="unknown backend"):
        tmodel.make_backend("jax_train")
    _, tcfg, flat = weights()
    params = params_from_jax(flat, tcfg, device="cpu", dtype=torch.bfloat16)
    m = tmodel.make_backend("torch_inference", device="cpu").initialize(
        tmodel.Model("ref", (tcfg, params)), tmodel.FinetuneSpec())
    assert m.module.optimizer is None and m.module.opt_step_count == 0
    assert all(p.dtype == torch.bfloat16 for p in m.module.params.values())


# ---------------- the host advantage path ----------------

@pytest.mark.parametrize("group", [False, True])
@pytest.mark.parametrize("kl_coef", [0.0, 0.1])
def test_host_advantage_path_matches_reference(group, kl_coef):
    """KL-shaped rewards, values, no-EOS bootstraps and prompt groups
    through compute_advantages_and_returns and normalize_advantages."""
    hp = jppo.PPOHyperparameters(kl_ctl=kl_coef, group_adv_norm=group)
    batch = grouped_batch(with_values=True)
    want = jppo.compute_advantages_and_returns(batch, hp, kl_coef)
    got = tppo.compute_advantages_and_returns(_tsample(batch), _thp(hp),
                                              kl_coef, device="cpu")
    assert set(got) == set(want)
    assert got.pop("_mean_kl") == pytest.approx(want.pop("_mean_kl"), rel=1e-6)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-5, err_msg=key)
    jdata = jppo.attach_keys(batch, want)
    tdata = tppo.attach_keys(_tsample(batch), got)
    jppo.normalize_advantages(jdata, hp)
    tppo.normalize_advantages(tdata, _thp(hp))
    np.testing.assert_allclose(tdata.data["advantages"],
                               jdata.data["advantages"], atol=1e-4)


def test_first_action_token_keeps_its_baseline():
    """The values are shifted inside each doc before the action mask
    restricts them: the first action token's baseline is the last prompt
    slot's value, so with zero rewards its advantage is -V(last prompt)."""
    b = _make_batch(n_seq=3, seed=4, with_values=True)
    b.data["rewards"][:] = 0.0
    b.data["packed_ref_logprobs"] = b.data["packed_logprobs"].copy()
    b.data["seq_no_eos_mask"][:] = 0.0
    hp = tppo.PPOHyperparameters()
    got = tppo.compute_advantages_and_returns(_tsample(b), hp, 0.1,
                                              device="cpu")
    pm, v = b.data["prompt_mask"], b.data["values"]
    off = 0
    for n in b.total_lens():
        first = off + int(pm[off:off + n].sum())  # first action slot
        # GAE with λ=γ=1 telescopes to -V(first action's pre-state) + ...:
        # every later V cancels, the terminal value is 0.
        assert got["advantages"][first] == pytest.approx(-v[first - 1],
                                                         abs=1e-5)
        off += n


# ---------------- train_batch ----------------

def _with_advantages(batch, hp):
    extra = jppo.compute_advantages_and_returns(batch, hp, hp.kl_ctl)
    extra.pop("_mean_kl")
    data = jppo.attach_keys(batch, extra)
    jppo.normalize_advantages(data, hp)
    return data


@pytest.mark.parametrize("scope,cap", [("global", 5.0), ("mb", 5.0),
                                       ("global", 1e-3)])
def test_train_batch_matches_reference(scope, cap):
    """One optimizer step over several micro-batches; with a tiny cap the
    skip rule fires and nothing moves."""
    hp = jppo.PPOHyperparameters(kl_ctl=0.1)
    data = _with_advantages(_make_batch(seed=6), hp)
    jm, tm = model_pair(remat="dots")
    rule = ("importance_weight_sum", "n_action_tokens", cap)
    before = {n: p.detach().clone() for n, p in tm.module.params.items()}
    want = jm.module.train_batch(
        data, JSpec(**SPEC), jppo.PPOActorInterface(hp)._loss_fn,
        jppo._action_token_weight, token_normalize_scope=scope,
        skip_update_rule=rule)
    got = tm.module.train_batch(
        _tsample(data), TSpec(**SPEC), tppo.PPOActorInterface(_thp(hp))._loss_fn,
        tppo._action_token_weight, token_normalize_scope=scope,
        skip_update_rule=rule)
    assert set(got) == set(want)
    _assert_stats_match(got, want)
    skipped = cap < 1
    assert got["update_applied"] == float(not skipped)
    assert tm.module.opt_step_count == jm.module.opt_step_count == int(not skipped)
    assert got["total_tokens"] == int(data.total_lens().sum())
    _assert_masters_match(jm.module, tm.module, tm.module.cfg)
    if skipped:
        for n, p in tm.module.params.items():
            assert torch.equal(p.detach(), before[n]), n


def test_group_normalised_train_step_matches_reference():
    """group_adv_norm: the host path, minibatches through train_batch."""
    hp = jppo.PPOHyperparameters(ppo_n_minibatches=2, kl_ctl=0.1,
                                 group_adv_norm=True, group_size=3,
                                 use_decoupled_loss=True)
    b = _make_batch(n_seq=12, seed=7)
    batch = grouped_batch(seed=7, extra={
        "prox_logprobs": b.data["packed_logprobs"] * 0.9,
        "version_start": np.zeros(12, np.int32)})
    jm, tm = model_pair(remat="dots")
    want = jppo.PPOActorInterface(hp).train_step(jm, batch, JSpec(**SPEC))
    got = tppo.PPOActorInterface(_thp(hp)).train_step(
        tm, _tsample(batch), TSpec(**SPEC))
    assert set(got) == set(want)
    _assert_stats_match(got, want)
    assert got["n_ppo_steps"] == 2.0 and tm.module.opt_step_count == 2
    _assert_masters_match(jm.module, tm.module, tm.module.cfg)


# ---------------- generate ----------------

def test_generate_matches_reference():
    """Greedy generation through the engine and the actor interface, and
    the flattened trajectories built from it."""
    jcfg = jmodel.GenerationHyperparameters(greedy=True, max_new_tokens=6)
    hp = jppo.PPOHyperparameters(gen=jcfg, group_size=2)
    thp = dataclasses.replace(_thp(hp), gen=tmodel.GenerationHyperparameters(
        greedy=True, max_new_tokens=6))
    rng = np.random.RandomState(8)
    plens = [5, 9, 3]
    prompts = JSample.from_default(
        ids=["a", "b", "c"],
        data={"packed_prompts": rng.randint(2, 128, sum(plens)).astype(np.int32)},
        seqlens=plens)
    jm, tm = model_pair(train=False)
    want = jm.module.generate(prompts, JSpec(), dataclasses.replace(jcfg, n=2),
                              key=jax.random.PRNGKey(0))
    got = tm.module.generate(_tsample(prompts), TSpec(),
                             tmodel.GenerationHyperparameters(
                                 greedy=True, max_new_tokens=6, n=2))
    for key in ("output_ids", "output_lens"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), key)
    np.testing.assert_allclose(got["output_logprobs"],
                               np.asarray(want["output_logprobs"]), atol=1e-4)
    jt = jppo.PPOActorInterface(hp).generate(jm, prompts, JSpec())
    tt = tppo.PPOActorInterface(thp).generate(tm, _tsample(prompts), TSpec())
    assert tt.ids == jt.ids and tt.metadata == jt.metadata
    assert tt.keys == jt.keys and tt.seqlens == jt.seqlens
    for key in jt.keys:
        np.testing.assert_allclose(tt.data[key], jt.data[key], atol=1e-4,
                                   err_msg=key)


# ---------------- train-state checkpoint ----------------

def test_train_state_round_trip_is_exact(tmp_path):
    """save_train_state after one step; a fresh engine loads it; one more
    step on each gives identical masters, moments and step counts."""
    hp = tppo.PPOHyperparameters(ppo_n_minibatches=2, kl_ctl=0.1)
    opt = dict(mu_dtype="bfloat16", nu_dtype="bfloat16")
    b1, b2 = _tsample(_make_batch(seed=9)), _tsample(_make_batch(seed=10))
    _, a = model_pair(opt=opt)
    _, b = model_pair(opt=opt)
    iface = tppo.PPOActorInterface(hp)
    iface.train_step(a, b1, TSpec(**SPEC))
    nbytes = a.module.save_train_state(str(tmp_path))
    assert nbytes == sum(p.stat().st_size for p in tmp_path.iterdir())
    b.module.load_train_state(str(tmp_path))
    assert b.module.opt_step_count == a.module.opt_step_count == 2
    iface.train_step(a, b2, TSpec(**SPEC))
    tppo.PPOActorInterface(hp).train_step(b, b2, TSpec(**SPEC))
    ea, eb = a.module, b.module
    for n in ea.params:
        assert torch.equal(ea.params[n], eb.params[n]), n
        assert eb.params[n].dtype == torch.float32 and eb.params[n].is_leaf
    for ma, mb in zip(ea.optimizer.mu + ea.optimizer.nu,
                      eb.optimizer.mu + eb.optimizer.nu):
        assert mb.dtype == torch.bfloat16 and torch.equal(ma, mb)
    assert ea.opt_step_count == eb.opt_step_count == 4
    from areal_tpu_torch.base import safetensors_io as sio

    names = set(sio.load_file(str(tmp_path / "opt_state.safetensors")))
    assert names == ({f"{k}/{n}" for k in ("mu", "nu") for n in ea.params}
                     | {"opt_step_count"})
    assert set(sio.load_file(str(tmp_path / "params.safetensors"))) == set(
        ea.params)
