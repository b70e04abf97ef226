"""The port's PPO actor train step (areal_tpu_torch/backend/torch_train.py,
algorithms/ppo.py) against the reference's (JaxTrainEngine,
PPOActorInterface) on one numpy-seeded set of weights, in float32 on the CPU
at ``tiny_config`` size.

Fixtures as tests/test_uniform_prep.py builds them. Tolerances: 1e-5
relative on losses, stats and grad norms (float32, different summation
order and a different GAE scan tree); grads at 1e-5 of their largest
magnitude; updated masters at atol 2e-6 / rtol 2e-5 (one Adam step of lr
1e-3 moves a weight by ~1e-3, and the grads differ by ~1e-6 relative); the
optimizer and the lr schedule against optax at 1e-6 relative.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from areal_tpu.algorithms import ppo as jppo
from areal_tpu.api import model as jmodel
from areal_tpu.api.data import MicroBatchSpec as JSpec
from areal_tpu.backend import jax_train as jtrain
from areal_tpu.models import config as jconfig
from areal_tpu.models import hf as jhf
from areal_tpu.models import transformer as jtf
from areal_tpu_torch.algorithms import ppo as tppo
from areal_tpu_torch.api import model as tmodel
from areal_tpu_torch.api.data import MicroBatchSpec as TSpec
from areal_tpu_torch.api.data import SequenceSample as TSample
from areal_tpu_torch.api.train_config import OptimizerConfig as TOpt
from areal_tpu_torch.backend import torch_train as ttrain
from areal_tpu_torch.models import config as tconfig
from areal_tpu_torch.models.convert import params_from_jax, params_to_jax
from areal_tpu_torch.models.transformer import (
    activated_param_count,
    param_count,
)
from test_torch_model import _jparams
from test_uniform_prep import _make_batch

CFG = dict(vocab_size=128, use_attention_bias=True, tie_word_embeddings=True)
ENGINE = dict(compute_dtype="float32", length_bucket=16, rows_bucket=2,
              seqs_bucket=4)
SPEC = dict(max_tokens_per_mb=64)
NORM_SCALES = {"ln1", "ln2", "final_ln"}


def _weights(seed=0):
    jcfg = jconfig.tiny_config(**CFG)
    shapes = jhf.flatten_pytree(jax.eval_shape(
        lambda: jtf.init_params(jcfg, jax.random.PRNGKey(0))))
    rng = np.random.RandomState(seed)
    flat = {}
    for key, a in shapes.items():
        base = 1.0 if key.split("/")[-1] in NORM_SCALES else 0.0
        flat[key] = (base + 0.1 * rng.randn(*a.shape)).astype(np.float32)
    return jcfg, tconfig.tiny_config(**CFG), flat


def _engines(opt=None, **engine_kw):
    """(reference engine, port engine) from the same weights."""
    jcfg, tcfg, flat = _weights()
    opt = dict(lr=1e-3, lr_scheduler_type="constant", **(opt or {}))
    spec = jmodel.FinetuneSpec(1, 8, 4)
    jm = jtrain.JaxTrainBackend(
        optimizer=jtrain.OptimizerConfig(**opt), **ENGINE, **engine_kw,
    ).initialize(jmodel.Model("actor", (jcfg, _jparams(flat))), spec)
    tm = ttrain.TorchTrainBackend(
        optimizer=TOpt(**opt), device="cpu", **ENGINE, **engine_kw,
    ).initialize(tmodel.Model("actor", (tcfg, params_from_jax(
        flat, tcfg, device="cpu"))), tmodel.FinetuneSpec(1, 8, 4))
    return jm, tm


def _tsample(js):
    """The port's SequenceSample holding the same arrays."""
    return TSample(ids=list(js.ids), keys=set(js.keys),
                   seqlens={k: [list(s) for s in v] for k, v in js.seqlens.items()},
                   data=dict(js.data), metadata=dict(js.metadata))


def _jax_flat(params):
    return {k: np.asarray(v) for k, v in
            jhf.flatten_pytree(jax.device_get(params)).items()}


def _assert_masters_match(jeng, teng, tcfg):
    want = _jax_flat(jeng.params)
    got = params_to_jax(teng.params, tcfg)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=2e-6, rtol=2e-5,
                                   err_msg=key)


def _assert_stats_match(got, want, keys=None):
    for key in keys or want:
        assert got[key] == pytest.approx(want[key], rel=1e-5, abs=1e-7), key


def _uploaded(hp, batch, jm, tm):
    jub = jm.module.upload_uniform(batch, JSpec(**SPEC))
    tub = tm.module.upload_uniform(_tsample(batch), TSpec(**SPEC))
    jsc = jm.module.run_prep(jub, jppo.make_advantage_prep(hp), "prep",
                             scalars={"kl_coef": hp.kl_ctl})
    tsc = tm.module.run_prep(tub, tppo.make_advantage_prep(_thp(hp)),
                             scalars={"kl_coef": hp.kl_ctl})
    return jub, tub, jsc, tsc


def _thp(hp):
    return tppo.PPOHyperparameters(
        **{f.name: getattr(hp, f.name) for f in dataclasses.fields(hp)
           if f.name != "gen"})


@pytest.mark.parametrize("kl_coef,with_values", [(0.0, False), (0.1, True)])
def test_run_prep_matches_reference(kl_coef, with_values):
    hp = jppo.PPOHyperparameters(adv_norm=True, kl_ctl=kl_coef,
                                 disable_value=not with_values)
    batch = _make_batch(with_values=with_values)
    jm, tm = _engines()
    jub, tub, jsc, tsc = _uploaded(hp, batch, jm, tm)
    assert (jub.n_mbs, jub.R, jub.L, jub.S) == (tub.n_mbs, tub.R, tub.L, tub.S)
    for key in ("advantages", "returns", "kl_rewards"):
        np.testing.assert_allclose(tub.grids[key].numpy(),
                                   np.asarray(jub.grids[key]), atol=1e-5,
                                   err_msg=key)
    for key in ("_mean_kl", "_adv_scale"):
        assert float(tsc[key]) == pytest.approx(float(jsc[key]), rel=1e-5, abs=1e-7)


def _reference_grads(jeng, jub, loss_fn, weights):
    carry = None
    for i in range(jub.n_mbs):
        fn = jeng._get_sliced_grad_fn(loss_fn, carry is not None, jub.R)
        args = [jeng.params, jub.grids, jub.seq, dict(jub.grids), dict(jub.seq),
                jnp.asarray(i, jnp.int32), jnp.asarray(sum(weights), jnp.float32),
                jnp.asarray(1.0, jnp.float32), jnp.asarray(1.0, jnp.float32)]
        carry = fn(*args, *([carry] if carry is not None else []))
    return carry


@pytest.fixture(scope="module")
def reference_grads():
    """The reference's accumulated grads over every micro-batch of one
    batch (no remat, unchunked-or-not makes no difference to the numbers)."""
    hp = jppo.PPOHyperparameters(adv_norm=True, kl_ctl=0.0, disable_value=True)
    batch = _make_batch()
    jm, _ = _engines()
    jub = jm.module.upload_uniform(batch, JSpec(**SPEC))
    jm.module.run_prep(jub, jppo.make_advantage_prep(hp), "prep",
                       scalars={"kl_coef": 0.0})
    weights = [jppo._action_token_weight(mb) for mb in jub.mbs]
    loss, stats, grads = _reference_grads(
        jm.module, jub, jppo.PPOActorInterface(hp)._loss_fn, weights)
    return (hp, batch, weights, float(loss),
            {k: float(v) for k, v in stats.items()}, _jax_flat(grads))


@pytest.mark.parametrize("remat,chunk,attn", [
    (False, 8, "auto"), (True, 8, "auto"), ("dots", 8, "auto"),
    (False, None, "auto"), ("dots", None, "auto"), ("dots", 8, "flash"),
])
def test_accumulated_grads_match_reference(remat, chunk, attn, reference_grads):
    """Every remat mode, the chunked and the unchunked head, and the flash
    attention's plain forward/backward give the reference's grads."""
    hp, batch, weights, loss, stats, want = reference_grads
    _, tm = _engines(remat=remat, logprob_chunk=chunk, attn_impl=attn)
    teng = tm.module
    tub = teng.upload_uniform(_tsample(batch), TSpec(**SPEC))
    teng.run_prep(tub, tppo.make_advantage_prep(_thp(hp)),
                  scalars={"kl_coef": 0.0})
    assert weights == [tppo._action_token_weight(mb) for mb in tub.mbs]
    tl, tstats = teng.accumulate_grads(tub, tppo.PPOActorInterface(_thp(hp))._loss_fn,
                               list(range(tub.n_mbs)), weights, True)
    assert float(tl) == pytest.approx(loss, rel=1e-5)
    _assert_stats_match({k: float(v) for k, v in tstats.items()}, stats)
    got = params_to_jax({n: p.grad for n, p in teng.params.items()},
                        teng.cfg)
    for key in want:
        scale = max(np.abs(want[key]).max(), 1e-12)
        np.testing.assert_allclose(got[key], want[key], atol=1e-5 * scale,
                                   err_msg=key)


def test_train_uniform_matches_reference():
    hp = jppo.PPOHyperparameters(adv_norm=True, kl_ctl=0.1, disable_value=True)
    batch = _make_batch(seed=3)
    jm, tm = _engines(remat="dots")
    jub, tub, _, _ = _uploaded(hp, batch, jm, tm)
    rule = ("importance_weight_sum", "n_action_tokens", 5.0)
    jstats = jm.module.train_uniform(
        jub, jppo.PPOActorInterface(hp)._loss_fn, jppo._action_token_weight,
        skip_update_rule=rule)
    tstats = tm.module.train_uniform(
        tub, tppo.PPOActorInterface(_thp(hp))._loss_fn,
        tppo._action_token_weight, skip_update_rule=rule)
    assert set(tstats) == set(jstats)
    _assert_stats_match(tstats, jstats)
    assert tstats["update_applied"] == 1.0 and tstats["grad_norm"] > 0
    assert tm.module.opt_step_count == jm.module.opt_step_count == 1
    _assert_masters_match(jm.module, tm.module, tm.module.cfg)


@pytest.mark.parametrize("n_minibatches,cap", [(2, 5.0), (2, 1e-3)])
def test_ppo_train_step_matches_reference(n_minibatches, cap, caplog):
    """Two PPO minibatches, each one optimizer step; with a tiny cap the
    skip rule stops the loop after the first (skipped) update."""
    hp = jppo.PPOHyperparameters(ppo_n_minibatches=n_minibatches,
                                 adv_norm=True, kl_ctl=0.1,
                                 disable_value=True, early_stop_imp_ratio=cap)
    batch = _make_batch(n_seq=12, seed=5)
    jm, tm = _engines(remat="dots")
    spec_j, spec_t = JSpec(**SPEC), TSpec(**SPEC)
    jstats = jppo.PPOActorInterface(hp).train_step(jm, batch, spec_j)
    with caplog.at_level(logging.WARNING):
        tstats = tppo.PPOActorInterface(_thp(hp)).train_step(
            tm, _tsample(batch), spec_t)
    assert set(tstats) == set(jstats)
    _assert_stats_match(tstats, jstats)
    assert tm.version.global_step == jm.version.global_step == 1
    assert tm.module.opt_step_count == jm.module.opt_step_count
    skipped = cap < 1
    assert tstats["n_ppo_steps"] == (1.0 if skipped else 2.0)
    assert ("early-stopping" in caplog.text) == skipped
    _assert_masters_match(jm.module, tm.module, tm.module.cfg)


def test_group_adv_norm_waits_for_the_host_path(monkeypatch):
    """group_adv_norm takes the host advantage path: no device prep, one
    train_batch per PPO minibatch (its parity with the reference is in
    tests/test_torch_trainer.py)."""
    _, tm = _engines()
    eng = tm.module
    calls = []
    monkeypatch.setattr(eng, "run_prep", lambda *a, **k: pytest.fail("prep"))
    train_batch = eng.train_batch
    monkeypatch.setattr(eng, "train_batch",
                        lambda *a, **k: calls.append(a[0].bs) or train_batch(*a, **k))
    iface = tppo.PPOActorInterface(group_adv_norm=True, ppo_n_minibatches=2)
    stats = iface.train_step(tm, _tsample(_make_batch()), TSpec(**SPEC))
    assert len(calls) == stats["n_ppo_steps"] == 2 and sum(calls) == 9
    assert eng.opt_step_count == 2


@pytest.mark.parametrize("kind,warmup", [
    ("constant", 0.0), ("constant", 0.2), ("cosine", 0.1), ("linear", 0.3),
])
def test_lr_schedule_matches_reference(kind, warmup):
    kw = dict(lr=3e-4, lr_scheduler_type=kind, warmup_steps_proportion=warmup,
              min_lr_ratio=0.1)
    want = jtrain.build_lr_schedule(jtrain.OptimizerConfig(**kw), 20)
    got = ttrain.build_lr_schedule(TOpt(**kw), 20)
    for step in (0, 1, 2, 3, 5, 8, 13, 19, 20, 25):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("kw", [
    dict(),  # f32 moments, no clipping reached
    dict(mu_dtype="bfloat16", nu_dtype="bfloat16", gradient_clipping=0.5),
    dict(type="sgd", gradient_clipping=0.5),
])
def test_optimizer_matches_optax(kw):
    """Three updates of the hand-written chain against the reference's optax
    chain from the same params and grads."""
    cfg = dict(lr=1e-2, weight_decay=0.1, lr_scheduler_type="cosine",
               warmup_steps_proportion=0.0, **kw)
    rng = np.random.RandomState(0)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[0.3 * rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    tx, _ = jtrain.build_optimizer(jtrain.OptimizerConfig(**cfg), 10)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = ttrain.Optimizer(TOpt(**cfg), tp, 10)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        tg = [torch.from_numpy(x.copy()) for x in g]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tg)))
        opt.step(tp, tg, norm, float(norm))
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    assert opt.count == 3
    if "mu_dtype" in kw:
        assert opt.mu[0].dtype == torch.bfloat16 == opt.nu[0].dtype


def test_param_counts_match_reference():
    for kw in (CFG, dict(moe=dict(num_experts=4, top_k=2))):
        want = jtf.param_count(jconfig.tiny_config(**kw))
        assert param_count(tconfig.tiny_config(**kw)) == want
        assert activated_param_count(tconfig.tiny_config(**kw)) == \
            jtf.activated_param_count(jconfig.tiny_config(**kw))


def test_engine_needs_a_device():
    _, tcfg, flat = _weights()
    params = params_from_jax(flat, tcfg, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.TorchTrainEngine(tcfg, params, opt_cfg=TOpt())
    with pytest.raises(KeyError):
        ttrain.TorchTrainEngine(tcfg, {**params, "extra": params["final_ln.weight"]},
                                device="cpu")


def test_dots_remat_saves_matmul_outputs():
    """Under "dots" the backward reruns no matrix product of the layers
    (their outputs were saved); under full remat it reruns them all."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from areal_tpu_torch.models.transformer import Transformer, init_params

    class CountMatmuls(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
                self.n += 1
            return func(*args, **(kwargs or {}))

    tcfg = tconfig.tiny_config(**CFG)
    params = init_params(tcfg, seed=0, device="cpu")
    model = Transformer.from_params(
        tcfg, {k: v.requires_grad_() for k, v in params.items()})
    tokens = torch.randint(0, tcfg.vocab_size, (2, 16))
    positions = torch.arange(16).expand(2, 16)
    seg = torch.ones(2, 16, dtype=torch.int32)
    counts = {}
    for remat in (False, True, "dots"):
        h, kv = model(tokens, positions, seg, remat=remat, return_kv=False,
                      return_hidden=True)
        assert kv is None
        mode = CountMatmuls()
        with mode:
            h.sum().backward()
        counts[remat] = mode.n
    assert counts["dots"] == counts[False] < counts[True]
    with pytest.raises(ValueError):
        model(tokens, positions, seg, remat="dots")  # still returns K/V
