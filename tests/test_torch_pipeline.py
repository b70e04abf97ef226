"""The port's pipeline parallelism against the JAX package's.

Twin of ``tests/test_pipeline.py``. The reference pipelines over its
virtual 8-device CPU mesh; the port's pipeline here runs every stage in
this process (``PipeCtx(stage=None)``, the one-process stage driver the
card uses), on the same per-stage loops as its one-process-per-stage form
over gloo, which ``tests/test_torch_parallel.py`` drives through the train
engine (``p2``, ``p2s2``, ``d2p2t2``). The reference's weights, drawn from
its own seeds, go into the port through ``convert.params_from_jax``;
everything is float32 on the CPU.
"""

import numpy as np
import pytest
import torch

from areal_tpu_torch.models import config as tconfig
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.models.transformer import Transformer, rope_tables
from areal_tpu_torch.parallel import mesh as tmesh
from areal_tpu_torch.parallel import pipeline as tppl
from areal_tpu_torch.parallel.ring import RingCtx

KW = dict(n_layers=4, hidden_dim=32, n_q_heads=4, n_kv_heads=2)
MOE = dict(num_experts=4, top_k=2, capacity_factor=2.0)


def _batch(vocab, B=8, T=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, T)).astype(np.int32)
    positions = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    seg = np.ones((B, T), np.int32)
    seg[:, T // 2:] = 2  # two documents a row
    seg[-1, T - 3:] = 0  # a padded tail
    return tokens, positions, seg


def _models(seed, moe=False, **kw):
    """The reference's params and config, and the port's model over the
    same weights (parameters requiring grad)."""
    import jax

    from areal_tpu.models import config as jconfig
    from areal_tpu.models import hf as jhf
    from areal_tpu.models import transformer as jtf

    kw = dict(KW, **kw)
    if moe:
        kw["moe"] = jconfig.MoEConfig(**MOE)
    jcfg = jconfig.tiny_config(**kw)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    if moe:
        kw["moe"] = MOE
    cfg = tconfig.tiny_config(**kw)
    flat = jhf.flatten_pytree(params, as_numpy=True)
    model = Transformer.from_params(cfg, {
        k: v.requires_grad_() for k, v in
        params_from_jax(flat, cfg, device="cpu").items()})
    return jcfg, params, cfg, model


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _ref_grads_in_port_layout(grads, cfg):
    from areal_tpu.models import hf as jhf

    return params_from_jax(jhf.flatten_pytree(grads, as_numpy=True), cfg,
                           device="cpu")


def _port_loss(model, batch, **kw):
    tokens, positions, seg = _torch(*batch)
    out, _ = model(tokens.long(), positions, seg, return_kv=False, **kw)
    mask = (seg > 0).float()
    return (torch.tanh(out.float()) ** 2 * mask[..., None]).sum(), out


def _port_grads(model, batch, **kw):
    for p in model.parameters():
        p.grad = None
    loss, out = _port_loss(model, batch, **kw)
    loss.backward()
    return loss.item(), out.detach().numpy(), {
        n: p.grad.clone() for n, p in model.named_parameters()}


def _layer_call(model, cfg, batch, ctx, n_micro, remat=False, ring=None):
    """pipeline_apply_layers on the raw layer stack (the reference test's
    ``_pipeline_call``): the schedule alone, no final norm or head."""
    tokens, positions, seg = _torch(*batch)
    h = model.embedding(tokens.long())
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rotary_base)
    return tppl.pipeline_apply_layers(cfg, model.layers, h, cos, sin, seg,
                                      positions, ctx, n_micro, remat=remat,
                                      ring=ring)


GATE_SPECS = ("p2", "p4", "d2p2t2", "p2s2", "p2s2t2", "d2f2t2")


@pytest.mark.parametrize("spec", GATE_SPECS)
def test_pick_pp_microbatches_gates(spec):
    """The port's gate on a ``ParallelSpec`` returns what the reference's
    does on its mesh of the same shape, case by case."""
    from areal_tpu.models import config as jconfig
    from areal_tpu.parallel import mesh as jmesh
    from areal_tpu.parallel import pipeline as jppl

    jm = jmesh.make_mesh(jmesh.ParallelSpec.parse(spec))
    tm = tmesh.ParallelSpec.parse(spec)
    for n_layers in (4, 3):
        jcfg = jconfig.tiny_config(n_layers=n_layers)
        cfg = tconfig.tiny_config(n_layers=n_layers)
        for batch, requested, seq_len in [
                (8, None, None), (6, None, 32), (8, 2, 32), (8, 3, 32),
                (1, None, 32), (8, None, 31), (8, None, 32)]:
            want = jppl.pick_pp_microbatches(jm, jcfg, batch, requested,
                                             seq_len=seq_len)
            got = tppl.pick_pp_microbatches(tm, cfg, batch, requested,
                                            seq_len=seq_len)
            assert got == want, (spec, n_layers, batch, requested, seq_len)
            if seq_len is not None:
                assert tppl.pp_engagement(tm, cfg, batch, seq_len, requested) \
                    == jppl.pp_engagement(jm, jcfg, batch, seq_len, requested)
    assert tppl.pick_pp_microbatches(None, cfg, 8) is None


@pytest.mark.parametrize("spec", ["p2", "p4", "d2p2t2"])
def test_pipeline_forward_parity(spec):
    """The port's pipelined logits (``pp`` one-process stages, the
    reference's auto micro-batch count) equal the reference's pipelined
    forward on its mesh and its single-device forward."""
    import jax

    from areal_tpu.models import transformer as jtf
    from areal_tpu.parallel import mesh as jmesh
    from areal_tpu.parallel import sharding as jsh

    jcfg, params, cfg, model = _models(0)
    batch = _batch(cfg.vocab_size)
    ref, _ = jtf.forward(params, jcfg, *batch[:2], segment_ids=batch[2],
                         return_kv=False)
    m = jmesh.make_mesh(jmesh.ParallelSpec.parse(spec))
    sharded = jsh.shard_params(params, m, jcfg)

    def fwd(p, t, pos, s):
        with jsh.activation_sharding(m):
            return jtf.forward(p, jcfg, t, pos, segment_ids=s,
                               return_kv=False)[0]

    ref_pp = np.asarray(jax.jit(fwd)(sharded, *batch))
    pp = tmesh.ParallelSpec.parse(spec).pp
    with torch.no_grad():
        _, out = _port_loss(model, batch, pipeline=tppl.PipeCtx(pp))
    np.testing.assert_allclose(out.numpy(), ref_pp, atol=2e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)


def test_pipeline_grad_parity():
    """The 1F1B backward over 4 stages gives the reference's gradient
    through its pipeline, at its tolerance."""
    import jax
    import jax.numpy as jnp

    from areal_tpu.models import transformer as jtf
    from areal_tpu.parallel import mesh as jmesh
    from areal_tpu.parallel import sharding as jsh

    jcfg, params, cfg, model = _models(1)
    tokens, positions, seg = batch = _batch(cfg.vocab_size, seed=1)
    m = jmesh.make_mesh(jmesh.ParallelSpec.parse("p4"))

    def loss(p):
        with jsh.activation_sharding(m):
            logits, _ = jtf.forward(p, jcfg, tokens, positions,
                                    segment_ids=seg, return_kv=False)
        mask = (seg > 0).astype(jnp.float32)
        return jnp.sum(jnp.tanh(logits.astype(jnp.float32)) ** 2
                       * mask[..., None])

    g_ref = _ref_grads_in_port_layout(
        jax.jit(jax.grad(loss))(jsh.shard_params(params, m, jcfg)), cfg)
    _, _, g = _port_grads(model, batch, pipeline=tppl.PipeCtx(4))
    assert set(g) == set(g_ref)
    for n in g_ref:
        np.testing.assert_allclose(g[n].numpy(), g_ref[n].numpy(),
                                   atol=5e-3, rtol=1e-3, err_msg=n)


def test_pipeline_remat_parity():
    """Remat inside the stages (each layer recomputed in the 1F1B
    backward's recompute) keeps the reference's logits and the port's own
    unpipelined gradients."""
    from areal_tpu.models import transformer as jtf

    jcfg, params, cfg, model = _models(2, n_layers=2)
    batch = _batch(cfg.vocab_size, seed=2)
    ref, _ = jtf.forward(params, jcfg, *batch[:2], segment_ids=batch[2],
                         return_kv=False)
    _, want_out, want = _port_grads(model, batch)
    _, out, g = _port_grads(model, batch, pipeline=tppl.PipeCtx(2),
                            remat=True)
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-4)
    np.testing.assert_allclose(out, want_out, atol=1e-6)
    for n in want:
        np.testing.assert_allclose(g[n].numpy(), want[n].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=n)


@pytest.mark.parametrize("remat", [False, True])
def test_1f1b_matches_gpipe_oracle(remat):
    """The recomputing 1F1B backward reproduces the GPipe oracle's saved
    graphs, outputs and gradients, in the bubble-heavy case n_micro == pp,
    and the outputs match the reference's 1F1B schedule."""
    import jax

    from areal_tpu.models import transformer as jtf
    from areal_tpu.parallel import mesh as jmesh
    from areal_tpu.parallel import pipeline as jppl
    from areal_tpu.parallel import sharding as jsh

    jcfg, params, cfg, model = _models(4)
    tokens, positions, seg = batch = _batch(cfg.vocab_size, seed=4)
    outs, grads = {}, {}
    for sched in ("gpipe", "1f1b"):
        for p in model.parameters():
            p.grad = None
        out, _ = _layer_call(model, cfg, batch, tppl.PipeCtx(2,
                             schedule=sched), 2, remat=remat)
        mask = torch.from_numpy(seg > 0).float()
        (torch.tanh(out) ** 2 * mask[..., None]).sum().backward()
        outs[sched] = out.detach().numpy()
        grads[sched] = {n: p.grad.clone() for n, p in model.named_parameters()
                        if p.grad is not None}
    assert set(grads["1f1b"]) == set(grads["gpipe"])
    np.testing.assert_allclose(outs["1f1b"], outs["gpipe"], atol=1e-5)
    for n, g in grads["gpipe"].items():
        np.testing.assert_allclose(grads["1f1b"][n].numpy(), g.numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=n)
    m = jmesh.make_mesh(jmesh.ParallelSpec.parse("p2"))

    def fwd(p):
        with jsh.activation_sharding(m):
            h = p["embedding"][tokens]
            cos, sin = jtf.rope_tables(positions, jcfg.head_dim,
                                       jcfg.rotary_base)
            return jppl.pipeline_apply_layers(
                jcfg, p["layers"], h, cos, sin, seg, positions, m, 2,
                remat=remat, schedule="1f1b")[0]

    ref = jax.jit(fwd)(jsh.shard_params(params, m, jcfg))
    np.testing.assert_allclose(outs["1f1b"], np.asarray(ref), atol=1e-5)


def test_1f1b_matches_gpipe_moe_aux():
    """MoE aux totals and their gradient agree between the schedules (the
    aux cotangent rides the 1F1B backward), the aux equals the reference's
    1F1B aux, and the gradients equal the micro-batched unpipelined
    loss's."""
    import jax

    from areal_tpu.parallel import mesh as jmesh
    from areal_tpu.parallel import pipeline as jppl
    from areal_tpu.parallel import sharding as jsh
    from areal_tpu.models import transformer as jtf

    jcfg, params, cfg, model = _models(5, moe=True)
    tokens, positions, seg = batch = _batch(cfg.vocab_size, seed=5)
    mask = torch.from_numpy(seg > 0).float()
    n_micro = 4
    res = {}
    for sched in ("gpipe", "1f1b"):
        for p in model.parameters():
            p.grad = None
        out, aux = _layer_call(model, cfg, batch, tppl.PipeCtx(
            2, schedule=sched), n_micro)
        loss = (torch.tanh(out) ** 2 * mask[..., None]).sum() \
            + 0.1 * aux["aux_total"]
        loss.backward()
        res[sched] = (loss.item(), {k: v.item() for k, v in aux.items()},
                      {n: p.grad.clone() for n, p in model.named_parameters()
                       if p.grad is not None})
    assert res["1f1b"][0] == pytest.approx(res["gpipe"][0], rel=1e-5)
    assert set(res["1f1b"][1]) == set(tppl._aux_keys(cfg))
    for k, v in res["gpipe"][1].items():
        assert res["1f1b"][1][k] == pytest.approx(v, rel=1e-5, abs=1e-6)
    m = jmesh.make_mesh(jmesh.ParallelSpec.parse("p2"))

    def fwd(p):
        with jsh.activation_sharding(m):
            h = p["embedding"][tokens]
            cos, sin = jtf.rope_tables(positions, jcfg.head_dim,
                                       jcfg.rotary_base)
            return jppl.pipeline_apply_layers(
                jcfg, p["layers"], h, cos, sin, seg, positions, m, n_micro,
                schedule="1f1b")[1]

    ref_aux = jax.device_get(jax.jit(fwd)(jsh.shard_params(params, m, jcfg)))
    for k, v in ref_aux.items():
        assert res["1f1b"][1][k] == pytest.approx(float(v), rel=1e-5,
                                                  abs=1e-6), k
    # the micro-batched, unpipelined reference loss in the port
    for p in model.parameters():
        p.grad = None
    mb = tokens.shape[0] // n_micro
    total = 0.0
    for i in range(n_micro):
        sl = slice(i * mb, (i + 1) * mb)
        t, pos, s = _torch(tokens[sl], positions[sl], seg[sl])
        h = _stack(model, cfg, t.long(), pos, s)
        total = total + (torch.tanh(h[0]) ** 2
                         * (s > 0).float()[..., None]).sum() \
            + 0.1 * h[1] / n_micro
    total.backward()
    assert set(res["1f1b"][2]) == {n for n, p in model.named_parameters()
                                   if p.grad is not None}
    for n, p in model.named_parameters():
        if p.grad is None:
            continue
        np.testing.assert_allclose(res["1f1b"][2][n].numpy(),
                                   p.grad.numpy(), atol=5e-4, rtol=1e-3,
                                   err_msg=n)


def _stack(model, cfg, tokens, positions, seg):
    """The layer stack without a pipeline: (h, aux_total)."""
    h = model.embedding(tokens)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rotary_base)
    auxes = []
    for layer in model.layers:
        h, _, aux = layer(h, cos, sin, seg, positions, None, None, None,
                          "auto")
        auxes.append(aux["aux_total"])
    return h, torch.stack(auxes).sum()


@pytest.mark.parametrize("pp,n_micro", [(2, 4), (4, 4), (2, 8)])
def test_1f1b_backward_residuals_scale_with_n_micro(pp, n_micro):
    """The 1F1B forward keeps exactly each stage's n_micro micro-batch
    inputs, measured from what it saved: B·T·D·4 bytes a stage whatever
    the depth, as the reference measures from its abstract shapes."""
    from areal_tpu.models import transformer as jtf
    from areal_tpu.parallel import mesh as jmesh
    from areal_tpu.parallel import pipeline as jppl
    from areal_tpu.parallel import sharding as jsh

    import jax.numpy as jnp

    jcfg, params, cfg, model = _models(6)
    tokens, positions, seg = _batch(cfg.vocab_size, seed=0)
    seg = np.ones_like(seg)
    m = jmesh.make_mesh(jmesh.ParallelSpec.parse(f"p{pp}"))
    h = params["embedding"][jnp.asarray(tokens)]
    cos, sin = jtf.rope_tables(jnp.asarray(positions), jcfg.head_dim,
                               jcfg.rotary_base)
    want = jppl.backward_residual_bytes(
        jcfg, jsh.shard_params(params, m, jcfg)["layers"], h, cos, sin,
        jnp.asarray(seg), jnp.asarray(positions), m, n_micro)
    t, pos, s = _torch(tokens, positions, seg)
    with torch.no_grad():
        th = model.embedding(t.long())
        tc, ts = rope_tables(pos, cfg.head_dim, cfg.rotary_base)
        got = tppl.backward_residual_bytes(
            cfg, model.layers, th, tc, ts, s, pos, tppl.PipeCtx(pp), n_micro)
    B, T = tokens.shape
    assert got == want == B * T * cfg.hidden_dim * 4


@pytest.mark.ring
@pytest.mark.parametrize("ring_schedule", ["zigzag", "naive"])
@pytest.mark.parametrize("sched", ["1f1b", "gpipe"])
def test_ppsp_matches_gspmd_oracle(sched, ring_schedule):
    """PP∘SP: 2 stages with a ring of 2 inside each (the model's layout at
    its boundary) reproduce the reference's dense loss and gradients at
    the pipeline tolerances, for both pipeline and both ring schedules."""
    import jax
    import jax.numpy as jnp

    from areal_tpu.models import transformer as jtf

    jcfg, params, cfg, model = _models(7)
    tokens, positions, seg = batch = _batch(cfg.vocab_size, seed=7)
    mask = (jnp.asarray(seg) > 0).astype(jnp.float32)

    def dense_loss(p):
        out, _ = jtf.forward(p, jcfg, tokens, positions, segment_ids=seg,
                             return_kv=False)
        return jnp.sum(jnp.tanh(out.astype(jnp.float32)) ** 2
                       * mask[..., None])

    v_ref, g_ref = jax.jit(jax.value_and_grad(dense_loss))(params)
    g_ref = _ref_grads_in_port_layout(g_ref, cfg)
    assert tppl.pick_pp_microbatches(tmesh.ParallelSpec(pp=2, sp=2), cfg,
                                     tokens.shape[0],
                                     seq_len=tokens.shape[1]) is not None
    loss, _, g = _port_grads(
        model, batch, pipeline=tppl.PipeCtx(2, schedule=sched, sp=2),
        ring=RingCtx(2, schedule=ring_schedule))
    assert loss == pytest.approx(float(v_ref), rel=1e-5)
    for n in g_ref:
        np.testing.assert_allclose(g[n].numpy(), g_ref[n].numpy(),
                                   atol=5e-3, rtol=1e-3, err_msg=n)


@pytest.mark.ring
def test_backward_residuals_invariant_to_sp():
    """A ring inside the stages does not change the 1F1B residual
    accounting: the same n_micro whole micro-batch inputs a stage."""
    jcfg, params, cfg, model = _models(6)
    tokens, positions, seg = _batch(cfg.vocab_size)
    t, pos, s = _torch(tokens, positions, np.ones_like(seg))

    def measure(sp):
        ring = RingCtx(sp) if sp > 1 else None
        with torch.no_grad():
            th = model.embedding(t.long())
            tc, ts = rope_tables(pos, cfg.head_dim, cfg.rotary_base)
            return tppl.backward_residual_bytes(
                cfg, model.layers, th, tc, ts, s, pos,
                tppl.PipeCtx(2, sp=sp), 4, ring=ring)

    base = measure(1)
    assert base == tokens.size * cfg.hidden_dim * 4
    assert measure(2) == base
    assert measure(4) == base


def test_pipeline_moe_aux_parity():
    """An MoE model pipelines through the model's forward: its logits are
    the reference's, and its scalar aux equals the reference's
    micro-batched aux (bubbles never count); the vector ``expert_load``
    does not pipeline, as in the reference."""
    from areal_tpu.models import transformer as jtf

    jcfg, params, cfg, model = _models(3, moe=True)
    tokens, positions, seg = _batch(cfg.vocab_size, seed=3)
    ref, _, _ = jtf.forward(params, jcfg, tokens, positions,
                            segment_ids=seg, return_kv=False,
                            return_aux=True)
    n_micro = tppl.pick_pp_microbatches(tmesh.ParallelSpec(pp=2), cfg,
                                        tokens.shape[0])
    mb = tokens.shape[0] // n_micro
    aux_ref = None
    for i in range(n_micro):
        sl = slice(i * mb, (i + 1) * mb)
        _, _, a = jtf.forward(params, jcfg, tokens[sl], positions[sl],
                              segment_ids=seg[sl], return_kv=False,
                              return_aux=True)
        aux_ref = a if aux_ref is None else {k: aux_ref[k] + a[k] for k in a}
    aux_ref = {k: v / n_micro for k, v in aux_ref.items()}
    t, pos, s = _torch(tokens, positions, seg)
    with torch.no_grad():
        out, _, aux = model(t.long(), pos, s, return_kv=False,
                            return_aux=True, pipeline=tppl.PipeCtx(2))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3,
                               rtol=2e-3)
    assert set(aux) == set(tppl._aux_keys(cfg)) < set(aux_ref)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(aux_ref[k]),
                                   atol=1e-4, rtol=2e-3, err_msg=k)


def test_fallback_runs_the_stages_in_order_and_warns_once(monkeypatch):
    """Where a gate fails (one row for two stages), the stages run in
    order as one micro-batch, the counter names the reason and the
    warning comes once; the result is the unpipelined model's."""
    jcfg, params, cfg, model = _models(8)
    batch = [a[:1] for a in _batch(cfg.vocab_size, seed=8)]
    tppl._WARNED_FALLBACKS.discard("batch_too_small")
    counts, warned = [], []
    monkeypatch.setattr(tppl.telemetry, "inc",
                        lambda name, n=1.0: counts.append(name))
    monkeypatch.setattr(tppl.logger, "warning",
                        lambda *a: warned.append(a[1]))
    _, want, g_want = _port_grads(model, batch)
    for _ in range(2):
        _, out, g = _port_grads(model, batch, pipeline=tppl.PipeCtx(2))
    assert counts == ["parallel/pp_fallback{reason=batch_too_small}"] * 2
    assert warned == ["batch_too_small"]
    np.testing.assert_allclose(out, want, atol=1e-6)
    for n in g_want:
        np.testing.assert_allclose(g[n].numpy(), g_want[n].numpy(),
                                   atol=1e-6, err_msg=n)
