"""The port's fused forward node (areal_tpu_torch/algorithms/fused.py) and
the sync recipe's ``fuse_rew_ref`` against the reference's
(areal_tpu/algorithms/fused.py, experiments/ppo_math_exp.py) on one
numpy-seeded set of weights and the same records, in float32 on the CPU at
``tiny_config`` size.

Tolerances: in each package the fused node's output equals its children
run alone exactly (the same engine, the same inputs); across the packages
the reference log-probs within 1e-5 relative (float32, a different
summation order, as tests/test_torch_trainer.py) and the rewards exactly.
"""

import threading

import numpy as np
import pytest

from areal_tpu.algorithms import fused as jfused
from areal_tpu.algorithms import ppo as jppo  # noqa: F401 (registers)
from areal_tpu.algorithms import reward as jreward  # noqa: F401 (registers)
from areal_tpu.api import cli_args as JCA
from areal_tpu.api.data import MicroBatchSpec as JSpec
from areal_tpu.api.data import SequenceSample as JSample
from areal_tpu.api.model import make_interface as jmake
from areal_tpu.base.testing import MockTokenizer
from areal_tpu.experiments.ppo_math_exp import PPOMATHConfig as JPPOConfig
from areal_tpu_torch.algorithms import fused as tfused
from areal_tpu_torch.algorithms import ppo as tppo  # noqa: F401 (registers)
from areal_tpu_torch.algorithms import reward as treward  # noqa: F401
from areal_tpu_torch.api import cli_args as TCA
from areal_tpu_torch.api.data import MicroBatchSpec as TSpec
from areal_tpu_torch.api.model import make_interface as tmake
from areal_tpu_torch.base.testing import MockTokenizer as TMockTokenizer
from areal_tpu_torch.base.testing import make_math_jsonl
from areal_tpu_torch.experiments.ppo_math_exp import (
    PPOMATHConfig as TPPOConfig,
)
from areal_tpu_torch.ops import flash_attention as fa
from test_torch_train import _tsample
from test_torch_trainer import model_pair

SPEC = dict(max_tokens_per_mb=256)


def trajectories(path, n_prompts=4, group=2, seed=0):
    """Math trajectories of seeded prompts: the first sample of each group
    answers right, the other wrong; ids "qid@k"."""
    tok = MockTokenizer()
    records = make_math_jsonl(path, n=n_prompts, seed=seed)
    samples = []
    for r in records:
        truth = r["solutions"][0]
        for k in range(group):
            p = tok.encode(r["prompt"])
            a = tok.encode(truth if k == 0 else "\\boxed{-1}")
            samples.append(JSample.from_default(
                ids=[f"{r['query_id']}@{k}"],
                data={"packed_input_ids": np.asarray(p + a, np.int32),
                      "prompt_mask": np.asarray([1] * len(p) + [0] * len(a),
                                                np.int32)},
                seqlens=[len(p) + len(a)]))
    return JSample.gather(samples)


def _children(path):
    return {"rew": ("rw_math_code", {"dataset_path": path,
                                     "group_size": 2}),
            "ref": ("ref_logprob", {})}


def test_fused_node_equals_its_children(tmp_path):
    path = str(tmp_path / "math.jsonl")
    batch = trajectories(path)
    jm, tm = model_pair(train=False, cfg_kw=dict(vocab_size=258))
    jm.tokenizer, tm.tokenizer = MockTokenizer(), TMockTokenizer()
    kids = _children(path)
    out = {}
    for pkg, m, make, fused, data, spec in (
            ("ref", jm, jmake, jfused.FusedForwardInterface, batch,
             JSpec(**SPEC)),
            ("port", tm, tmake, tfused.FusedForwardInterface,
             _tsample(batch), TSpec(**SPEC))):
        got = fused(interfaces=kids).inference(m, data, spec)
        alone = {k: make(name, **kw).inference(m, data, spec)
                 for k, (name, kw) in kids.items()}
        assert got.ids == data.ids
        assert got.keys == {"rewards", "packed_ref_logprobs"}
        np.testing.assert_array_equal(got.data["rewards"],
                                      alone["rew"].data["rewards"])
        np.testing.assert_array_equal(
            got.data["packed_ref_logprobs"],
            alone["ref"].data["packed_ref_logprobs"])
        out[pkg] = got
    np.testing.assert_array_equal(out["port"].data["rewards"],
                                  out["ref"].data["rewards"])
    assert out["port"].data["rewards"].tolist() == [1.0, 0.0] * 4
    np.testing.assert_allclose(out["port"].data["packed_ref_logprobs"],
                               out["ref"].data["packed_ref_logprobs"],
                               rtol=1e-5, atol=1e-6)
    assert tfused.FusedForwardInterface is type(tmake(
        "fused-threading", interfaces=kids))


def test_fused_children_keep_no_gradient_state(tmp_path):
    """Grad mode is thread-local: the reference child runs in a pool
    thread on a train engine's f32 masters and leaves no graph and no
    ``.grad``."""
    import torch

    path = str(tmp_path / "math.jsonl")
    batch = _tsample(trajectories(path))
    _, tm = model_pair(train=True, cfg_kw=dict(vocab_size=258))
    tm.tokenizer = TMockTokenizer()
    eng, seen = tm.module, []
    fwd = eng._forward_token_logprobs

    def recording(*a, **k):
        out = fwd(*a, **k)
        seen.append((threading.current_thread() is threading.main_thread(),
                     torch.is_grad_enabled(), out.requires_grad))
        return out

    eng._forward_token_logprobs = recording
    assert torch.is_grad_enabled()
    out = tfused.FusedForwardInterface(interfaces=_children(path)).inference(
        tm, batch, TSpec(**SPEC))
    assert seen and all(s == (False, False, False) for s in seen), seen
    assert all(p.grad is None for p in eng.params.values())
    assert out.data["packed_ref_logprobs"].shape == (
        int(batch.total_lens().sum()),)


def test_launch_counter_is_thread_safe(monkeypatch):
    """The kernels' launch counts add up when threads launch at once (the
    fused node's children run in a pool)."""
    import types

    fn = next(iter(fa._SIGNATURES))
    lib = types.SimpleNamespace(**{fn: lambda *a: 0})
    monkeypatch.setattr(fa, "_library", lambda name: lib)
    fa.reset_launch_count()
    n, per = 8, 5000

    def bump():
        for _ in range(per):
            fa._call(fn, "flash_attention_fwd")

    ts = [threading.Thread(target=bump) for _ in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert fa.launch_count("flash_attention_fwd") == n * per
    fa.reset_launch_count()
    assert fa.launch_counts()["flash_attention_fwd"] == 0


def _node_view(dfg):
    return {name: (n.model_name, n.interface_type.name,
                   n.interface_impl.type_, tuple(n.input_keys),
                   tuple(n.output_keys), n.n_seqs,
                   [type(h).__name__ for h in n.post_hooks])
            for name, n in dfg.nodes.items()}


OVERRIDES = ["trial_name=t0", "mock_tokenizer=true",
             "actor.tiny.vocab_size=258", "ref.tiny.vocab_size=258",
             "dataset.path=/nonexistent/none.jsonl",
             "dataset.train_bs_n_seqs=4", "group_size=2"]


@pytest.mark.parametrize("extra", [
    ["ppo.disable_value=true", "ppo.kl_ctl=0.05", "fuse_rew_ref=true"],
    ["ppo.disable_value=false", "ppo.kl_ctl=0.05", "fuse_rew_ref=true",
     "ppo.use_decoupled_loss=true"],
    # no reference model: nothing to fuse
    ["ppo.disable_value=true", "ppo.kl_ctl=0.0", "fuse_rew_ref=true"],
])
def test_fuse_rew_ref_graph_matches_reference(extra):
    """tests/test_experiments.py:57's graph in both packages."""
    jcfg, tcfg = JPPOConfig(), TPPOConfig()
    JCA.apply_overrides(jcfg, OVERRIDES + extra)
    TCA.apply_overrides(tcfg, OVERRIDES + extra)
    assert _node_view(tcfg.build_dfg(4)) == _node_view(jcfg.build_dfg(4))
    jt, tt = jcfg.build_trainer_config(), tcfg.build_trainer_config()
    assert set(tt.models) == set(jt.models)
    assert {k: (m.interface, m.model_name) for k, m in tt.mfcs.items()} == \
        {k: (m.interface, m.model_name) for k, m in jt.mfcs.items()}
    if "fused_rew_ref_inf" in jt.mfcs:
        assert "rew" not in tt.models and "ref" in tt.models
        assert (tt.mfcs["fused_rew_ref_inf"].interface_args
                == jt.mfcs["fused_rew_ref_inf"].interface_args)
    # async mode never fuses
    assert "fused_rew_ref_inf" not in tcfg.build_dfg(4, async_mode=True).nodes


def _actor_train_inputs_probe(out_path, worker):
    """The trainer's MFCs in order, and each actor_train input's rewards
    and reference log-probs per sample id, written to ``out_path`` after
    the run."""
    handle, seen = worker._handle_mfc, {"mfcs": [], "samples": {}}

    def recording(p):
        req = p.data
        if req.get("method") != "noop":
            seen["mfcs"].append(req["mfc"])
            if req["mfc"] == "actor_train":
                batch = worker._gather_input(req["ids"],
                                             req.get("input_keys"),
                                             req.get("input_remap"))
                for i, sid in enumerate(batch.ids):
                    s = batch.select_idx([i])
                    seen["samples"][str(sid)] = {
                        k: np.asarray(s.data[k]).reshape(-1).tolist()
                        for k in ("rewards", "packed_ref_logprobs")}
        return handle(p)

    worker._handle_mfc = recording

    def done():
        import json

        with open(out_path, "w") as f:
            json.dump(seen, f)
    return done


def test_fuse_rew_ref_run_matches_the_unfused_run(tmp_path, monkeypatch):
    """The sync recipe through ``run_experiment`` on the CPU, one step with
    ``fuse_rew_ref=true`` and one without, on the same seed: the trainer
    builds the ``fused_rew_ref_inf`` MFC from its nested children on the
    ref model, the master hands both of its output keys to actor_train,
    and actor_train's rewards and reference log-probs equal the unfused
    run's sample for sample."""
    import functools
    import json

    from areal_tpu_torch.apps.launcher import run_experiment
    from areal_tpu_torch.base import name_resolve as tnr

    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the spawned trainer's
    data_path = str(tmp_path / "math.jsonl")
    make_math_jsonl(data_path, n=8)
    seen = {}
    old = tnr.DEFAULT_REPO
    try:
        for fuse in (False, True):
            cfg = TPPOConfig(backend="cpu")
            TCA.apply_overrides(cfg, [
                f"cluster.fileroot={tmp_path}/{fuse}",
                "experiment_name=fusedrun", f"trial_name=f{int(fuse)}",
                "mock_tokenizer=true", "actor.tiny.vocab_size=258",
                "ref.tiny.vocab_size=258", f"dataset.path={data_path}",
                "dataset.train_bs_n_seqs=2", "group_size=2",
                "ppo.gen.max_new_tokens=8", "ppo.kl_ctl=0.05",
                "ppo.disable_value=true", "exp_ctrl.benchmark_steps=1",
                f"fuse_rew_ref={str(fuse).lower()}"])
            out = str(tmp_path / f"probe_{fuse}.json")
            result = run_experiment(cfg, probes={"trainer": functools.partial(
                _actor_train_inputs_probe, out)})
            assert result["steps"] == 1
            with open(out) as f:
                seen[fuse] = json.load(f)
    finally:
        tnr.DEFAULT_REPO = old
    plain, fused = seen[False], seen[True]
    assert "fused_rew_ref_inf" in fused["mfcs"]
    assert not {"rew_inf", "ref_inf"} & set(fused["mfcs"])
    assert {"rew_inf", "ref_inf"} <= set(plain["mfcs"])
    assert "fused_rew_ref_inf" not in plain["mfcs"]
    assert len(plain["samples"]) == 4
    assert all(r["packed_ref_logprobs"] and len(r["rewards"]) == 1
               for r in plain["samples"].values())
    assert fused["samples"] == plain["samples"]
