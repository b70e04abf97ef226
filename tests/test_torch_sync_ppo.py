"""The port's sync-PPO loop (areal_tpu_torch/system/{master_worker,
trainer_worker}.py over the port's request stream) on the CPU at
``tiny_config`` size:

 - the twin of tests/test_system_sync_ppo.py's fabric test: a master here
   and a trainer in a spawned process, sampled generation, 2 steps, the
   same asserts;
 - loop parity: both packages run MasterWorker + TrainerWorker on one DFG
   (the README's sync recipe with the critic: actor_gen → rew_inf /
   ref_inf / critic_inf → actor_train → critic_train) from one native
   checkpoint of numpy-seeded weights, f32, greedy, 2 steps, with
   ``group_adv_norm=False``, ``adv_norm=False`` and
   ``reward_output_bias=0.5`` so the gradients are not zero. Tolerances:
   tokens and rewards equal; actor_train stats rtol 1e-4 / atol 1e-5;
   the last published actor checkpoints within 1e-5 (f32, another
   summation order, two optimizer steps);
 - the entry point: ``python -m areal_tpu_torch.training.main_sync_ppo``'s
   ``main`` with ``--backend=cpu`` runs the recipe through the launcher.
"""

import json
import multiprocessing as mp
import os
import threading

import numpy as np
import pytest
import torch

from areal_tpu_torch.base import name_resolve as tnr
from areal_tpu_torch.base import names as tnames
from areal_tpu_torch.base.testing import make_math_jsonl

EXP, TRIAL = "torch_systest", "t0"
TRAJ_KEYS = ("packed_input_ids", "prompt_mask", "packed_logprobs",
             "seq_no_eos_mask", "task_ids", "version_start", "version_end")
WAIT_SECS = 240  # bound on every wait of a loop


def _dfg(pkg, critic: bool, decoupled: bool, n_prompts=4, group=2):
    """The sync recipe's DFG (experiments/ppo_math_exp.py:111 build_dfg)
    in either package: ``pkg`` is "port" or "ref"."""
    if pkg == "port":
        from areal_tpu_torch.api import dfg
        from areal_tpu_torch.api.data import MicroBatchSpec
    else:
        from areal_tpu.api import dfg
        from areal_tpu.api.data import MicroBatchSpec
    n = n_prompts * group
    spec = MicroBatchSpec(max_tokens_per_mb=512)

    def node(name, model, kind, impl, inputs, outputs=(), n_seqs=n, **kw):
        return dfg.MFCDef(
            name=name, model_name=model,
            interface_type=getattr(dfg.MFCInterfaceType, kind),
            interface_impl=dfg.ModelInterfaceAbstraction(impl),
            input_keys=inputs, output_keys=outputs, n_seqs=n_seqs,
            mb_spec=spec, **kw)

    train_in = ["packed_input_ids", "prompt_mask", "packed_logprobs",
                "rewards", "seq_no_eos_mask", "packed_ref_logprobs"]
    mfcs = [
        node("actor_gen", "actor", "GENERATE", "ppo_actor",
             ("packed_prompts", "task_ids"), TRAJ_KEYS, n_seqs=n_prompts),
        node("rew_inf", "rw", "INFERENCE", "rw_math_code",
             ("packed_input_ids", "prompt_mask"), ("rewards",)),
        node("ref_inf", "ref", "INFERENCE", "ref_logprob",
             ("packed_input_ids",), ("packed_ref_logprobs",)),
    ]
    if decoupled:
        mfcs.append(node("actor_inf", "actor", "INFERENCE", "ppo_actor",
                         ("packed_input_ids",), ("prox_logprobs",)))
        train_in.append("prox_logprobs")
    if critic:
        mfcs.append(node("critic_inf", "critic", "INFERENCE", "ppo_critic",
                         ("packed_input_ids",), ("values",)))
        train_in.append("values")
    mfcs.append(node("actor_train", "actor", "TRAIN_STEP", "ppo_actor",
                     tuple(train_in),
                     post_hooks=[dfg.WeightUpdateHook(role="actor")]))
    if critic:
        mfcs.append(node("critic_train", "critic", "TRAIN_STEP", "ppo_critic",
                         tuple(k for k in train_in if k != "prox_logprobs")))
    return dfg.build_graph(mfcs)


def _trainer_cfg(pkg, data_path, realloc_dir, hp_kw, models, mfc_names,
                 experiment):
    """A TrainerWorkerConfig of either package over the same recipe.
    ``models`` maps role → init dict (None: the tokenizer-only reward)."""
    if pkg == "port":
        from areal_tpu_torch.algorithms.ppo import PPOHyperparameters
        from areal_tpu_torch.api.model import (
            FinetuneSpec,
            GenerationHyperparameters,
        )
        from areal_tpu_torch.api.train_config import OptimizerConfig
        from areal_tpu_torch.base.testing import MockTokenizer
        from areal_tpu_torch.system import trainer_worker as tw
        backend, extra = "torch_train", {}
    else:
        from areal_tpu.algorithms.ppo import PPOHyperparameters
        from areal_tpu.api.model import (
            FinetuneSpec,
            GenerationHyperparameters,
        )
        from areal_tpu.backend.jax_train import OptimizerConfig
        from areal_tpu.base.testing import MockTokenizer
        from areal_tpu.system import trainer_worker as tw
        backend, extra = "jax_train", {}
    gen = GenerationHyperparameters(**hp_kw.pop("gen"))
    hp = PPOHyperparameters(gen=gen, **hp_kw)
    backend_args = {
        "compute_dtype": "float32", "length_bucket": 16, "rows_bucket": 2,
        "seqs_bucket": 4,
        "optimizer": OptimizerConfig(lr=1e-3, lr_scheduler_type="constant",
                                     warmup_steps_proportion=0.0),
    }
    roles = {}
    for role, init in models.items():
        if init is None:
            roles[role] = tw.ModelRoleConfig(init={"null": True},
                                             backend="null")
        else:
            roles[role] = tw.ModelRoleConfig(
                init=init, backend=backend, backend_args=dict(backend_args),
                train=role != "ref")
    impl = {"actor": "ppo_actor", "critic": "ppo_critic"}
    mfcs = {}
    for name in mfc_names:
        role = {"rew_inf": "rw", "ref_inf": "ref"}.get(
            name, name.split("_")[0])
        if name == "rew_inf":
            mfcs[name] = tw.MFCRuntimeConfig(
                interface="rw_math_code", model_name="rw",
                interface_args={"dataset_path": data_path,
                                "group_size": hp.group_size})
        elif name == "ref_inf":
            mfcs[name] = tw.MFCRuntimeConfig(interface="ref_logprob",
                                             model_name="ref")
        else:
            mfcs[name] = tw.MFCRuntimeConfig(
                interface=impl[role], interface_args={"hp": hp},
                model_name=role)
    return tw.TrainerWorkerConfig(
        experiment=experiment, trial=TRIAL, handler="trainer",
        models=roles, mfcs=mfcs, dataset="math_code_prompt",
        dataset_args={"dataset_path": data_path}, batch_size=4,
        ft_spec=FinetuneSpec(1, 8, 4), tokenizer=MockTokenizer(),
        realloc_dir=realloc_dir,
        **({"device": "cpu"} if pkg == "port" else extra))


def _trainer_main(pkg, nr_root, cfg_args, record_path):
    """A trainer in a spawned process. With ``record_path``, the tokens of
    every actor_gen and the rewards of every rew_inf go there as JSON when
    the loop ends."""
    if pkg == "port":
        from areal_tpu_torch.base import name_resolve as nr
        from areal_tpu_torch.system.trainer_worker import TrainerWorker
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        import areal_tpu.algorithms.ppo  # noqa: F401 — the registries
        import areal_tpu.algorithms.reward  # noqa: F401
        import areal_tpu.backend.jax_train  # noqa: F401
        import areal_tpu.datasets.jsonl  # noqa: F401
        from areal_tpu.base import name_resolve as nr
        from areal_tpu.system.trainer_worker import TrainerWorker
    nr.DEFAULT_REPO = nr.NfsNameRecordRepo(nr_root)
    record = {"tokens": [], "rewards": []}

    class Recording(TrainerWorker):
        def _handle_mfc(self, p):
            out = super()._handle_mfc(p)
            name = p.data.get("mfc")
            if name in ("actor_gen", "rew_inf") and out["meta"] is not None:
                ids = list(out["meta"].ids)
                if name == "actor_gen":
                    record["tokens"].append(
                        {str(i): np.asarray(self.store[i].data[
                            "packed_input_ids"]).tolist() for i in ids})
                else:
                    record["rewards"].append(
                        {str(i): float(np.asarray(self.store[i].data[
                            "rewards"]).reshape(-1)[0]) for i in ids})
            return out

    Recording(_trainer_cfg(pkg, *cfg_args)).run()
    if record_path:
        with open(record_path, "w") as f:
            json.dump(record, f)


def _master(pkg, experiment, n_steps, dfg):
    if pkg == "port":
        from areal_tpu_torch.api.train_config import ExperimentSaveEvalControl
        from areal_tpu_torch.system.master_worker import (
            MasterWorker,
            MasterWorkerConfig,
        )
    else:
        from areal_tpu.system.master_worker import (
            ExperimentSaveEvalControl,
            MasterWorker,
            MasterWorkerConfig,
        )
    return MasterWorker(MasterWorkerConfig(
        experiment=experiment, trial=TRIAL, trainer_handler="trainer",
        train_batch_size=4, exp_ctrl=ExperimentSaveEvalControl(
            total_train_epochs=10, benchmark_steps=n_steps)), dfg)


def _run_bounded(fn):
    """fn() in a daemon thread, joined within WAIT_SECS."""
    box = {}

    def target():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["err"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(WAIT_SECS)
    assert not t.is_alive(), f"the master did not finish in {WAIT_SECS}s"
    if "err" in box:
        raise box["err"]
    return box["out"]


def _spawn(*args):
    proc = mp.get_context("spawn").Process(target=_trainer_main, args=args,
                                           daemon=True)
    proc.start()
    return proc


def _stop(proc):
    proc.join(timeout=30)
    if proc.is_alive():
        proc.terminate()
        proc.join(10)
    return proc.exitcode


def test_sync_ppo_through_port_fabric(tmp_path):
    """The twin of test_system_sync_ppo.py:163: sampled, 2 steps, a trainer
    on the CPU in a spawned process."""
    nr_root = str(tmp_path / "nr")
    data_path = str(tmp_path / "math.jsonl")
    realloc_dir = str(tmp_path / "realloc")
    make_math_jsonl(data_path, n=8)
    old = tnr.DEFAULT_REPO
    tnr.DEFAULT_REPO = tnr.NfsNameRecordRepo(nr_root)
    tiny = {"tiny": {"vocab_size": 258, "seed": 0}}
    hp = dict(gen={"max_new_tokens": 8}, ppo_n_minibatches=2, group_size=2,
              kl_ctl=0.05, disable_value=True, group_adv_norm=True,
              adv_norm=False, use_decoupled_loss=True)
    names_ = ("actor_gen", "rew_inf", "ref_inf", "actor_inf", "actor_train")
    proc = _spawn("port", nr_root, (data_path, realloc_dir, hp,
                                    {"actor": tiny, "ref": tiny, "rw": None},
                                    names_, EXP), None)
    try:
        result = _run_bounded(lambda: _master(
            "port", EXP, 2, _dfg("port", critic=False, decoupled=True)).run())
        assert result["steps"] == 2
        for st in result["stats"]:
            assert np.isfinite(st["actor_train/actor_loss"])
            assert st["actor_train/n_action_tokens"] > 0
        v = tnr.get(tnames.model_version(EXP, TRIAL, "actor"))
        assert int(v) >= 1
        assert os.path.exists(os.path.join(realloc_dir, "actor", v,
                                           "areal_tpu_native.json"))
        assert os.path.exists(os.path.join(realloc_dir, "actor", v,
                                           "model.safetensors"))
        assert _stop(proc) == 0
    finally:
        if proc.is_alive():
            proc.terminate()
        tnr.DEFAULT_REPO = old


# ------------------------------------------------------------ loop parity


def _seeded_checkpoints(tmp_path):
    """Native checkpoints of an actor and a critic (same trunk) from one
    numpy seed, every bias and norm scale filled."""
    import jax

    from areal_tpu.models import config as jconfig
    from areal_tpu.models import hf as jhf
    from areal_tpu.models import transformer as jtf
    from areal_tpu_torch.models import config as tconfig
    from areal_tpu_torch.models import hf as thf
    from areal_tpu_torch.models.convert import params_from_jax

    kw = dict(vocab_size=258, use_attention_bias=True)
    out = {}
    for role, critic in (("actor", False), ("critic", True)):
        jcfg = jconfig.tiny_config(is_critic=critic, **kw)
        tcfg = tconfig.tiny_config(is_critic=critic, **kw)
        shapes = jhf.flatten_pytree(jax.eval_shape(
            lambda: jtf.init_params(jcfg, jax.random.PRNGKey(0))))
        rng = np.random.RandomState(0)
        flat = {}
        for key, a in sorted(shapes.items()):
            scale = key.split("/")[-1] in ("ln1", "ln2", "final_ln")
            flat[key] = ((1.0 if scale else 0.0)
                         + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        path = str(tmp_path / f"init_{role}")
        thf.save_native_checkpoint(params_from_jax(flat, tcfg, device="cpu"),
                                   tcfg, path)
        out[role] = path
    return out


def test_sync_ppo_loop_matches_reference(tmp_path):
    """Both packages' loops, greedy and f32, from one checkpoint: the
    same tokens and rewards each step, the actor's train stats and its
    last published weights within tolerance."""
    from areal_tpu.base import name_resolve as jnr
    from areal_tpu_torch.models import hf as thf

    data_path = str(tmp_path / "math.jsonl")
    make_math_jsonl(data_path, n=8, seed=3)
    ckpt = _seeded_checkpoints(tmp_path)
    models = {"actor": {"ckpt_dir": ckpt["actor"]},
              "ref": {"ckpt_dir": ckpt["actor"]},
              "critic": {"ckpt_dir": ckpt["critic"]}, "rw": None}
    names_ = ("actor_gen", "rew_inf", "ref_inf", "critic_inf", "actor_train",
              "critic_train")
    hp = dict(gen={"max_new_tokens": 8, "greedy": True}, ppo_n_minibatches=2,
              group_size=2, kl_ctl=0.05, group_adv_norm=False, adv_norm=False,
              reward_output_bias=0.5)
    runs = {}
    for pkg in ("ref", "port"):
        runs[pkg] = dict(
            nr=str(tmp_path / f"nr_{pkg}"), exp=f"{EXP}_{pkg}",
            realloc=str(tmp_path / f"realloc_{pkg}"),
            record=str(tmp_path / f"record_{pkg}.json"))
        r = runs[pkg]
        r["proc"] = _spawn(pkg, r["nr"], (data_path, r["realloc"], dict(hp),
                                          models, names_, r["exp"]),
                           r["record"])
    old = (tnr.DEFAULT_REPO, jnr.DEFAULT_REPO)
    tnr.DEFAULT_REPO = tnr.NfsNameRecordRepo(runs["port"]["nr"])
    jnr.DEFAULT_REPO = jnr.NfsNameRecordRepo(runs["ref"]["nr"])
    try:
        results = {}
        threads = [threading.Thread(target=lambda pkg=pkg: results.update(
            {pkg: _run_bounded(lambda: _master(
                pkg, runs[pkg]["exp"], 2,
                _dfg(pkg, critic=True, decoupled=False)).run())}))
            for pkg in ("ref", "port")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert set(results) == {"ref", "port"}, "a master failed"
        for pkg in ("ref", "port"):
            assert _stop(runs[pkg]["proc"]) == 0, pkg
    finally:
        for r in runs.values():
            if r["proc"].is_alive():
                r["proc"].terminate()
        tnr.DEFAULT_REPO, jnr.DEFAULT_REPO = old

    rec = {pkg: json.load(open(runs[pkg]["record"])) for pkg in runs}
    assert len(rec["port"]["tokens"]) == len(rec["ref"]["tokens"]) == 2
    assert rec["port"]["tokens"] == rec["ref"]["tokens"]
    assert rec["port"]["rewards"] == rec["ref"]["rewards"]
    assert results["port"]["steps"] == results["ref"]["steps"] == 2
    for st_t, st_j in zip(results["port"]["stats"], results["ref"]["stats"]):
        assert st_t["actor_train/grad_norm"] > 0
        assert st_t["critic_train/grad_norm"] > 0
        common = sorted(k for k in set(st_t) & set(st_j)
                        if k.startswith(("actor_train/", "critic_train/")))
        assert len(common) >= 15
        for k in common:
            np.testing.assert_allclose(st_t[k], st_j[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    published = []
    for pkg in ("ref", "port"):
        v = max(int(d) for d in os.listdir(
            os.path.join(runs[pkg]["realloc"], "actor")))
        assert v == 2
        _, params = thf.load_native_checkpoint(
            os.path.join(runs[pkg]["realloc"], "actor", str(v)), device="cpu")
        published.append(params)
    assert set(published[0]) == set(published[1])
    for k in published[0]:
        torch.testing.assert_close(published[1][k], published[0][k],
                                   rtol=0, atol=1e-5, msg=k)


# ------------------------------------------------- the critic from hf_dir


def test_critic_from_an_hf_dir(tmp_path):
    """The reference's model factory loads ``hf_dir`` without ``is_critic``
    (areal_tpu/system/trainer_worker.py:195-196), and the sync recipe
    builds its critic from the actor's path (experiments/common.py:59-70,
    ppo_math_exp.py:268-276): its critic gets an LM head, and critic_inf
    then fails on the [R, L, V] × [R, L] product in ``_values_hook``. The
    port's factory keeps that default and takes ``"is_critic": True`` in
    ``init`` for a value head."""
    import jax

    from areal_tpu.algorithms import ppo as jppo
    from areal_tpu.api.data import MicroBatchSpec as JSpec
    from areal_tpu.backend.jax_train import JaxTrainBackend
    from areal_tpu.api.model import FinetuneSpec as JFt
    from areal_tpu.models import config as jconfig
    from areal_tpu.models import hf as jhf
    from areal_tpu.models import transformer as jtf
    from areal_tpu.system import trainer_worker as jtw
    from areal_tpu_torch.system import trainer_worker as ttw
    from test_uniform_prep import _make_batch

    jcfg = jconfig.tiny_config(vocab_size=128)
    hf_dir = str(tmp_path / "hf")
    jhf.save_hf_checkpoint(jtf.init_params(jcfg, jax.random.PRNGKey(0)),
                           jcfg, hf_dir)
    model = jtw.TrainerWorker._default_model_factory(
        "critic", jtw.ModelRoleConfig(init={"hf_dir": hf_dir}))
    cfg, _ = model.module
    assert not cfg.is_critic and cfg.vocab_size == 128
    engine = JaxTrainBackend(compute_dtype="float32", length_bucket=16,
                             rows_bucket=2, seqs_bucket=4).initialize(
        model, JFt(1, 8, 4))
    with pytest.raises(ValueError, match="Incompatible shapes"):
        # [R, L, 128] * [R, L] does not broadcast
        jppo.PPOCriticInterface().inference(
            engine, _make_batch(n_seq=4), JSpec(max_tokens_per_mb=64))

    worker = ttw.TrainerWorker(ttw.TrainerWorkerConfig(device="cpu"))
    worker.device = torch.device("cpu")
    for init, critic in (({"hf_dir": hf_dir}, False),
                         ({"hf_dir": hf_dir, "is_critic": True}, True)):
        tcfg, params = worker._default_model_factory(
            "critic", ttw.ModelRoleConfig(init=init)).module
        assert tcfg.is_critic == critic
        assert ("value_head.weight" in params) == critic


# ------------------------------------------------ the master's FLOPs and MFU


@pytest.mark.parametrize("moe", [None, {"num_experts": 4, "top_k": 2}])
def test_flops_counter_matches_the_reference(moe):
    """The master's per-MFC FLOPs (base/monitor.py FlopsCounter) on the same
    geometry in both packages: train with and without remat, inference."""
    from areal_tpu.base import monitor as jmon
    from areal_tpu.models import config as jconfig
    from areal_tpu_torch.base import monitor as tmon
    from areal_tpu_torch.models import config as tconfig

    kw = dict(vocab_size=300, n_layers=3, hidden_dim=64)
    if moe:
        kw["moe"] = dict(moe)
    cfgs = (tconfig.tiny_config(**kw), jconfig.tiny_config(**kw))
    got = []
    for mon, cfg in zip((tmon, jmon), cfgs):
        c = mon.FlopsCounter()
        c.add_train(cfg, 4096.0, 512.0, remat=False)
        c.add_train(cfg, 1000.0, 250.0, remat=True)
        c.add_inf(cfg, 2048.0, 256.0)
        got.append((c.pop(), mon.train_flops_6nt(1e8, 4096.0)))
    assert got[0] == pytest.approx(got[1], rel=1e-12)


def test_device_peak_flops_reads_nvidia_names():
    """The H100's dense bf16 peak from NVIDIA's data sheet, by the name
    torch.cuda.get_device_name() reports; None where the table has none."""
    from areal_tpu_torch.base.monitor import device_peak_flops

    assert device_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert device_peak_flops("NVIDIA H100 PCIe") == 756e12
    assert device_peak_flops("NVIDIA A100-SXM4-80GB") == 312e12
    assert device_peak_flops("cpu") is None


def test_mfc_flops_count_the_main_token_key():
    """The master counts an MFC's FLOPs over the packed token key even when
    a scalar key (rewards, [[1]] per sample) leads the sample's seqlens, as
    it does in whichever order a process iterates the key set. The
    reference takes the first key (master_worker.py:311) and counts one
    token per sample then: a fault of the reference, not carried over."""
    from areal_tpu.system import master_worker as jmw
    from areal_tpu_torch.api.data import SequenceSample
    from areal_tpu_torch.base import monitor
    from areal_tpu_torch.system import master_worker as tmw

    info = {"n_layers": 2, "hidden_dim": 32, "q_dim": 32, "kv_dim": 16,
            "intermediate_dim": 64, "vocab_size": 300, "is_critic": False,
            "moe": None, "remat": False}
    dfg = _dfg("port", critic=False, decoupled=False)
    metas = [SequenceSample(ids=[f"s{i}"], keys={"rewards",
                                                 "packed_input_ids"},
                            seqlens={"rewards": [[1]],
                                     "packed_input_ids": [[100 + i]]},
                            data=None) for i in range(4)]
    want = monitor.FlopsCounter()
    cfg = type("Cfg", (), {**info})
    want.add_train(cfg, 406.0, 101.5)
    from areal_tpu.base import monitor as jmonitor

    counts = []
    for mw, mon, graph in ((tmw, monitor, dfg),
                           (jmw, jmonitor, _dfg("ref", critic=False,
                                                decoupled=False))):
        master = mw.MasterWorker(mw.MasterWorkerConfig(), graph)
        master._model_info = {"roles": {"actor": info}}
        master._flops = mon.FlopsCounter()
        master._count_mfc_flops(graph.nodes["actor_train"], metas)
        counts.append(master._flops.pop())
    assert counts[0] == pytest.approx(want.pop(), rel=1e-12)
    assert counts[1] < counts[0] / 50  # the reference: 4 "tokens"


# --------------------------------------------------------- the entry point


def test_main_sync_ppo_on_the_cpu(tmp_path, monkeypatch):
    """``python -m areal_tpu_torch.training.main_sync_ppo --backend=cpu``:
    the sync recipe at tiny size through the command line and the
    launcher's sync path (a spawned trainer, the master here), 2 steps."""
    from areal_tpu_torch.experiments.ppo_math_exp import PPOMATHConfig
    from areal_tpu_torch.training import _cli

    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the spawned trainer's
    data_path = str(tmp_path / "math.jsonl")
    make_math_jsonl(data_path, n=8)
    argv = ["--backend=cpu", f"cluster.fileroot={tmp_path}",
            "experiment_name=clisync", "trial_name=t0", "mock_tokenizer=true",
            "actor.tiny.vocab_size=258", "ref.tiny.vocab_size=258",
            f"dataset.path={data_path}", "dataset.train_bs_n_seqs=2",
            "group_size=2", "ppo.gen.max_new_tokens=8",
            "ppo.ppo_n_minibatches=2", "exp_ctrl.benchmark_steps=2"]
    old = tnr.DEFAULT_REPO
    try:
        result = _run_bounded(lambda: _cli.main("ppo-math", PPOMATHConfig,
                                                argv=argv))
    finally:
        tnr.DEFAULT_REPO = old
    assert result["steps"] == 2
    for st in result["stats"]:
        for k in ("actor_train/actor_loss", "critic_train/critic_loss"):
            assert np.isfinite(st[k]), k
