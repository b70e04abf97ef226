"""The port's SFT path (areal_tpu_torch/experiments/sft_exp.py, the
``prompt_answer`` dataset, base/seeding.py, ``training/main_sft.py`` and the
launcher's automatic evaluator) against the reference's, on the CPU.

The seeds, the dataset's samples, the graph and the worker configs equal
the reference's; an SFT step on the dataset's batch matches within 1e-4
relative (float32 ``tiny_config`` weights from one numpy seed; the issue's
bound). End to end, ``main_sft --backend cpu`` with ``auto_eval=true``
trains and saves under ``default/``, and the launcher's evaluator scores
those checkpoints while the run lasts and leaves no eval process behind.

Pinned here: the reference's launcher builds its evaluator without the
graph's role, so an SFT run's automatic evaluation watches ``actor/`` and
scores none of the ``default/step*`` saves (ROADMAP.md Queue 3).
"""

import functools
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from areal_tpu.algorithms import sft as jsft
from areal_tpu.api import cli_args as JCA
from areal_tpu.api.data import MicroBatchSpec as JSpec
from areal_tpu.api.data import SequenceSample as JSample
from areal_tpu.base import seeding as jseeding
from areal_tpu.base.testing import MockTokenizer
from areal_tpu.datasets import jsonl as jjsonl
from areal_tpu.experiments.sft_exp import SFTConfig as JSFTConfig
from areal_tpu_torch.algorithms import sft as tsft
from areal_tpu_torch.api import cli_args as TCA
from areal_tpu_torch.api.data import MicroBatchSpec as TSpec
from areal_tpu_torch.api.data import SequenceSample as TSample
from areal_tpu_torch.base import seeding as tseeding
from areal_tpu_torch.base import testing as ttesting
from areal_tpu_torch.datasets import jsonl as tjsonl
from areal_tpu_torch.experiments import make_experiment_cls
from areal_tpu_torch.experiments.sft_exp import SFTConfig as TSFTConfig
from test_torch_fused import _node_view
from test_torch_train import _assert_masters_match
from test_torch_trainer import model_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the spawned workers' and eval processes' torch threads: the suite runs
# files side by side, and a tiny model gains nothing from more
CHILD_THREADS = {"OMP_NUM_THREADS": "2"}


# ---------------- seeding ----------------

@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_seeds_equal_the_reference(seed):
    import torch

    for mod in (jseeding, tseeding):
        mod.set_random_seed(seed, "trainer")
    py, npy = [], []
    for mod in (jseeding, tseeding):
        mod.set_random_seed(seed, "trainer")
        import random

        py.append(random.random())
        npy.append(np.random.rand())
    assert py[0] == py[1] and npy[0] == npy[1]
    assert tseeding.get_seed() == jseeding.get_seed() == seed
    for name in ("", "actor", "rollout0", "dataset/shuffle"):
        want = jseeding.component_seed(name)
        assert tseeding.component_seed(name) == want
        assert tseeding._mix(seed, name) == jseeding._mix(seed, name)
        gen = tseeding.torch_generator(name, device="cpu")
        assert gen.initial_seed() == want
        again = tseeding.torch_generator(name, device="cpu")
        assert torch.equal(torch.rand(4, generator=gen),
                           torch.rand(4, generator=again))
    jseeding.set_random_seed(1)


def test_torch_generator_needs_a_device():
    import torch

    tseeding.set_random_seed(1)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        tseeding.torch_generator("actor")


# ---------------- the prompt_answer dataset ----------------

def _sft_datasets(tmp_path, n=16, **kw):
    p = str(tmp_path / "sft.jsonl")
    records = ttesting.make_sft_jsonl(p, n=n)
    from areal_tpu.base.testing import make_sft_jsonl

    assert make_sft_jsonl(str(tmp_path / "ref.jsonl"), n=n) == records
    return (jjsonl.PromptAnswerDataset(dataset_path=p,
                                       tokenizer=MockTokenizer(), **kw),
            tjsonl.PromptAnswerDataset(dataset_path=p,
                                       tokenizer=ttesting.MockTokenizer(),
                                       **kw))


@pytest.mark.parametrize("max_length", [None, 20])
def test_prompt_answer_samples_equal(tmp_path, max_length):
    jds, tds = _sft_datasets(tmp_path, max_length=max_length)
    assert len(jds) == len(tds) == 16
    for i in range(len(jds)):
        got, want = tds[i], jds[i]
        assert got.ids == want.ids and got.keys == want.keys
        assert got.seqlens == want.seqlens
        for k in want.keys:
            np.testing.assert_array_equal(got.data[k], want.data[k])
            assert got.data[k].dtype == want.data[k].dtype
        assert got.data["prompt_mask"].sum() < len(got.data["prompt_mask"])


def test_prompt_answer_degenerate_tokenization(tmp_path):
    """A tokenizer whose encoding of prompt + answer is no longer than the
    prompt's: both packages fall back to the answer's own encoding."""
    class Whole:
        def encode(self, text):
            return [2 + len(text) % 200]

    p = str(tmp_path / "one.jsonl")
    ttesting.make_sft_jsonl(p, n=3)
    jds = jjsonl.PromptAnswerDataset(dataset_path=p, tokenizer=Whole())
    tds = tjsonl.PromptAnswerDataset(dataset_path=p, tokenizer=Whole())
    for i in range(3):
        np.testing.assert_array_equal(tds[i].data["packed_input_ids"],
                                      jds[i].data["packed_input_ids"])
        assert tds[i].data["prompt_mask"].tolist() == [1, 0]


def test_sft_step_on_the_dataset_matches_reference(tmp_path):
    jds, tds = _sft_datasets(tmp_path, n=8)
    jb = JSample.gather([jds[i] for i in range(len(jds))])
    tb = TSample.gather([tds[i] for i in range(len(tds))])
    jm, tm = model_pair(cfg_kw=dict(vocab_size=258))
    spec = dict(max_tokens_per_mb=128)
    for _ in range(2):
        want = jsft.SFTInterface().train_step(jm, jb, JSpec(**spec))
        got = tsft.SFTInterface().train_step(tm, tb, TSpec(**spec))
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-7), k
        assert np.isfinite(got["ppl"]) and got["grad_norm"] > 0
    _assert_masters_match(jm.module, tm.module, tm.module.cfg)


# ---------------- the experiment ----------------

def _overrides(tmp_path, *extra):
    return ["trial_name=t0", "mock_tokenizer=true",
            "model.tiny.vocab_size=258",
            f"dataset.path={tmp_path}/sft.jsonl",
            "dataset.train_bs_n_seqs=4", "dataset.max_seqlen=64",
            f"cluster.fileroot={tmp_path}/root", "n_gpus_per_node=1",
            *extra]


def test_sft_config_matches_reference(tmp_path):
    jcfg, tcfg = JSFTConfig(), make_experiment_cls("sft")()
    assert isinstance(tcfg, TSFTConfig)
    JCA.apply_overrides(jcfg, _overrides(tmp_path))
    TCA.apply_overrides(tcfg, _overrides(tmp_path))
    # every field the port keeps, with the reference's default; the
    # port leaves out the ones nothing reads
    import dataclasses

    for tcls, jcls, left_out in (
            (TCA.PromptAnswerDatasetConfig, JCA.PromptAnswerDatasetConfig,
             {"valid_bs_n_seqs", "fill_to_max_length"}),
            (TCA.AutomaticEvaluatorConfig, JCA.AutomaticEvaluatorConfig,
             {"eval_job_image", "initial_checkpoint_path", "prompt_type"})):
        got, want = dataclasses.asdict(tcls()), dataclasses.asdict(jcls())
        assert set(got) == set(want) - left_out
        assert got == {k: want[k] for k in got}
    assert tcfg.auto_eval is jcfg.auto_eval is False
    j, t = jcfg.initial_setup(), tcfg.initial_setup()
    assert _node_view(t["dfg"]) == _node_view(j["dfg"])
    assert t["dfg"].nodes["trainDefault"].mb_spec.max_tokens_per_mb == \
        j["dfg"].nodes["trainDefault"].mb_spec.max_tokens_per_mb
    jt, tt = j["trainer"], t["trainer"]
    assert set(tt.models) == set(jt.models) == {"default"}
    assert tt.models["default"].init == jt.models["default"].init
    assert tt.models["default"].train is jt.models["default"].train is True
    assert {k: (m.interface, m.model_name, m.method)
            for k, m in tt.mfcs.items()} == \
        {k: (m.interface, m.model_name, m.method)
         for k, m in jt.mfcs.items()}
    for f in ("dataset", "dataset_args", "batch_size", "realloc_dir",
              "experiment", "trial", "handler", "stream_dataset"):
        assert getattr(tt, f) == getattr(jt, f), f
    assert dataclasses.asdict(tt.ft_spec) == dataclasses.asdict(jt.ft_spec)
    jm, tm = j["master"], t["master"]
    for f in ("train_batch_size", "save_dir", "experiment", "trial",
              "trainer_handler"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert dataclasses.asdict(tm.exp_ctrl) == dataclasses.asdict(jm.exp_ctrl)
    # the port's differences: the run's device, and eval/* beside the
    # master's scalars
    assert tt.device is None and jm.tensorboard_path is None
    assert tm.tensorboard_path == os.path.join(
        str(tmp_path), "root", "areal-tpu", "t0", "logs", "tensorboard")
    TCA.apply_overrides(tcfg, ["backend=cpu"])
    assert tcfg.initial_setup()["trainer"].device == "cpu"


def test_main_sft_help_and_bad_keys(capsys):
    from areal_tpu_torch.training import _cli

    with pytest.raises(SystemExit) as e:
        _cli.main("sft", TSFTConfig, ["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "auto_eval_config" in out and "max_seqlen" in out
    with pytest.raises(TCA.ConfigError):
        _cli.main("sft", TSFTConfig, ["--backend=cpu", "dataset.max_seqlenn=3"])


def _eval_children(marker: str):
    """Live processes of an eval subprocess whose command line holds
    ``marker``."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().decode(errors="replace")
        except OSError:
            continue
        if "eval_ckpt" in cmd and marker in cmd:
            out.append(int(pid))
    return out


def test_main_sft_cli_on_the_cpu(tmp_path):
    """``python -m areal_tpu_torch.training.main_sft --backend cpu`` with
    ``auto_eval=true``: 3 steps saved under ``default/``, the evaluator
    watching them, and no eval process left when it exits."""
    ttesting.make_sft_jsonl(str(tmp_path / "sft.jsonl"), n=16)
    ttesting.make_math_jsonl(str(tmp_path / "eval.jsonl"), n=4)
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           **CHILD_THREADS}
    res = subprocess.run(
        [sys.executable, "-m", "areal_tpu_torch.training.main_sft",
         "--backend", "cpu",
         *_overrides(tmp_path, "exp_ctrl.benchmark_steps=3",
                     "exp_ctrl.save_freq_steps=1", "auto_eval=true",
                     f"auto_eval_config.data_names={tmp_path}/eval.jsonl",
                     "auto_eval_config.max_gen_tokens=4")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    save = tmp_path / "root" / "areal-tpu" / "t0" / "checkpoints"
    assert sorted(os.listdir(save)) == ["default"]
    assert sorted(os.listdir(save / "default")) == ["step1", "step2", "step3"]
    assert f"watching {save}/default" in res.stderr
    assert "experiment finished: steps=3" in res.stderr
    assert not _eval_children(str(save))


def _gated_trainer_probe(flag: str, worker):
    """Holds the second train step until ``flag`` exists (at most 120 s),
    so that the evaluator scores step 1 while the run lasts."""
    handle = worker._handle_mfc

    def gated(p):
        if (p.data.get("method") != "noop"
                and worker.models["default"].version.global_step >= 1):
            deadline = time.monotonic() + 120
            while not os.path.exists(flag) and time.monotonic() < deadline:
                time.sleep(0.1)
        return handle(p)

    worker._handle_mfc = gated


def test_launcher_evaluator_scores_the_runs_own_checkpoints(tmp_path,
                                                            monkeypatch):
    """The launcher's evaluator watches ``default/`` (the graph's trained
    role) and scores step 1 on the CPU while the run lasts; the run's
    result carries its steps; no eval process outlives the run."""
    from areal_tpu_torch.apps.launcher import LocalLauncher
    from areal_tpu_torch.base import name_resolve as tnr

    for k, v in CHILD_THREADS.items():
        monkeypatch.setenv(k, v)
    ttesting.make_sft_jsonl(str(tmp_path / "sft.jsonl"), n=16)
    ttesting.make_math_jsonl(str(tmp_path / "eval.jsonl"), n=4)
    cfg = TSFTConfig()
    TCA.apply_overrides(cfg, _overrides(
        tmp_path, "backend=cpu", "exp_ctrl.benchmark_steps=3",
        "exp_ctrl.save_freq_steps=1", "auto_eval=true",
        f"auto_eval_config.data_names={tmp_path}/eval.jsonl",
        "auto_eval_config.max_gen_tokens=4", "auto_eval_config.eval_k=2"))
    flag = str(tmp_path / "step1_scored")
    launcher = LocalLauncher(cfg, probes={"trainer": functools.partial(
        _gated_trainer_probe, flag)})
    box = {}
    old = tnr.DEFAULT_REPO

    def run():
        try:
            box["result"] = launcher.run()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline and t.is_alive():
            ev = launcher.evaluator
            if ev is not None and any(s.status != "running" and s.scores
                                      for s in ev.steps):
                break
            time.sleep(0.2)
        open(flag, "w").close()
        t.join(180)
        assert not t.is_alive(), "the run hung"
    finally:
        tnr.DEFAULT_REPO = old
    if "error" in box:
        raise box["error"]
    result = box["result"]
    assert result["steps"] == 3
    assert launcher.evaluator.role == "default"
    evals = {e["step"]: e for e in result["auto_eval"]}
    assert evals[1]["status"] == "done"
    assert evals[1]["ckpt_dir"].endswith(os.path.join("default", "step1"))
    scores = evals[1]["scores"]
    for key in ("pass@1", "pass@2", "pass^2", "math/pass@1", "math/pass@2",
                "math/pass^2"):
        assert 0.0 <= scores[key] <= 1.0, key
    assert scores["n"] == 4 and scores["device"]["type"] == "cpu"
    assert not launcher.evaluator._procs
    assert not _eval_children(str(tmp_path))


def test_reference_sft_auto_eval_scores_nothing(tmp_path, monkeypatch):
    """The reference's fault (apps/launcher.py:563-569): its SFT run with
    ``auto_eval=true`` saves ``default/step*`` while its evaluator watches
    ``actor/``, so no checkpoint is ever scored."""
    from areal_tpu.apps import evaluator as jev
    from areal_tpu.apps.launcher import run_experiment
    from areal_tpu.base import name_resolve as jnr

    made = []

    class Recording(jev.AutomaticEvaluator):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(jev, "AutomaticEvaluator", Recording)
    for k, v in CHILD_THREADS.items():
        monkeypatch.setenv(k, v)
    ttesting.make_sft_jsonl(str(tmp_path / "sft.jsonl"), n=16)
    cfg = JSFTConfig()
    JCA.apply_overrides(cfg, _overrides(
        tmp_path, "exp_ctrl.benchmark_steps=2", "exp_ctrl.save_freq_steps=1",
        "auto_eval=true"))
    old = jnr.DEFAULT_REPO
    try:
        assert run_experiment(cfg)["steps"] == 2
    finally:
        jnr.DEFAULT_REPO = old
    save = tmp_path / "root" / "areal-tpu" / "t0" / "checkpoints"
    assert sorted(os.listdir(save / "default")) == ["step1", "step2"]
    (ev,) = made
    assert ev.role == "actor" and ev.steps == []
    assert ev.poll_once() == 0 and ev.steps == []  # even after the run


@pytest.mark.parametrize("data_names,fleet", [
    (None, False), ("missing.jsonl", False), ("eval.jsonl", True)])
def test_launcher_builds_the_evaluator(tmp_path, data_names, fleet):
    """The launcher's ``auto_eval`` block (reference launcher.py:506-572):
    the default ``data_names`` falls back to the training set, an explicit
    one that does not exist raises, the reward fleet's name-resolve root
    and config ride along, and SFT's role is ``default``."""
    import json

    from areal_tpu_torch.apps.launcher import LocalLauncher

    ttesting.make_sft_jsonl(str(tmp_path / "sft.jsonl"), n=4)
    ttesting.make_math_jsonl(str(tmp_path / "eval.jsonl"), n=2)
    extra = ["backend=cpu", "auto_eval=true"]
    if data_names:
        extra.append(f"auto_eval_config.data_names={tmp_path}/{data_names}")
    if fleet:
        extra += ["reward_service.enabled=true",
                  "reward_service.local_fallback=false"]
    cfg = TSFTConfig()
    TCA.apply_overrides(cfg, _overrides(tmp_path, *extra))
    setup = cfg.initial_setup()
    launcher = LocalLauncher(cfg)
    if data_names == "missing.jsonl":
        with pytest.raises(FileNotFoundError, match="missing.jsonl"):
            launcher._build_evaluator(cfg, setup)
        return
    ev = launcher._build_evaluator(cfg, setup)
    assert ev.role == "default" and ev.device == "cpu"
    assert ev.save_dir == setup["master"].save_dir and ev.mock_tokenizer
    assert ev.dataset_path == (f"{tmp_path}/eval.jsonl" if data_names
                               else cfg.dataset.path)
    if fleet:
        exp, trial, nr_root, cfg_json = ev.reward_service
        assert (exp, trial) == (cfg.experiment_name, cfg.trial_name)
        assert nr_root.endswith("name_resolve")
        assert json.loads(cfg_json)["local_fallback"] is False
    else:
        assert ev.reward_service is None
    ev.stop()
