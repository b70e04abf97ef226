"""The port's checkpoint evaluation (areal_tpu_torch/apps/eval_ckpt.py) and
automatic evaluator (apps/evaluator.py) against the reference's
(areal_tpu/apps/eval_ckpt.py, evaluator.py, tests/test_evaluator.py's
twins), on the CPU.

The pass@k estimators agree exactly over a grid; greedy evaluation of one
HF checkpoint (written by the reference, read by both packages, float32
``tiny_config`` weights from one numpy seed) generates the same tokens and
gives the same scores. Sampled draws differ between the packages (a
``torch.Generator`` against jax's PRNG), so the k > 1 case is checked in
the port alone, as the reference's test checks it.

Also pinned here: the reference's ``AutomaticEvaluator.stop()`` leaves an
eval subprocess running (ROADMAP.md Queue 3); the port's ends it.
"""

import json
import os
import subprocess
import sys
import time

import jax
import pytest

from areal_tpu.api.cli_args import AutomaticEvaluatorConfig as JEvalConfig
from areal_tpu.apps import eval_ckpt as jeval
from areal_tpu.apps import evaluator as jev
from areal_tpu.models import hf as jhf
from areal_tpu_torch.api.cli_args import AutomaticEvaluatorConfig
from areal_tpu_torch.apps import eval_ckpt as teval
from areal_tpu_torch.apps import evaluator as tev
from areal_tpu_torch.base.testing import make_mixed_jsonl
from test_torch_model import _jparams
from test_torch_trainer import weights


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


# ---------------- pass@k ----------------

def test_pass_at_k_and_pass_hat_k_equal_over_a_grid():
    for n in range(1, 9):
        for c in range(n + 1):
            for k in range(1, n + 1):
                assert teval.pass_at_k(n, c, k) == jeval.pass_at_k(n, c, k)
                assert teval.pass_hat_k(n, c, k) == jeval.pass_hat_k(n, c, k)
    assert teval.pass_at_k(4, 2, 2) == 1.0 - 1.0 / 6.0
    assert teval.pass_hat_k(4, 2, 2) == 1.0 / 6.0


# ---------------- evaluate_checkpoint ----------------

@pytest.fixture()
def ckpt(tmp_path):
    """One HF checkpoint of numpy-seeded tiny weights, written by the
    reference."""
    jcfg, _, flat = weights(seed=5, vocab_size=258)
    path = str(tmp_path / "ckpt")
    jhf.save_hf_checkpoint(jax.device_get(_jparams(flat)), jcfg, path)
    return path


def test_greedy_evaluate_checkpoint_matches_reference(ckpt, tmp_path,
                                                      monkeypatch):
    from areal_tpu.rewards import client as jclient
    from areal_tpu_torch.rewards import client as tclient

    data = str(tmp_path / "mixed.jsonl")
    make_mixed_jsonl(data, n_math=5, n_code=2, seed=3)
    graded = {"ref": [], "port": []}
    for pkg, mod in (("ref", jclient), ("port", tclient)):
        real = mod.batch_reward

        def recording(tasks, *a, _pkg=pkg, _real=real, **k):
            graded[_pkg].extend(t["generated"] for t in tasks)
            return _real(tasks, *a, **k)

        monkeypatch.setattr(mod, "batch_reward", recording)
    kw = dict(max_gen_tokens=12, batch_size=4, mock_tokenizer=True)
    want = jeval.evaluate_checkpoint(ckpt, data, **kw)
    got = teval.evaluate_checkpoint(ckpt, data, device="cpu", **kw)
    assert graded["port"] == graded["ref"] and len(graded["port"]) == 7
    assert any(graded["port"])
    dev = got.pop("device")
    assert dev["type"] == "cpu" and dev["flash_attention_fwd_launches"] == 0
    assert dev["dtype"] == "float32"  # the checkpoint's, as the reference
    for r in (got, want):
        r.pop("eval_secs")
    assert got == want
    assert got["n"] == 7 and got["math/n"] == 5 and got["code/n"] == 2


def test_sampled_pass_at_k_over_mixed_tasks(ckpt, tmp_path):
    """--k 4 over a mixed math + code set: pass@1, pass@4 and pass^4 for
    both task kinds (tests/test_evaluator.py's twin, on the port alone)."""
    data = str(tmp_path / "mixed.jsonl")
    make_mixed_jsonl(data, n_math=3, n_code=1)
    result = teval.evaluate_checkpoint(ckpt, data, max_gen_tokens=8,
                                       batch_size=4, mock_tokenizer=True,
                                       k=4, temperature=0.8, device="cpu")
    assert result["n"] == 4 and result["k"] == 4
    for key in ("pass@1", "pass@4", "pass^4", "math/pass@1", "math/pass@4",
                "math/pass^4", "code/pass@1", "code/pass@4", "code/pass^4"):
        assert 0.0 <= result[key] <= 1.0, key
    assert result["pass@4"] >= result["pass@1"] >= result["pass^4"]
    assert result["accuracy"] == result["pass@1"]
    again = teval.evaluate_checkpoint(ckpt, data, max_gen_tokens=8,
                                      batch_size=4, mock_tokenizer=True,
                                      k=4, temperature=0.8, device="cpu")
    assert {k: v for k, v in again.items() if k != "eval_secs"} == \
        {k: v for k, v in result.items() if k != "eval_secs"}


def test_eval_ckpt_cli_writes_scores(ckpt, tmp_path):
    """``python -m areal_tpu_torch.apps.eval_ckpt --device cpu``."""
    data = str(tmp_path / "mixed.jsonl")
    make_mixed_jsonl(data, n_math=2, n_code=1)
    out = str(tmp_path / "scores.json")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "areal_tpu_torch.apps.eval_ckpt", "--ckpt",
         ckpt, "--dataset", data, "--output", out, "--max-gen-tokens", "4",
         "--mock-tokenizer", "--device", "cpu"],
        cwd=root, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    with open(out) as f:
        scores = json.load(f)
    assert scores["n"] == 3 and scores["k"] == 1
    assert scores["device"]["type"] == "cpu"
    assert scores["device"]["dtype"] == "float32"


def test_evaluate_checkpoint_needs_a_device(ckpt, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    data = str(tmp_path / "mixed.jsonl")
    make_mixed_jsonl(data, n_math=1, n_code=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        teval.evaluate_checkpoint(ckpt, data, mock_tokenizer=True)


# ---------------- the evaluator ----------------

def _fake_ckpt(root, role, step):
    d = os.path.join(root, role, f"step{step}")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "areal_tpu_config.json"), "w") as f:
        json.dump({}, f)
    return d


@pytest.mark.parametrize("role", ["actor", "default"])
def test_discover_new_steps_matches_reference(tmp_path, role):
    root = str(tmp_path)
    _fake_ckpt(root, role, 20)
    _fake_ckpt(root, role, 5)
    os.makedirs(os.path.join(root, role, "step99"))  # an unfinished save
    os.makedirs(os.path.join(root, role, "stepx"))
    seen = {"ref": set(), "port": set()}

    def both():
        a = jev.discover_new_steps(root, role, seen["ref"])
        b = tev.discover_new_steps(root, role, seen["port"])
        assert [(s.step, s.ckpt_dir, s.status) for s in b] == \
            [(s.step, s.ckpt_dir, s.status) for s in a]
        return [s.step for s in b]

    assert both() == [5, 20]
    assert both() == []
    _fake_ckpt(root, role, 99)  # completes later
    assert both() == [99]
    assert seen["port"] == seen["ref"]
    other = "default" if role == "actor" else "actor"
    assert tev.discover_new_steps(root, other, set()) == []


class _Writer:
    """MetricWriter's API: write(stats, step)."""

    def __init__(self):
        self.logged = []

    def write(self, metrics, step):
        self.logged.append((step, metrics))


@pytest.mark.parametrize("jobs", [1, 10])
def test_injected_evaluator_matches_reference(tmp_path, jobs):
    root = str(tmp_path)
    for s in (1, 2, 3):
        _fake_ckpt(root, "actor", s)

    def run_eval(step):
        if step.step == 3:
            raise RuntimeError("no")
        return {"accuracy": 0.5 + step.step / 10, "n": 4, "ckpt": "x"}

    evs = {}
    for pkg, cls, ecfg in (("ref", jev.AutomaticEvaluator, JEvalConfig),
                           ("port", tev.AutomaticEvaluator,
                            AutomaticEvaluatorConfig)):
        w = _Writer()
        ev = cls(ecfg(max_concurrent_jobs=jobs), save_dir=root,
                 dataset_path="unused.jsonl", metric_writer=w,
                 run_eval=run_eval)
        counts = [ev.poll_once() for _ in range(4)]
        evs[pkg] = (counts, [(s.step, s.status, s.scores) for s in ev.steps],
                    w.logged)
    assert evs["port"] == evs["ref"]
    assert evs["port"][2][0] == (1, {"eval/accuracy": 0.6, "eval/n": 4})


def test_evaluator_command_runs_on_the_device(tmp_path):
    ev = tev.AutomaticEvaluator(
        AutomaticEvaluatorConfig(max_gen_tokens=16, eval_k=4,
                                 temperature=0.7),
        save_dir=str(tmp_path), dataset_path="d.jsonl", mock_tokenizer=True)
    cmd = ev._command(tev.EvaluationStep(2, "/c/step2"), "/o.json")
    assert cmd[1:3] == ["-m", "areal_tpu_torch.apps.eval_ckpt"]
    assert cmd[cmd.index("--device") + 1] == "cuda"
    assert cmd[cmd.index("--k") + 1] == "4"
    assert cmd[cmd.index("--temperature") + 1] == "0.7"
    assert "--mock-tokenizer" in cmd
    ev = tev.AutomaticEvaluator(AutomaticEvaluatorConfig(),
                                save_dir=str(tmp_path),
                                dataset_path="d.jsonl", device="cpu")
    cmd = ev._command(tev.EvaluationStep(2, "/c/step2"), "/o.json")
    assert cmd[cmd.index("--device") + 1] == "cpu" and "--k" not in cmd


_SLEEPER = "import time; time.sleep(60)"
# ignores SIGTERM once it has written its argument's file
_STUBBORN = ("import signal, sys, time; signal.signal(signal.SIGTERM, "
             "signal.SIG_IGN); open(sys.argv[1], 'w').close(); "
             "time.sleep(60)")


def _wait(pred, secs=30.0):
    deadline = time.monotonic() + secs
    while time.monotonic() < deadline and not pred():
        time.sleep(0.05)
    return pred()


def test_reference_stop_leaves_the_eval_subprocess_running(tmp_path):
    """The reference's fault (evaluator.py:206-209): stop() joins the
    watcher for 10 s, and the eval subprocess it waits on (the reference's
    own ``subprocess.run(..., timeout=3600)``, here injected) outlives it."""
    root = str(tmp_path)
    _fake_ckpt(root, "actor", 1)
    pids = []

    def run_eval(step):
        proc = subprocess.Popen([sys.executable, "-c", _SLEEPER])
        pids.append(proc.pid)
        proc.wait(timeout=3600)  # subprocess.run's wait
        return {"accuracy": 1.0}

    ev = jev.AutomaticEvaluator(JEvalConfig(), save_dir=root,
                                dataset_path="unused.jsonl",
                                run_eval=run_eval, poll_secs=0.1)
    ev.start()
    try:
        assert _wait(lambda: pids)
        ev.stop()
        assert _alive(pids[0])  # the fault
        assert ev._thread.is_alive()
    finally:
        for pid in pids:
            os.kill(pid, 9)


@pytest.mark.parametrize("script", [_SLEEPER, _STUBBORN])
def test_port_stop_ends_the_eval_subprocess(tmp_path, monkeypatch, script):
    """The port's stop() ends a running eval subprocess within its bound:
    SIGTERM, then SIGKILL for one that ignores it; the watcher is joined
    and the step marked failed."""
    root = str(tmp_path)
    _fake_ckpt(root, "default", 1)
    armed = str(tmp_path / "armed")
    monkeypatch.setattr(tev.AutomaticEvaluator, "STOP_TERMINATE_SECS", 2.0)
    monkeypatch.setattr(tev.AutomaticEvaluator, "_command",
                        lambda self, step, out: [sys.executable, "-c",
                                                 script, armed])
    ev = tev.AutomaticEvaluator(AutomaticEvaluatorConfig(), save_dir=root,
                                dataset_path="unused.jsonl", role="default",
                                poll_secs=0.1, device="cpu")
    ev.start()
    assert _wait(lambda: ev._procs)
    (proc,) = ev._procs
    if script is _STUBBORN:
        assert _wait(lambda: os.path.exists(armed))
    t0 = time.monotonic()
    ev.stop()
    assert time.monotonic() - t0 < 3 * ev.STOP_TERMINATE_SECS
    assert proc.poll() is not None and not _alive(proc.pid)
    assert proc.returncode == (-9 if script is _STUBBORN else -15)
    assert not ev._thread.is_alive() and not ev._procs
    assert [s.status for s in ev.steps] == ["failed"]
    ev.poll_once()  # stopped: nothing new starts
    assert not ev._procs


def test_eval_grades_on_the_reward_fleet_when_asked():
    """``--reward-service``: the eval process installs the service client
    under the run's RewardServiceConfig (unknown keys dropped, enabled)."""
    from areal_tpu_torch.rewards import client as tclient

    try:
        teval._configure_reward_service(
            {"local_fallback": False, "n_workers": 3, "not_a_field": 1},
            "exp", "trial")
        svc = tclient.service_client()
        assert svc is not None
        assert svc.cfg.enabled and svc.cfg.local_fallback is False
        assert svc.cfg.n_workers == 3
    finally:
        tclient.configure_service(None)
    assert tclient.service_client() is None


def test_evaluator_hands_the_fleet_to_its_subprocess(tmp_path, monkeypatch):
    """With the reward fleet on, the eval subprocess gets
    ``--reward-service`` with the run's config and the name-resolve root in
    ``AREAL_NAME_RESOLVE_ROOT`` (reference evaluator.py:128-134)."""
    seen = {}

    class FakePopen:
        returncode = 0

        def __init__(self, cmd, env=None, **kw):
            seen.update(cmd=cmd, env=env)
            with open(cmd[cmd.index("--output") + 1], "w") as f:
                json.dump({"accuracy": 1.0}, f)

        def communicate(self, timeout=None):
            return "", ""

    monkeypatch.setattr(tev.subprocess, "Popen", FakePopen)
    ev = tev.AutomaticEvaluator(
        AutomaticEvaluatorConfig(), save_dir=str(tmp_path),
        dataset_path="d.jsonl", device="cpu",
        reward_service=("exp", "trial", "/nr/root", '{"n_workers": 2}'))
    assert ev._subprocess_eval(tev.EvaluationStep(1, "/c/step1")) == {
        "accuracy": 1.0}
    cmd = seen["cmd"]
    i = cmd.index("--reward-service")
    assert cmd[i + 1:i + 3] == ["exp", "trial"]
    assert cmd[cmd.index("--reward-service-config") + 1] == '{"n_workers": 2}'
    assert seen["env"]["AREAL_NAME_RESOLVE_ROOT"] == "/nr/root"
    assert seen["env"]["PYTHONPATH"].split(os.pathsep)[0] == tev._ROOT
