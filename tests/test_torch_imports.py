"""The port stands alone: every module of areal_tpu_torch imports with ``jax``,
``safetensors``, ``transformers``, ``zmq``, ``aiohttp``, ``msgpack`` and
``yaml`` blocked (the machine with the card is not known to have any of
them), and no file of the package (nor chip_smoke.py) names ``jax`` or a
module of the reference package, nor imports one of the others. The rollout
worker's module imports without initialising CUDA, and a reward worker
grades without it and without importing torch."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import areal_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "areal_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
BLOCKED = ("jax", "safetensors", "transformers", "zmq", "aiohttp",
           "msgpack", "yaml")
for blocked in BLOCKED:
    sys.modules[blocked] = None  # any import of it now raises ImportError
import areal_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    areal_tpu_torch.__path__, "areal_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(m in BLOCKED or m.startswith(
                   tuple(b + "." for b in BLOCKED + ("areal_tpu",)))
               for m in sys.modules if sys.modules[m] is not None)
print(len(names))
"""


def test_every_module_imports_with_jax_blocked():
    """(``safetensors``, ``transformers``, ``zmq``, ``aiohttp``, ``msgpack``
    and ``yaml`` are blocked as well.)"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 96  # every module was walked


def test_no_file_names_jax_or_the_reference_package():
    files = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = re.compile(r"\bjax\b|\bareal_tpu\."
                     r"|\b(import|from) (safetensors|transformers|zmq|aiohttp"
                     r"|msgpack|yaml)\b")
    for path in files:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            assert not bad.search(line), f"{path.relative_to(ROOT)}:{i}: {line}"


def test_observability_modules_import_profiler_lazily():
    """The observability modules import cleanly on their own, and
    ``torch.profiler`` (which needs the card's profiler libraries to start
    a CUDA capture) is imported only inside the functions that start one,
    never at a module's top level."""
    import ast
    import importlib

    for name in ("base.telemetry", "base.compile_watch", "system.goodput",
                 "system.memwatch", "system.sentinel"):
        importlib.import_module(f"areal_tpu_torch.{name}")
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in tree.body:
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            assert not any(m.startswith("torch.profiler") for m in mods), \
                f"{path.relative_to(ROOT)}:{node.lineno}"
    tel = ast.parse((PKG / "base" / "telemetry.py").read_text())
    top = {a.name.split(".")[0] for n in tel.body if isinstance(n, ast.Import)
           for a in n.names}
    assert "torch" not in top  # the rollout worker's process stays lean


_ROLLOUT_NO_CUDA = """
import torch
import areal_tpu_torch.system.rollout_worker
import areal_tpu_torch.apps.launcher
assert not torch.cuda.is_initialized()
print("ok")
"""


def test_rollout_worker_import_leaves_cuda_alone():
    """The rollout worker's process never initialises CUDA: importing its
    module (and the launcher's entries) does not."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _ROLLOUT_NO_CUDA], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


_REWARD_NO_CUDA = """
import json
import os
os.environ["CUDA_VISIBLE_DEVICES"] = ""
import sys
for blocked in ("jax", "zmq", "aiohttp", "msgpack", "yaml"):
    sys.modules[blocked] = None
import torch
from areal_tpu_torch.api.train_config import RewardServiceConfig
from areal_tpu_torch.base import name_resolve
from areal_tpu_torch.system import reward_worker, supervisor  # noqa: F401
from areal_tpu_torch.system.http import request_json
name_resolve.DEFAULT_REPO = name_resolve.MemoryNameRecordRepo()
w = reward_worker.RewardWorker(reward_worker.RewardWorkerConfig(
    reward=RewardServiceConfig(enabled=True)))
url = w.start()
nl = chr(10)
task = {"task": "code", "generated": "```python" + nl + "print(input())"
        + nl + "```", "input_output": json.dumps(
            {"inputs": ["1" + nl], "outputs": ["1" + nl]})}
assert request_json(url + "/code_verify", task)[1]["score"] == 1.0
w.stop()
assert not torch.cuda.is_initialized()
print("ok")
"""


def test_reward_worker_grades_without_cuda():
    """A reward worker, as the launcher starts one (every card hidden),
    imports and grades code with jax, zmq, aiohttp, msgpack and yaml
    blocked, and never initialises CUDA."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _REWARD_NO_CUDA], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


_REWARD_NO_TORCH = """
import json
import os
import pickle
import sys
os.environ["CUDA_VISIBLE_DEVICES"] = ""
sys.modules["torch"] = None  # any import of torch raises
from areal_tpu_torch.apps import launcher
from areal_tpu_torch.experiments import common as C
from areal_tpu_torch.experiments.async_ppo_math_exp import AsyncPPOMATHConfig
from areal_tpu_torch.system.http import request_json
from areal_tpu_torch.system.reward_worker import RewardWorker
from areal_tpu_torch.training import main_async_ppo, main_sync_ppo  # noqa
from areal_tpu_torch.training import main_sft  # noqa
from areal_tpu_torch.experiments.sft_exp import SFTConfig
from areal_tpu_torch.apps import evaluator  # noqa
assert SFTConfig(trial_name='t').model.backend == 'torch_train'
exp = AsyncPPOMATHConfig(experiment_name="e", trial_name="t")
exp.reward_service.enabled = True
exp.cluster.name_resolve.type = "memory"
exp, (rw, *_) = pickle.loads(pickle.dumps((exp, exp.build_reward_workers())))
C.setup_name_resolve(exp)
assert launcher.reward_worker_entry is not None
w = RewardWorker(rw)
url = w.start()
nl = chr(10)
math = {"task": "math", "generated": "\\boxed{4}", "solutions": ["4"]}
code = {"task": "code", "generated": "```python" + nl + "print(input())"
        + nl + "```", "input_output": json.dumps(
            {"inputs": ["1" + nl], "outputs": ["1" + nl]})}
assert request_json(url + "/math_verify", math)[1]["score"] == 1.0
assert request_json(url + "/code_verify", code)[1]["score"] == 1.0
w.stop()
print("ok")
"""


def test_reward_worker_path_imports_no_torch():
    """A spawned reward worker loads the launcher's entry, the experiment
    config it is handed (pickled), the training mains (the spawn's main
    module) and the reward modules: none of them imports torch, so a
    sandbox worker pays no torch in host memory. Torch is blocked."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _REWARD_NO_TORCH], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


_FLEET_NO_TORCH = """
import sys
for blocked in ("torch", "jax", "zmq", "aiohttp", "msgpack", "yaml"):
    sys.modules[blocked] = None
from areal_tpu_torch.system import autoscaler, sample_spool
from areal_tpu_torch.api.cli_args import BaseExperimentConfig, validate_config
cfg = BaseExperimentConfig(backend="cpu")
cfg.durability.enabled = cfg.autoscale.enabled = True
validate_config(cfg)
assert autoscaler.AutoscalerCore and sample_spool.SampleSpool
print("ok")
"""


def test_spool_and_autoscaler_modules_import_without_torch():
    """The durable spool (a rollout worker's process), the autoscaler (the
    launcher's executor and the manager) and the validation of their config
    blocks import and run with torch, jax, zmq, aiohttp, msgpack and yaml
    blocked."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _FLEET_NO_TORCH], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_resolve_device():
    assert areal_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        areal_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError):
        areal_tpu_torch.resolve_device("cuda")


def test_entry_points_need_a_device():
    """Without a GPU and without an explicit device, the helpers that make
    tensors raise instead of landing on the CPU."""
    from areal_tpu_torch.api.model import FinetuneSpec, Model, make_backend
    from areal_tpu_torch.api.train_config import ServingConfig
    from areal_tpu_torch.apps.launcher import run_experiment
    from areal_tpu_torch.experiments.async_ppo_math_exp import (
        AsyncPPOMATHConfig,
    )
    from areal_tpu_torch.experiments.sft_exp import SFTConfig
    from areal_tpu_torch.backend import torch_train  # noqa: F401 (registry)
    from areal_tpu_torch.models.config import tiny_config
    from areal_tpu_torch.models.convert import params_from_jax
    from areal_tpu_torch.models.hf import load_hf_checkpoint
    from areal_tpu_torch.models.transformer import init_kv_cache, init_params
    from areal_tpu_torch.system.generation_server import (
        GenerationServer,
        GenerationServerConfig,
    )
    from areal_tpu_torch.system.trainer_worker import (
        TrainerWorker,
        TrainerWorkerConfig,
    )
    from areal_tpu_torch.tools.perf_probe import decode_bench

    cfg = tiny_config()
    assert init_params(cfg, seed=0, device="cpu")["final_ln.weight"].is_cpu
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    flat = {"final_ln": torch.ones(cfg.hidden_dim).numpy()}
    params = init_params(cfg, seed=0, device="cpu")
    for make in (lambda: init_params(cfg, seed=0),
                 lambda: init_kv_cache(cfg, 1, 8),
                 lambda: params_from_jax(flat, cfg),
                 lambda: make_backend("torch_inference").initialize(
                     Model("ref", (cfg, params)), FinetuneSpec()),
                 lambda: load_hf_checkpoint("no/such/dir"),
                 lambda: TrainerWorker(TrainerWorkerConfig()).setup(),
                 lambda: run_experiment(AsyncPPOMATHConfig()),
                 lambda: run_experiment(SFTConfig()),
                 lambda: GenerationServer(GenerationServerConfig(
                     serving=ServingConfig(enabled=True)), cfg, params)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # the probe's burst needs a live server on a card: none listening, it
    # raises instead of reporting numbers
    from areal_tpu_torch.base.network import find_free_port

    with pytest.raises(OSError):
        decode_bench(f"http://127.0.0.1:{find_free_port()}", n_requests=2)


_MESH_NO_TORCH = """
import sys
for blocked in ("torch", "jax"):
    sys.modules[blocked] = None
from areal_tpu_torch.parallel import mesh
from areal_tpu_torch.apps.launcher import derive_chip_assignment
am = mesh.AllocationMode.parse("gen.d1+f2t2")
assert am.decoupled and am.global_spec.mesh_shape() == (1, 2, 1, 1, 1, 2)
assert derive_chip_assignment("gen.d1+f2", 3) == {"trainer": [0, 1],
                                                  "gen": [2]}
print("ok")
"""


@pytest.mark.parametrize("module", [
    "parallel.mesh", "parallel.distributed", "parallel.sharding",
    "parallel.reshard"])
def test_parallel_modules_import(module):
    """The multi-GPU modules import on their own and start no process
    group (the mesh's torch import waits for ``make_mesh``)."""
    import importlib

    importlib.import_module(f"areal_tpu_torch.{module}")
    assert not torch.distributed.is_initialized()


def test_allocation_and_gpu_assignment_need_no_torch():
    """The launcher parses allocations and assigns GPUs with torch
    blocked: the experiment configs and the launcher's process load none."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _MESH_NO_TORCH], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
