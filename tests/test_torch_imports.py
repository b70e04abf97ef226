"""The port stands alone: every module of areal_tpu_torch imports with ``jax``,
``safetensors``, ``transformers``, ``zmq`` and ``aiohttp`` blocked (the
machine with the card has none of them), and no file of the package (nor
chip_smoke.py) names ``jax`` or a module of the reference package, nor
imports one of the others."""

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
BLOCKED = ("jax", "safetensors", "transformers", "zmq", "aiohttp")
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
    """(``safetensors``, ``transformers``, ``zmq`` and ``aiohttp`` are
    blocked as well.)"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 35  # every module was walked


def test_no_file_names_jax_or_the_reference_package():
    files = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = re.compile(r"\bjax\b|\bareal_tpu\."
                     r"|\b(import|from) (safetensors|transformers|zmq|aiohttp)\b")
    for path in files:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            assert not bad.search(line), f"{path.relative_to(ROOT)}:{i}: {line}"


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
    from areal_tpu_torch.backend import torch_train  # noqa: F401 (registry)
    from areal_tpu_torch.models.config import tiny_config
    from areal_tpu_torch.models.convert import params_from_jax
    from areal_tpu_torch.models.hf import load_hf_checkpoint
    from areal_tpu_torch.models.transformer import init_kv_cache, init_params

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
                 lambda: load_hf_checkpoint("no/such/dir")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
