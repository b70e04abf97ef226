"""The port's checkpoints (areal_tpu_torch/base/safetensors_io.py,
models/hf.py) against the ``safetensors`` and ``transformers`` packages and
the reference's models/hf.py, on the CPU at ``tiny_config`` size.

Weights cross every boundary bit for bit (the files hold the same bytes);
logits through ``transformers`` agree at atol 2e-4 / rtol 2e-3 in float32
(another attention and summation order; tests/test_model_parity.py's
tolerance).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import safetensors
import safetensors.numpy as snp
import safetensors.torch as stt
import torch

from areal_tpu.models import hf as jhf
from areal_tpu_torch.base import safetensors_io as sio
from areal_tpu_torch.models import config as tconfig
from areal_tpu_torch.models import hf as thf
from areal_tpu_torch.models.convert import params_from_jax, params_to_jax
from areal_tpu_torch.models.transformer import Transformer
from test_torch_model import _jparams
from test_torch_trainer import weights

QWEN2 = dict(hf_family="qwen2", use_attention_bias=True,
             tie_word_embeddings=False, vocab_size=97)


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "w32": torch.randn(5, 7, generator=g),
        "wbf16": torch.randn(3, 9, generator=g).to(torch.bfloat16),
        "i32": torch.randint(-9, 9, (11,), generator=g, dtype=torch.int32),
        "odd_bf16": torch.randn(3, generator=g).to(torch.bfloat16),
        "mask": torch.rand(5, generator=g) > 0.5,
        "step": torch.tensor(7),
    }


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def test_safetensors_files_read_in_the_safetensors_package(tmp_path):
    """Every tensor the port writes reads back byte for byte in the
    safetensors package (numpy for f32 and int32; the raw reader for bf16,
    which numpy lacks); and the port reads the package's files."""
    ts = _tensors()
    path = str(tmp_path / "port.safetensors")
    n = sio.save_file(ts, path, metadata={"format": "pt"})
    assert n == os.path.getsize(path)
    with open(path, "rb") as f:
        raw = dict(safetensors.deserialize(f.read()))
    assert set(raw) == set(ts)
    for name, t in ts.items():
        assert bytes(raw[name]["data"]) == _bits(t), name
        assert list(raw[name]["shape"]) == list(t.shape), name
    with safetensors.safe_open(path, "np") as f:
        assert f.metadata() == {"format": "pt"}
        for name in ("w32", "i32", "mask", "step"):
            np.testing.assert_array_equal(f.get_tensor(name), ts[name].numpy())
    for name, t in stt.load_file(path).items():
        assert t.dtype == ts[name].dtype and torch.equal(t, ts[name]), name
    # the other way round
    theirs = str(tmp_path / "theirs.safetensors")
    stt.save_file(ts, theirs)
    back = sio.load_file(theirs)
    for name, t in ts.items():
        assert back[name].dtype == t.dtype and torch.equal(back[name], t), name
    snp.save_file({k: ts[k].numpy() for k in ("w32", "i32")}, theirs)
    back = sio.load_file(theirs)
    assert torch.equal(back["w32"], ts["w32"])
    assert torch.equal(back["i32"], ts["i32"])


def test_sharded_state_dict_with_index(tmp_path):
    """A sharded write (one file per ~shard_bytes plus the HF index) reads
    in the safetensors package, in the reference's reader and in the
    port's."""
    g = torch.Generator().manual_seed(1)
    sd = {f"t{i}": torch.randn(16, 8, generator=g) for i in range(6)}
    sd["ids"] = torch.arange(10, dtype=torch.int32)
    out = str(tmp_path / "sharded")
    n = thf.save_hf_state_dict(sd, out, shard_bytes=1024)
    files = sorted(f for f in os.listdir(out) if f.endswith(".safetensors"))
    assert len(files) == 4 and n == sum(
        os.path.getsize(os.path.join(out, f)) for f in files)
    with open(os.path.join(out, "model.safetensors.index.json")) as f:
        index = json.load(f)
    assert set(index["weight_map"]) == set(sd)
    for fn in files:
        for k, a in snp.load_file(os.path.join(out, fn)).items():
            assert index["weight_map"][k] == fn
            np.testing.assert_array_equal(a, sd[k].numpy())
    ref = jhf.load_hf_state_dict(out)
    port = thf.load_hf_state_dict(out)
    for k, t in sd.items():
        np.testing.assert_array_equal(ref[k], t.numpy())
        assert torch.equal(port[k], t)
    bf = {k: v.to(torch.bfloat16) for k, v in sd.items() if k != "ids"}
    thf.save_hf_state_dict(bf, str(tmp_path / "bf"), shard_bytes=512)
    back = thf.load_hf_state_dict(str(tmp_path / "bf"))
    for k, t in bf.items():
        assert back[k].dtype == torch.bfloat16 and torch.equal(back[k], t)


def _logits(cfg, params, ids: np.ndarray) -> np.ndarray:
    model = Transformer.from_params(cfg, params)
    B, T = ids.shape
    with torch.no_grad():
        out, _ = model(torch.from_numpy(ids), torch.arange(T).expand(B, T),
                       torch.ones(B, T, dtype=torch.int32), return_kv=False)
    return out.numpy()


def _flat_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), k)


@pytest.mark.parametrize("kw", [QWEN2, dict(QWEN2, is_critic=True)])
def test_hf_checkpoint_crosses_packages(kw, tmp_path):
    """The port's HF checkpoint loads in the reference (and the
    reference's in the port) bit for bit, a critic's ``score.weight``
    included; the actor's loads in ``transformers`` with the same logits."""
    jcfg, tcfg, flat = weights(seed=3, **kw)
    params = params_from_jax(flat, tcfg, device="cpu")
    out = str(tmp_path / "port")
    n = thf.save_hf_checkpoint(params, tcfg, out, meta={"version": 3})
    assert n == os.path.getsize(os.path.join(out, "model.safetensors"))
    jcfg2, jparams = jhf.load_hf_checkpoint(out)
    assert dataclasses.asdict(jcfg2) == dataclasses.asdict(tcfg)
    _flat_equal(jhf.flatten_pytree(jax.device_get(jparams), as_numpy=True),
                flat)
    if kw.get("is_critic"):
        sd = snp.load_file(os.path.join(out, "model.safetensors"))
        np.testing.assert_array_equal(sd["score.weight"],
                                      flat["value_head"].T)
    # the reference's checkpoint in the port
    ref = str(tmp_path / "ref")
    jhf.save_hf_checkpoint(_jparams(flat), jcfg, ref, meta={"version": 4})
    tcfg2, tparams = thf.load_hf_checkpoint(ref, device="cpu")
    assert tcfg2 == tcfg
    assert set(tparams) == set(params)
    for k, t in params.items():
        assert torch.equal(tparams[k], t), k
    if kw.get("is_critic"):
        return
    import transformers

    hf_model = transformers.AutoModelForCausalLM.from_pretrained(out)
    ids = np.random.RandomState(5).randint(0, 97, (2, 12))
    with torch.no_grad():
        theirs = hf_model(input_ids=torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(_logits(tcfg, params, ids), theirs,
                               atol=2e-4, rtol=2e-3)


def test_load_hf_model_from_a_transformers_directory(tmp_path):
    """A directory ``transformers`` wrote (config.json + safetensors) loads
    through the port's json reader and mapping, with HF's logits; as a
    critic without ``score.weight`` it gets a zero value head."""
    import transformers

    hf_cfg = transformers.Qwen2Config(
        vocab_size=97, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, tie_word_embeddings=False)
    torch.manual_seed(0)
    hf_model = transformers.AutoModelForCausalLM.from_config(hf_cfg).eval()
    hf_model.save_pretrained(str(tmp_path), safe_serialization=True)
    cfg, params = thf.load_hf_model(str(tmp_path), device="cpu")
    assert cfg.hf_family == "qwen2" and cfg.use_attention_bias
    assert cfg.sliding_window is None and cfg.n_kv_heads == 2
    ids = np.random.RandomState(6).randint(0, 97, (2, 10))
    with torch.no_grad():
        theirs = hf_model(input_ids=torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(_logits(cfg, params, ids), theirs,
                               atol=2e-4, rtol=2e-3)
    ccfg, cparams = thf.load_hf_model(str(tmp_path), is_critic=True,
                                      device="cpu")
    assert ccfg.is_critic and not cparams["value_head.weight"].any()
    assert "lm_head.weight" not in cparams


@pytest.mark.parametrize("kw", [QWEN2, dict(QWEN2, is_critic=True)])
def test_native_checkpoint_crosses_packages(kw, tmp_path):
    """The weight-sync layout: the reference's flattened names and stacked
    layers, written by either package and read by the other bit for bit;
    within the port, bf16 stays bf16."""
    jcfg, tcfg, flat = weights(seed=4, **kw)
    params = params_from_jax(flat, tcfg, device="cpu")
    out = str(tmp_path / "port")
    thf.save_native_checkpoint(params, tcfg, out, meta={"version": 7})
    assert jhf.is_native_checkpoint(out) and thf.is_native_checkpoint(out)
    jcfg2, jparams = jhf.load_checkpoint_auto(out)
    assert dataclasses.asdict(jcfg2) == dataclasses.asdict(tcfg)
    _flat_equal(jhf.flatten_pytree(jparams, as_numpy=True), flat)
    ref = str(tmp_path / "ref")
    jhf.save_native_checkpoint(_jparams(flat), jcfg, ref, meta={"version": 8})
    tcfg2, tparams = thf.load_checkpoint_auto(ref, device="cpu")
    assert tcfg2 == tcfg
    for k, t in params.items():
        assert torch.equal(tparams[k], t), k
    bf = {k: v.to(torch.bfloat16) for k, v in params.items()}
    thf.save_native_checkpoint(bf, tcfg, str(tmp_path / "bf"))
    _, back = thf.load_native_checkpoint(str(tmp_path / "bf"), device="cpu")
    for k, t in bf.items():
        assert back[k].dtype == torch.bfloat16 and torch.equal(back[k], t), k
    _flat_equal(params_to_jax(back, tcfg), params_to_jax(bf, tcfg))


_HF_KEYS = ("num_hidden_layers", "hidden_size", "num_attention_heads",
            "num_key_value_heads", "head_dim", "intermediate_size",
            "vocab_size", "rope_theta", "rms_norm_eps", "tie_word_embeddings",
            "sliding_window", "use_sliding_window")
_HF_FULL = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
                num_key_value_heads=2, head_dim=16, intermediate_size=64,
                vocab_size=97, rope_theta=1e6, rms_norm_eps=1e-5,
                tie_word_embeddings=True, sliding_window=24,
                use_sliding_window=True)


@pytest.mark.parametrize("left_out", ("nothing",) + _HF_KEYS
                         + ("null head_dim", "null num_key_value_heads",
                            "no window flag or size"))
@pytest.mark.parametrize("family", ["llama", "qwen2", "qwen3", "mistral"])
def test_config_from_hf_defaults_match_the_reference(family, left_out):
    """A ``config.json`` that leaves a key out (or sets it null): the port's
    json reader fills in what the family's ``transformers`` config does, so
    every field equals the reference's ``config_from_hf`` over
    ``AutoConfig.for_model``."""
    import transformers

    d = dict(_HF_FULL)
    if left_out.startswith("null "):
        d[left_out[5:]] = None
    elif left_out == "no window flag or size":
        del d["sliding_window"], d["use_sliding_window"]
    elif left_out != "nothing":
        del d[left_out]
    ref = jhf.config_from_hf(transformers.AutoConfig.for_model(family, **d))
    port = thf.config_from_hf({"model_type": family, **d})
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_unported_families_raise():
    for kw in (dict(hf_family="gpt2"), dict(hf_family="gemma"),
               dict(hf_family="qwen2", moe=dict(num_experts=4, top_k=2))):
        cfg = tconfig.tiny_config(**kw)
        with pytest.raises(NotImplementedError):
            thf.hf_config_dict(cfg)
    with pytest.raises(NotImplementedError):
        thf.config_from_hf({"model_type": "gpt2"})
