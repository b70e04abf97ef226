"""Port generation server (areal_tpu_torch/system/generation_server.py) on
``device="cpu"`` over real localhost HTTP.

Greedy replies must equal the reference's ``prefill_state`` +
``decode_chunk_rows`` on the same weights (tokens identical, logprobs within
1e-4), and a ``rid`` continuation must decode from the retained KV without a
new prefill.
"""

import concurrent.futures
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import _jparams, make_model

from areal_tpu.api.model import GenerationHyperparameters as JGen
from areal_tpu.models import generate as jgen
from areal_tpu.ops import sampling as jsamp
from areal_tpu_torch.system.generation_server import (
    GenerationServer,
    GenerationServerConfig,
)

EOS = 96


@pytest.fixture(scope="module")
def served():
    jcfg, tcfg, flat, _ = make_model("qwen2", seed=5)
    from areal_tpu_torch.models.convert import params_from_jax

    server = GenerationServer(
        GenerationServerConfig(chunk_tokens=8, prompt_bucket=16, kv_bucket=32,
                               eos_token_id=EOS, batch_window_ms=20),
        tcfg, params_from_jax(flat, tcfg, device="cpu"), device="cpu",
    )
    url = server.start()
    yield server, url, jcfg, flat
    server.stop()


def _post(url, body, path="/generate"):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _reference(jcfg, flat, prompt, n):
    """Greedy tokens/logprobs of the reference's chunked decode path."""
    padded, plens = jgen.pad_prompts([prompt], 0, bucket=16)
    st = jgen.prefill_state(_jparams(flat), jcfg, jnp.asarray(padded),
                            jnp.asarray(plens), S=64)
    _, out = jgen.decode_chunk_rows(
        _jparams(flat), jcfg, st, jnp.zeros(1, jnp.int32),
        jax.random.PRNGKey(0),
        jsamp.sampling_from_gconfigs([JGen(greedy=True)]), n_tokens=n,
        eos_token_id=EOS, pad_token_id=0)
    k = int(out["output_lens"][0])
    return (np.asarray(out["output_ids"][0][:k]).tolist(),
            np.asarray(out["output_logprobs"][0][:k]))


def test_concurrent_greedy_replies_match_reference(served):
    server, url, jcfg, flat = served
    rng = np.random.RandomState(6)
    prompts = [rng.randint(2, 90, n).tolist() for n in (5, 9, 12)]
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        replies = list(pool.map(lambda p: _post(url, {
            "prompt_ids": p, "gconfig": {"greedy": True}, "max_tokens": 6,
        }), prompts))
    for p, r in zip(prompts, replies):
        toks, lps = _reference(jcfg, flat, p, 6)
        assert r["output_ids"] == toks
        np.testing.assert_allclose(r["output_logprobs"], lps, atol=1e-4)
        assert r["finished"] == (EOS in toks) and r["version"] == 0


def test_rid_continuation_reuses_kv(served):
    server, url, jcfg, flat = served
    prompt = np.random.RandomState(7).randint(2, 90, 7).tolist()
    first = _post(url, {"prompt_ids": prompt, "gconfig": {"greedy": True},
                        "max_tokens": 12, "rid": "a"})
    assert len(first["output_ids"]) == 8 and not first["finished"]
    assert server.kv.count == 1
    before = server.stats()
    cont = _post(url, {"prompt_ids": prompt + first["output_ids"],
                       "gconfig": {"greedy": True}, "max_tokens": 4,
                       "rid": "a", "tokens_done": 8})
    after = server.stats()
    assert after["prefill_calls"] == before["prefill_calls"]
    assert after["prefill_tokens"] == before["prefill_tokens"]
    assert server.kv.count == 0  # budget spent: state released
    toks, lps = _reference(jcfg, flat, prompt, 12)
    assert first["output_ids"] + cont["output_ids"] == toks
    np.testing.assert_allclose(first["output_logprobs"] + cont["output_logprobs"],
                               lps, atol=1e-4)


def test_health_and_bad_requests(served):
    server, url, _, _ = served
    with urllib.request.urlopen(url + "/health", timeout=10) as r:
        assert json.loads(r.read())["ok"]
    for body in ({"prompt_ids": [1, 200]}, {"gconfig": {}},
                 {"prompt_ids": [3], "max_tokens": 0}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, body)
        assert e.value.code == 400


def test_server_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from areal_tpu_torch.models.config import tiny_config

    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationServer(GenerationServerConfig(), tiny_config(), {})
