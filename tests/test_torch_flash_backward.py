"""The flash-attention backward of the port (areal_tpu_torch/ops/
flash_attention.py: ``flash_attention_bwd_plain``, the plain version of K2
and K3, and ``FlashAttention``) against the reference package on the CPU.

 - The plain backward against ``jax.vjp`` of the reference's
   ``packed_attention(impl="reference")`` in float32 at 1e-5 (same
   arithmetic, different summation order), over the packing cases of
   tests/test_torch_attention.py with GQA; pad rows get dq = 0 and pad
   columns dk = dv = 0 exactly.
 - Against the Pallas TPU backward run in interpret mode at 2e-2 (the
   tolerance of tests/test_pallas_attention.py, whose case this mirrors).
 - ``torch.autograd.gradcheck`` of ``FlashAttention`` in float64.
The kernels themselves run only on the card (tests/test_torch_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.ops import attention as jattn
from areal_tpu.ops.pallas import flash_attention as jfa
from areal_tpu_torch.ops import attention as tattn
from areal_tpu_torch.ops import flash_attention as tfa
from test_torch_attention import SEQLENS, _case


@jax.jit
def _reference_vjp(q, k, v, seg, pos, dout):
    def f(q, k, v):
        return jattn.packed_attention(q, k, v, seg, seg, q_positions=pos,
                                      kv_positions=pos, causal=True,
                                      impl="reference")

    return jax.vjp(f, q, k, v)[1](dout)


def _reference_grads(q, k, v, seg, pos, dout):
    return [np.asarray(g) for g in _reference_vjp(
        *map(jnp.asarray, (q, k, v, seg, pos, dout)))]


@pytest.mark.parametrize("seqlens,row_len", SEQLENS)
@pytest.mark.parametrize("D,Hq,Hkv", [(64, 4, 2), (128, 6, 2), (256, 8, 1)])
def test_plain_backward_matches_reference(seqlens, row_len, D, Hq, Hkv):
    q, k, v, seg, pos = _case(seqlens, row_len, Hq=Hq, Hkv=Hkv, D=D, seed=7)
    dout = np.random.RandomState(8).randn(*q.shape).astype(np.float32)
    want = _reference_grads(q, k, v, seg, pos, dout)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    ts = torch.from_numpy(seg)
    out, lse = tfa.flash_attention(tq, tk, tv, ts, ts, return_lse=True)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, ts, ts, out, lse,
                                        torch.from_numpy(dout))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, err_msg=name)
        assert (a.numpy()[seg == 0] == 0).all(), name
    # through autograd: the dispatcher's "flash" path is FlashAttention
    xs = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    o = tattn.packed_attention(*xs, ts, ts, impl="flash")
    o.backward(torch.from_numpy(dout))
    for a, b in zip(xs, got):
        assert torch.equal(a.grad, b)


def test_plain_backward_matches_pallas_interpreted():
    ctx = jfa.interpret_mode()
    if ctx is None:
        pytest.skip("this jax cannot interpret the Pallas TPU flash kernel")
    q, k, v, seg, _ = _case([96, 32], None, Hq=2, Hkv=2, D=128, seed=0)

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, jnp.asarray(seg), jnp.asarray(seg))
        return jnp.sum(o * o)

    with ctx:
        want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        want = [np.asarray(jax.block_until_ready(g)) for g in want]
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ts = torch.from_numpy(seg)
    o = tfa.FlashAttention.apply(*xs, ts, ts)
    (o * o).sum().backward()
    for name, a, b in zip("qkv", xs, want):
        np.testing.assert_allclose(a.grad.numpy(), b, atol=2e-2,
                                   err_msg=f"grad mismatch for {name}")


def test_flash_attention_function_gradcheck():
    rng = np.random.RandomState(3)
    seg = torch.tensor([[1, 1, 1, 2, 2, 0], [1, 1, 1, 1, 0, 0]], dtype=torch.int32)
    q, k, v = (torch.from_numpy(rng.randn(2, 6, h, 4)).requires_grad_()
               for h in (4, 2, 2))
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.FlashAttention.apply(q, k, v, seg, seg), (q, k, v))
