"""Port attention (areal_tpu_torch/ops) against the reference package.

The port's plain version of the flash kernel and its ``packed_attention``
dispatcher run on CPU tensors here; the same numpy inputs go through the
reference's ``attention_reference`` / ``packed_attention(impl="reference")``
and, for one case, its Pallas kernel in interpret mode. Tolerances: 1e-5 in
float32 (same arithmetic, different summation order), 2e-2 against the
interpreted Pallas kernel (the reference's own test tolerance). The kernel
itself runs only on the card (tests/test_torch_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.models import packing
from areal_tpu.ops import attention as jattn
from areal_tpu.ops.pallas import flash_attention as jfa
from areal_tpu_torch.ops import attention as tattn
from areal_tpu_torch.ops import flash_attention as tfa

SEQLENS = [
    ([128], None), ([60, 68], None), ([100, 20, 120, 9], None),
    ([300, 340], None),
    ([90, 70, 30, 150], 200),  # ragged T=200: no 128-multiple tiling
]


def _case(seqlens, row_len, Hq=4, Hkv=2, D=64, seed=0):
    rng = np.random.RandomState(seed)
    layout = packing.plan_packing(seqlens, length_bucket=128, row_len=row_len)
    grid = packing.make_grid(layout)
    B, L = layout.shape
    q = rng.randn(B, L, Hq, D).astype(np.float32) * 0.3
    k = rng.randn(B, L, Hkv, D).astype(np.float32) * 0.3
    v = rng.randn(B, L, Hkv, D).astype(np.float32) * 0.3
    return q, k, v, grid["segment_ids"], grid["positions"]


def _np_lse(q, k, seg, scale):
    """Masked logsumexp [B, Hq, T] of the kernel's function, in float64."""
    B, T, Hq, D = q.shape
    G = Hq // k.shape[2]
    kk = np.repeat(k, G, axis=2).astype(np.float64)
    s = np.einsum("bthd,bshd->bhts", q.astype(np.float64) * scale, kk)
    keep = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)
    keep &= np.tril(np.ones((T, T), bool))[None]
    s = np.where(keep[:, None], s, -np.inf)
    m = s.max(-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        out = np.log(np.exp(s - np.where(np.isfinite(m), m, 0)).sum(-1))
    return out + np.where(np.isfinite(m[..., 0]), m[..., 0], 0)


@pytest.mark.parametrize("seqlens,row_len", SEQLENS)
@pytest.mark.parametrize("D,Hq,Hkv", [(64, 4, 2), (128, 4, 1), (64, 2, 2)])
def test_plain_flash_matches_reference(seqlens, row_len, D, Hq, Hkv):
    q, k, v, seg, pos = _case(seqlens, row_len, Hq=Hq, Hkv=Hkv, D=D)
    ref = jattn.packed_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        jnp.asarray(seg), q_positions=jnp.asarray(pos),
        kv_positions=jnp.asarray(pos), causal=True, impl="reference",
    )
    ts = torch.from_numpy(seg)
    out, lse = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), ts, ts,
        return_lse=True,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    pad = seg == 0
    assert (out.numpy()[pad] == 0).all()
    want = _np_lse(q, k, seg, D ** -0.5)
    fin = np.isfinite(want)
    np.testing.assert_allclose(lse.numpy()[fin], want[fin], atol=1e-5)
    # rows with no valid key: pad rows, logsumexp exactly -inf
    assert np.isneginf(lse.numpy()[~fin]).all()
    assert (~fin).any() == pad.any()


@pytest.mark.parametrize("seqlens,row_len", SEQLENS[1:3] + SEQLENS[4:])
def test_packed_attention_dispatch_matches_reference(seqlens, row_len):
    q, k, v, seg, pos = _case(seqlens, row_len, seed=1)
    args = [q, k, v, seg, seg]
    ref = jattn.packed_attention(
        *map(jnp.asarray, args), q_positions=jnp.asarray(pos),
        kv_positions=jnp.asarray(pos), impl="reference",
    )
    for impl in ("auto", "reference", "flash"):
        out = tattn.packed_attention(
            *map(torch.from_numpy, args), q_positions=torch.from_numpy(pos),
            kv_positions=torch.from_numpy(pos), impl=impl,
        )
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                                   err_msg=impl)


def test_sliding_window_takes_reference():
    q, k, v, seg, pos = _case([60, 68], None, seed=2)
    ref = jattn.packed_attention(
        *map(jnp.asarray, (q, k, v, seg, seg)), q_positions=jnp.asarray(pos),
        kv_positions=jnp.asarray(pos), sliding_window=16, impl="reference",
    )
    out = tattn.packed_attention(
        *map(torch.from_numpy, (q, k, v, seg, seg)),
        q_positions=torch.from_numpy(pos), kv_positions=torch.from_numpy(pos),
        sliding_window=16,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    with pytest.raises(NotImplementedError):
        tattn.packed_attention(*map(torch.from_numpy, (q, k, v, seg, seg)),
                               sliding_window=16, impl="flash")


def test_plain_flash_matches_pallas_interpreted():
    ctx = jfa.interpret_mode()
    if ctx is None:
        pytest.skip("this jax cannot interpret the Pallas TPU flash kernel")
    q, k, v, seg, _ = _case([60, 68], None, D=64, seed=3)
    with ctx:
        ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v, seg, seg)))
        ref = np.asarray(jax.block_until_ready(ref))
    ts = torch.from_numpy(seg)
    out = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), ts, ts)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-2)
    assert (out.numpy()[seg == 0] == 0).all()


@pytest.mark.parametrize("ndim", [2, 3])
def test_decode_attention_matches_reference(ndim):
    rng = np.random.RandomState(4)
    B, T, S, Hq, Hkv, D = 3, 1 if ndim == 2 else 5, 24, 4, 2, 16
    q = rng.randn(B, T, Hq, D).astype(np.float32)
    kc = rng.randn(B, S, Hkv, D).astype(np.float32)
    vc = rng.randn(B, S, Hkv, D).astype(np.float32)
    cur = np.array([3, 10, 17])
    if ndim == 2:
        valid = np.arange(S)[None, :] <= cur[:, None]
    else:
        pos = cur[:, None] + np.arange(T)[None, :]
        valid = np.arange(S)[None, None, :] <= pos[:, :, None]
    valid[0] = False  # a row with no valid slot comes out as zeros
    ref = jattn.decode_attention(*map(jnp.asarray, (q, kc, vc, valid)))
    out = tattn.decode_attention(*map(torch.from_numpy, (q, kc, vc, valid)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    assert (out.numpy()[0] == 0).all()
