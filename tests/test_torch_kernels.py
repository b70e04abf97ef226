"""The flash-attention wrappers (areal_tpu_torch/ops/flash_attention.py)
without the JAX package: input checks and the plain versions' edge cases on
the CPU, and the CUDA kernels (K1 forward, K2 dk/dv, K3 dq) against their
plain versions on the card (``cuda`` marker).

This file imports neither jax nor areal_tpu, so on a machine with a card and
without jax it runs alone:
``python -m pytest --noconftest tests/test_torch_kernels.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from areal_tpu_torch.ops import flash_attention as fa


def _inputs(seqlens, T, Hq, Hkv, D, dtype=torch.float32, device="cpu", seed=0):
    """One row per entry of ``seqlens``: documents packed from column 0,
    the rest of the row padding (segment 0). A document is a length (ids
    1, 2, ... in order) or a ``(length, id)`` pair (ids in any order)."""
    rng = np.random.RandomState(seed)
    B = len(seqlens)
    seg = np.zeros((B, T), np.int32)
    for b, lens in enumerate(seqlens):
        col = 0
        for i, doc in enumerate(lens):
            n, sid = doc if isinstance(doc, tuple) else (doc, i + 1)
            seg[b, col:col + n] = sid
            col += n
    q, k, v = (torch.from_numpy(rng.randn(B, T, h, D).astype(np.float32))
               for h in (Hq, Hkv, Hkv))
    return ([x.to(device, dtype) for x in (q, k, v)],
            torch.from_numpy(seg).to(device))


def _kv_ids(seg):
    """The key side's segment ids: documents with ids from 100 up exist on
    the query side only (their key columns are padding), so their rows meet
    no key."""
    return torch.where(seg >= 100, 0, seg)


# Cases for the tensor-core kernels: the train shape (two documents per row
# and a pad tail, G = 7), G = 1 (K2 writes dk/dv directly), segment ids out
# of order, with one id on two separate documents, which the tile skip must
# still keep ("any ids"); 40 short documents per row with ids descending or
# swapped in pairs, where the walk skips most tile pairs; and a query-only
# document whose q tiles meet no kv tile, so their dq must be exactly 0.
# Head_dim 256 (Gemma's heads) runs each of these with G = 1 and with
# Gemma's 8 q heads over one kv head.
_NON_MONOTONIC = [[(100, 2), (90, 1), (120, 3), (80, 1)], [(150, 3), (150, 2)]]
_SHORT_DOCS = [[(9 + (7 * i) % 32, 80 - i) for i in range(40)],
               [(12 + (5 * i) % 27, (i ^ 1) + 1) for i in range(40)]]
_QUERY_ONLY = [[(300, 1), (200, 2), (250, 101)], [(700, 1)]]
_TC_CASES = (
    ([[900, 800], [1000, 700]], 1792, 64, 14, 2),
    ([[200, 150], [300]], 320, 64, 4, 4),
    ([[120, 90], [250]], 256, 128, 2, 2),
    (_NON_MONOTONIC, 400, 64, 14, 2),
    (_NON_MONOTONIC, 400, 128, 8, 1),
    (_SHORT_DOCS, 1024, 64, 14, 2),
    (_QUERY_ONLY, 768, 64, 14, 2),
    (_QUERY_ONLY, 768, 128, 28, 4),
    ([[200, 150], [300]], 320, 256, 2, 2),
    ([[900, 800], [1000, 700]], 1792, 256, 8, 1),
    (_NON_MONOTONIC, 400, 256, 8, 1),
    (_SHORT_DOCS, 1024, 256, 8, 1),
    (_QUERY_ONLY, 768, 256, 8, 1),
    (_QUERY_ONLY, 768, 256, 2, 2),
)


def test_wrapper_rejects_bad_inputs():
    (q, k, v), seg = _inputs([[8]], 8, 4, 2, 64)
    k3 = k[:, :, :1].repeat(1, 1, 3, 1)
    with pytest.raises(ValueError):  # 4 q heads over 3 kv heads
        fa.flash_attention(q, k3, k3, seg, seg)
    with pytest.raises(ValueError):  # segment ids of the wrong length
        fa.flash_attention(q, k, v, seg[:, :4], seg)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.double(), v, seg, seg)
    meta = [x.to("meta") for x in (q, k, v, seg)]
    with pytest.raises(RuntimeError):  # no kernel and no plain version there
        fa.flash_attention(*meta, meta[3])


def test_plain_version_empty_rows_and_causality():
    (q, k, v), seg = _inputs([[5, 3], []], 12, 4, 2, 64)
    out, lse = fa.flash_attention(q, k, v, seg, seg, return_lse=True)
    assert (out[1] == 0).all() and torch.isneginf(lse[1]).all()
    assert (out[0, 8:] == 0).all() and torch.isneginf(lse[0, :, 8:]).all()
    assert torch.isfinite(lse[0, :, :8]).all()
    # a row's first token attends only itself: the output is its own v row
    torch.testing.assert_close(out[0, 0], v[0, 0].repeat_interleave(2, 0))
    torch.testing.assert_close(out[0, 5], v[0, 5].repeat_interleave(2, 0))
    # non-causal: every token of a segment sees the whole segment
    full = fa.flash_attention(q, k, v, seg, seg, causal=False)
    assert not torch.allclose(full[0, 0], out[0, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seqlens,T,D,Hq,Hkv", [
    ([[300, 200], [512], [100, 100, 250]], 512, 64, 14, 2),
    ([[90, 70, 30], [150], []], 200, 128, 28, 4),
    *_TC_CASES,
])
def test_kernel_matches_plain_on_card(dtype, seqlens, T, D, Hq, Hkv):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    (q, k, v), seg = _inputs(seqlens, T, Hq, Hkv, D, dtype, "cuda", seed=5)
    kv_seg = _kv_ids(seg)
    before = fa.launch_count()
    out, lse = fa.flash_attention(q, k, v, seg, kv_seg, return_lse=True)
    torch.cuda.synchronize()
    assert fa.launch_count() == before + 1
    ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                            seg, kv_seg)
    # float32: summation order only; bf16: one ulp at the largest output
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8 * ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol
    no_key = ~fa._keep_mask(seg, kv_seg, True).any(-1)  # pad rows and more
    assert (out[no_key] == 0).all() and not out.isnan().any()
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    assert (lse[fin] - ref_lse[fin]).abs().max().item() <= 1e-4


def _bwd_case(seqlens, T, Hq, Hkv, D, dtype, device, seed):
    """Inputs of the backward: q, k, v, the query and key segment ids, K1's
    out and lse (from the plain version on the CPU, from K1 on the card) and
    a random dO."""
    (q, k, v), seg = _inputs(seqlens, T, Hq, Hkv, D, dtype, device, seed)
    kv_seg = _kv_ids(seg)
    out, lse = fa.flash_attention(q, k, v, seg, kv_seg, return_lse=True)
    gen = torch.Generator().manual_seed(seed + 1)
    dout = torch.randn(q.shape, generator=gen).to(device, dtype)
    return q, k, v, seg, kv_seg, out, lse, dout


def test_backward_wrapper_takes_plain_version_on_cpu():
    q, k, v, seg, _, out, lse, dout = _bwd_case([[9, 5], [3]], 16, 4, 2, 64,
                                                torch.float32, "cpu", 0)
    got = fa.flash_attention_bwd(q, k, v, seg, seg, out, lse, dout)
    want = fa.flash_attention_bwd_plain(q, k, v, seg, seg, out, lse, dout)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    dq, dk, dv = got
    pad = seg == 0
    assert (dq[pad] == 0).all() and (dk[pad] == 0).all() and (dv[pad] == 0).all()
    with pytest.raises(ValueError):  # lse of the wrong shape
        fa.flash_attention_bwd(q, k, v, seg, seg, out, lse[:, :, :4], dout)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seqlens,T,D,Hq,Hkv", [
    ([[300, 200], [512], [100, 100, 250]], 512, 64, 14, 2),
    ([[90, 70, 30], [150], []], 200, 128, 28, 4),
    *_TC_CASES,
])
def test_backward_kernels_match_plain_on_card(dtype, seqlens, T, D, Hq, Hkv):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q, k, v, seg, kv_seg, out, lse, dout = _bwd_case(seqlens, T, Hq, Hkv, D,
                                                     dtype, "cuda", 7)
    before = fa.launch_counts()
    got = fa.flash_attention_bwd(q, k, v, seg, kv_seg, out, lse, dout)
    torch.cuda.synchronize()
    after = fa.launch_counts()
    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        assert after[name] == before[name] + 1
    want = fa.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), seg, kv_seg, out.float(), lse,
        dout.float())
    # Rows that keep no key (pad rows, query-only documents) get dq = 0,
    # columns that no row keeps (pad columns) dk = dv = 0, exactly.
    keep = fa._keep_mask(seg, kv_seg, True)
    empty = (~keep.any(2), ~keep.any(1), ~keep.any(1))
    for name, a, b, zero in zip(("dq", "dk", "dv"), got, want, empty):
        # float32: summation order only; bf16: two ulps at the largest value
        scale = b.abs().max().item()
        tol = 1e-4 * scale if dtype == torch.float32 \
            else 2.0 ** -7 * scale
        err = (a.float() - b).abs().max().item()
        assert err <= tol, (name, err, tol)
        assert (a[zero] == 0).all() and not a.isnan().any(), name


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["dkv", "dq"])
@pytest.mark.parametrize("D,Hq,Hkv", [(64, 14, 2), (128, 8, 1), (256, 8, 1),
                                     (256, 2, 2)])
def test_dkv_kernel_is_deterministic_on_card(D, Hq, Hkv, kernel):
    """K2 (dk, dv) and K3 (dq) give the same bits on every launch: neither
    uses atomics, and K2 sums the q heads of a kv head in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q, k, v, seg, kv_seg, out, lse, dout = _bwd_case(
        [[900, 800], [1000, 700]], 1792, Hq, Hkv, D, torch.bfloat16, "cuda", 3)
    di = fa.backward_di(out, dout)
    args = (q, k, v, seg, kv_seg, dout, lse, di, True, D ** -0.5)
    launch = {"dkv": fa.launch_bwd_dkv,
              "dq": lambda *a: (fa.launch_bwd_dq(*a),)}[kernel]
    first, second = launch(*args), launch(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("blocks", [(64, 64), (32, 64), (64, 32), (16, 8),
                                    (16, 64), (64, 16)])
@pytest.mark.parametrize("ids", ["packed", "shuffled", "few", "short"])
def test_tile_walk_keeps_every_kept_pair(ids, blocks, causal):
    """The tensor-core kernels skip (q tile, kv tile) pairs whose ranges of
    nonzero segment ids do not overlap: whatever the ids, no kept pair may
    sit in a skipped tile pair."""
    if ids == "short":  # 40 short documents a row, ids out of order
        (_, _, _), seg = _inputs(_SHORT_DOCS, 1024, 1, 1, 64)
    else:
        rng = np.random.RandomState(len(ids) + blocks[0])
        B, T = 3, 300
        seg = np.zeros((B, T), np.int32)
        for b in range(B):
            cuts = np.sort(rng.choice(np.arange(1, T), 5, replace=False))
            for i, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, T])):
                seg[b, lo:hi] = {"packed": i + 1, "shuffled": rng.randint(0, 7),
                                 "few": rng.randint(1, 3)}[ids]
            seg[b, T - rng.randint(0, 40):] = 0
        seg = torch.from_numpy(seg)
    B, T = seg.shape
    bq, bk = blocks
    executed, visited = fa.tile_walk(seg, seg, causal, bq, bk)
    keep = fa._keep_mask(seg, seg, causal)
    nq, nk = executed.shape[1:]
    keep = torch.nn.functional.pad(keep, (0, nk * bk - T, 0, nq * bq - T))
    needed = keep.view(B, nq, bq, nk, bk).any(4).any(2)
    assert not (needed & ~executed).any()
    assert not (executed & ~visited).any()
    n_exec, n_visit = fa.tile_pairs(seg, seg, causal, bq, bk)
    assert n_exec == int(executed.sum()) and n_visit == B * int(visited.sum())
    if ids == "packed":  # ascending ids: most off-diagonal pairs are skipped
        assert n_exec < n_visit
    if ids == "short":  # ranges local to their tiles: most pairs are skipped
        assert n_exec < 0.3 * n_visit


def test_tile_walk_counts_at_the_train_shape():
    (_, _, _), seg = _inputs([[900, 800], [1000, 700]], 1792, 1, 1, 64)
    executed, visited = fa.tile_pairs(seg, seg)
    assert visited == 2 * 28 * 29 // 2
    # two documents per row: about half the causal tile pairs share an id
    assert visited * 0.4 < executed < visited * 0.7


@pytest.mark.cuda
def test_autograd_function_launches_all_three_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    (q, k, v), seg = _inputs([[40, 24], [64]], 64, 4, 2, 64, device="cuda")
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    fa.reset_launch_count()
    out = fa.FlashAttention.apply(q, k, v, seg, seg)
    (out * out).sum().backward()
    torch.cuda.synchronize()
    assert fa.launch_counts() == dict.fromkeys(fa.KERNELS, 1)
    assert all(x.grad is not None and x.grad.isfinite().all() for x in (q, k, v))


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    (q, k, v), seg = _inputs([[16]], 16, 2, 1, 96, device="cuda")
    with pytest.raises(ValueError):  # head_dim 96 is not a template case
        fa.flash_attention(q, k, v, seg, seg)
    (q, k, v), seg = _inputs([[16]], 16, 2, 1, 64, device="cuda")
    with pytest.raises(ValueError):  # not contiguous
        fa.flash_attention(torch.cat([q, q], -1)[..., :64], k, v, seg, seg)
