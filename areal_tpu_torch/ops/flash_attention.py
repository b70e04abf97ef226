"""Packed segment-causal flash attention — the Hopper kernels and their plain
PyTorch versions.

Counterpart of ``areal_tpu/ops/pallas/flash_attention.py:200
flash_attention`` and its gradient. Three kernels, CUDA C++ for ``sm_90a``:

 - K1, the forward (``csrc/flash_attention.cu``): out and the per-row
   logsumexp;
 - K2, dk and dv, and K3, dq (``csrc/flash_attention_bwd.cu``), from q, k,
   v, dO, K1's logsumexp and ``di = rowsum(dO * O)``.

For bf16 and fp16, K1, K2 and K3 run on tensor cores (``mma.sync``) with
``cp.async`` double buffering and skip the tile pairs that share no segment
id (:func:`tile_pairs` counts them); K2 splits its work per q head and sums
the heads of each kv head in a second kernel, deterministically; K3 writes
each q tile's dq once. float32 inputs take exact scalar-f32 instances.

Each source is built with ``nvcc`` into a shared library at first use (keyed
by a hash of the sources, under the repository's ``build/`` directory; the
sources build in parallel) and called through ``ctypes``.
:class:`FlashAttention` pairs K1 with K2 and K3 as a
``torch.autograd.Function``.

Semantics, shared by the kernels and the plain versions:

 - q ``[B, T, Hq, D]``, k/v ``[B, S, Hkv, D]``, ``Hq = G * Hkv``; q head
   ``h`` reads kv head ``h // G``, and dk/dv sum over the G q heads of each
   kv head;
 - a (row, column) pair is kept when both segment ids are equal and nonzero
   and, when ``causal``, the column index is ``<=`` the row index (causal by
   index, as the TPU kernel; packing keeps each document contiguous, so this
   equals per-document causal order);
 - rows with no kept column (pad queries, segment 0) are exact zeros, their
   logsumexp is ``-inf`` and their dq is 0; pad columns get dk = dv = 0;
 - outputs and gradients have the input dtype; the logsumexp ``[B, Hq, T]``
   is float32 (the plain versions compute in float32, or in float64 for
   float64 inputs, and return the logsumexp in that type).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from contextlib import ExitStack
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = {"fwd": "flash_attention.cu", "bwd": "flash_attention_bwd.cu"}
_HEADERS = ("flash_common.cuh",)
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (64, 128)
KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq")

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()
_launches = dict.fromkeys(KERNELS, 0)


def launch_count(kernel: str = "flash_attention_fwd") -> int:
    """Launches of ``kernel`` (one of :data:`KERNELS`) since the last
    :func:`reset_launch_count`."""
    return _launches[kernel]


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_count() -> None:
    for name in _launches:
        _launches[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the flash-attention kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str) -> Path:
    src = b"".join((_CSRC / f).read_bytes()
                   for f in (_SOURCES[name], *_HEADERS))
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_ROOT / key / f"libareal_{Path(_SOURCES[name]).stem}.so"


def build_libraries() -> Dict[str, Path]:
    """Compile every source into its shared library (once per source hash),
    one ``nvcc`` per source, all started together; return ``{name: path}``.
    ptxas's register/spill report goes to ``build.log`` beside each library.
    Safe against concurrent builders: file locks serialise them and each
    library is renamed into place."""
    paths = {name: _lib_path(name) for name in _SOURCES}
    todo = [n for n, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    with ExitStack() as stack:
        procs = {}
        for name in sorted(todo):  # one lock order for every builder
            out_dir = paths[name].parent
            out_dir.mkdir(parents=True, exist_ok=True)
            lock = stack.enter_context(open(out_dir / "build.lock", "w"))
            fcntl.flock(lock, fcntl.LOCK_EX)
            if paths[name].exists():
                continue
            tmp = out_dir / f"tmp{os.getpid()}.so"
            cmd = [_nvcc(), *_NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_CSRC),
                   "-o", str(tmp), str(_CSRC / _SOURCES[name])]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{_SOURCES[name]}: nvcc failed "
                              f"({proc.returncode}):\n{out}\n{err}")
                continue
            (paths[name].parent / "build.log").write_text(err)
            os.replace(tmp, paths[name])
        if failed:
            raise RuntimeError("\n".join(failed))
    return paths


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # name in the library: (library, argtypes)
    "areal_flash_attention_fwd": (
        "fwd", [_PTR] * 7 + [_INT] * 8 + [ctypes.c_float, _PTR]),
    "areal_flash_attention_bwd_dq": (
        "bwd", [_PTR] * 9 + [_INT] * 8 + [ctypes.c_float, _PTR]),
    "areal_flash_attention_bwd_dkv": (
        "bwd", [_PTR] * 12 + [_INT] * 8 + [ctypes.c_float, _PTR]),
}


def _library(name: str) -> ctypes.CDLL:
    with _lib_lock:
        if not _libs:
            for lib_name, path in build_libraries().items():
                lib = ctypes.CDLL(str(path))
                lib.areal_cuda_error_string.argtypes = [ctypes.c_int]
                lib.areal_cuda_error_string.restype = ctypes.c_char_p
                _libs[lib_name] = lib
            for fn_name, (lib_name, argtypes) in _SIGNATURES.items():
                fn = getattr(_libs[lib_name], fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        return _libs[name]


def _call(fn_name: str, kernel: str, *args) -> None:
    lib = _library(_SIGNATURES[fn_name][0])
    err = getattr(lib, fn_name)(*args)
    if err != 0:
        msg = lib.areal_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel failed: {msg} ({err})")
    _launches[kernel] += 1


def _check_inputs(q, k, v, q_segment_ids, kv_segment_ids) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, T, H, D]")
    B, T, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    Hkv = k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if tuple(q_segment_ids.shape) != (B, T) or \
            tuple(kv_segment_ids.shape) != (B, k.shape[1]):
        raise ValueError("segment ids must be [B, T] and [B, S]")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share a dtype")


def _check_launch(q, tensors, segment_ids) -> None:
    """What the kernels take beyond :func:`_check_inputs`."""
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} not supported")
    everything = (*tensors, *segment_ids)
    if any(t.device != q.device for t in everything):
        raise ValueError("all inputs must be on one device")
    if any(s.dtype != torch.int32 for s in segment_ids):
        raise ValueError("segment ids must be int32")
    if not all(t.is_contiguous() for t in everything):
        raise ValueError("inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("inputs must start on a 16-byte boundary")


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _keep_mask(q_segment_ids, kv_segment_ids, causal: bool) -> torch.Tensor:
    """[B, T, S] bool: the pairs the kernels keep."""
    qs, ks = q_segment_ids[:, :, None], kv_segment_ids[:, None, :]
    keep = (qs == ks) & (qs != 0)
    if causal:
        T, S = q_segment_ids.shape[1], kv_segment_ids.shape[1]
        cols = torch.arange(S, device=keep.device)
        rows = torch.arange(T, device=keep.device)
        keep = keep & (cols[None, :] <= rows[:, None])
    return keep


def _tile_ranges(seg: torch.Tensor, block: int):
    """[B, n] min and max of the nonzero ids of each ``block``-long tile of
    ``seg`` [B, L] (min > max for a tile without one)."""
    B, L = seg.shape
    n = -(-L // block)
    s = torch.nn.functional.pad(seg.long(), (0, n * block - L)).view(B, n, block)
    big = torch.iinfo(torch.int64).max
    lo = torch.where(s != 0, s, big).amin(-1)
    hi = torch.where(s != 0, s, -big).amax(-1)
    return lo, hi


def tile_walk(q_segment_ids: torch.Tensor, kv_segment_ids: torch.Tensor,
              causal: bool = True, block_q: int = 64, block_kv: int = 64
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tile walk of the tensor-core kernels: ``(executed [B, nq, nk],
    visited [nq, nk])`` bool over (q tile, kv tile) pairs. A pair is visited
    unless the kv tile lies wholly in the q tile's causal future; it is
    executed only if besides the two tiles' ranges ``[min, max]`` of nonzero
    segment ids overlap. Disjoint ranges share no id, so the skip drops no
    kept pair whatever the ids. K1 walks (64, 64) tiles; K2 (64, 64) at
    head_dim 64 and (32, 64) at 128; K3 (64, 64) at head_dim 64 and
    (64, 32) at 128."""
    q_lo, q_hi = _tile_ranges(q_segment_ids, block_q)
    k_lo, k_hi = _tile_ranges(kv_segment_ids, block_kv)
    T = q_segment_ids.shape[1]
    nq, nk = q_lo.shape[1], k_lo.shape[1]
    dev = q_lo.device
    q_last = torch.clamp(torch.arange(nq, device=dev) * block_q + block_q,
                         max=T) - 1
    k_first = torch.arange(nk, device=dev) * block_kv
    visited = (k_first[None, :] <= q_last[:, None]) if causal else \
        torch.ones(nq, nk, dtype=torch.bool, device=dev)
    overlap = ((q_lo <= q_hi)[:, :, None] & (k_lo <= k_hi)[:, None, :]
               & (q_lo[:, :, None] <= k_hi[:, None, :])
               & (k_lo[:, None, :] <= q_hi[:, :, None]))
    return overlap & visited[None], visited


def tile_pairs(q_segment_ids: torch.Tensor, kv_segment_ids: torch.Tensor,
               causal: bool = True, block_q: int = 64, block_kv: int = 64
               ) -> Tuple[int, int]:
    """:func:`tile_walk` counted per head over the batch rows:
    ``(executed, visited)`` tile pairs."""
    executed, visited = tile_walk(q_segment_ids, kv_segment_ids, causal,
                                  block_q, block_kv)
    return int(executed.sum()), int(visited.sum()) * executed.shape[0]


# ---------------- K1: forward ----------------

def flash_attention(
    q: torch.Tensor,  # [B, T, Hq, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,  # [B, S, Hkv, D]
    q_segment_ids: torch.Tensor,  # [B, T] int, 0 = pad
    kv_segment_ids: torch.Tensor,  # [B, S]
    causal: bool = True,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """K1 forward. Returns ``out`` (or ``(out, lse)`` with ``return_lse``).
    No gradient: :class:`FlashAttention` is the differentiable form."""
    _check_inputs(q, k, v, q_segment_ids, kv_segment_ids)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        out, lse = flash_attention_plain(q, k, v, q_segment_ids,
                                         kv_segment_ids, causal, scale)
    elif q.device.type == "cuda":
        out, lse = _launch_fwd(q, k, v, q_segment_ids, kv_segment_ids,
                               causal, scale)
    else:
        raise RuntimeError(f"flash_attention: no kernel for {q.device}")
    return (out, lse) if return_lse else out


def _launch_fwd(q, k, v, q_segment_ids, kv_segment_ids, causal: bool,
                scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    _check_launch(q, (q, k, v), (q_segment_ids, kv_segment_ids))
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        _call("areal_flash_attention_fwd", "flash_attention_fwd",
              q.data_ptr(), k.data_ptr(), v.data_ptr(),
              q_segment_ids.data_ptr(), kv_segment_ids.data_ptr(),
              out.data_ptr(), lse.data_ptr(),
              B, T, S, Hq, Hkv, D, _DTYPE_CODES[q.dtype], int(causal),
              float(scale), stream)
    return out, lse


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's function in plain PyTorch, computed in float32 (float64 for
    float64 inputs): ``(out in q.dtype, lse [B, Hq, T])``."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = D ** -0.5
    ct = _compute_dtype(q.dtype)
    qg = q.to(ct).reshape(B, T, Hkv, Hq // Hkv, D) * scale
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.to(ct))
    keep = _keep_mask(q_segment_ids, kv_segment_ids, causal)
    scores = scores.masked_fill(~keep[:, None, None], float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)  # -inf on rows with no kept key
    probs = torch.exp(scores - torch.where(lse.isfinite(), lse, 0.0)[..., None])
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.to(ct))
    return out.reshape(B, T, Hq, D).to(q.dtype), lse.reshape(B, Hq, T)


# ---------------- K2 / K3: backward ----------------

def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    out: torch.Tensor,  # [B, T, Hq, D], K1's output
    lse: torch.Tensor,  # [B, Hq, T], K1's logsumexp
    dout: torch.Tensor,  # [B, T, Hq, D]
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of K1: ``(dq, dk, dv)`` in the input dtype. On a CUDA
    tensor, ``di = rowsum(dO * O)`` in float32, then K3 (dq) and K2
    (dk, dv)."""
    _check_inputs(q, k, v, q_segment_ids, kv_segment_ids)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError("out and dout must be shaped like q")
    if tuple(lse.shape) != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError("lse must be [B, Hq, T]")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, q_segment_ids,
                                         kv_segment_ids, out, lse, dout,
                                         causal, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_bwd: no kernel for {q.device}")
    if not (out.dtype == dout.dtype == q.dtype) or lse.dtype != torch.float32:
        raise ValueError("out and dout must have q's dtype, lse float32")
    _check_launch(q, (q, k, v, out, lse, dout),
                  (q_segment_ids, kv_segment_ids))
    di = backward_di(out, dout)
    args = (q, k, v, q_segment_ids, kv_segment_ids, dout, lse, di, causal,
            scale)
    return (launch_bwd_dq(*args), *launch_bwd_dkv(*args))


def backward_di(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``di = rowsum(dO * O)`` in float32, ``[B, Hq, T]`` (the library
    computes it outside its kernels too)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_args(q, k, v, q_segment_ids, kv_segment_ids, dout, lse, di, causal):
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_segment_ids.data_ptr(),
            kv_segment_ids.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            di.data_ptr()), (B, T, S, Hq, Hkv, D, _DTYPE_CODES[q.dtype],
                             int(causal))


def launch_bwd_dq(q, k, v, q_segment_ids, kv_segment_ids, dout, lse, di,
                  causal: bool, scale: float) -> torch.Tensor:
    """K3 alone on CUDA tensors that :func:`flash_attention_bwd` checked."""
    ptrs, dims = _bwd_args(q, k, v, q_segment_ids, kv_segment_ids, dout, lse,
                           di, causal)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _call("areal_flash_attention_bwd_dq", "flash_attention_bwd_dq",
              *ptrs, dq.data_ptr(), *dims, float(scale),
              torch.cuda.current_stream(q.device).cuda_stream)
    return dq


def launch_bwd_dkv(q, k, v, q_segment_ids, kv_segment_ids, dout, lse, di,
                   causal: bool, scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 alone on CUDA tensors that :func:`flash_attention_bwd` checked.
    For bf16/fp16 with more q heads than kv heads, the per-q-head f32
    partials of dk and dv go through scratch ``[2, B, S, Hq, D]`` allocated
    here; one C call launches the partial and the reduction kernels."""
    ptrs, dims = _bwd_args(q, k, v, q_segment_ids, kv_segment_ids, dout, lse,
                           di, causal)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    B, S, Hkv, D = k.shape
    Hq = q.shape[2]
    parts = (0, 0)
    if q.dtype != torch.float32 and Hq > Hkv:
        scratch = torch.empty((2, B, S, Hq, D), dtype=torch.float32,
                              device=q.device)
        parts = (scratch[0].data_ptr(), scratch[1].data_ptr())
    with torch.cuda.device(q.device):
        _call("areal_flash_attention_bwd_dkv", "flash_attention_bwd_dkv",
              *ptrs, dk.data_ptr(), dv.data_ptr(), *parts, *dims,
              float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    return dk, dv


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 and K3's function in plain PyTorch, written out step by step in
    float32 (float64 for float64 inputs): probabilities recomputed from
    ``lse``, then dv, dp, ds, dq, dk. Returns ``(dq, dk, dv)`` in q's
    dtype."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    ct = _compute_dtype(q.dtype)
    qg = q.to(ct).reshape(B, T, Hkv, G, D)
    kf, vf = k.to(ct), v.to(ct)
    do = dout.to(ct).reshape(B, T, Hkv, G, D)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, kf) * scale
    keep = _keep_mask(q_segment_ids, kv_segment_ids, causal)[:, None, None]
    row_lse = lse.to(ct).reshape(B, Hkv, G, T)
    # A kept pair implies a finite row logsumexp; never form -inf - -inf.
    safe = torch.where(row_lse.isfinite(), row_lse, 0.0)[..., None]
    p = torch.where(keep, torch.exp(scores - safe), 0.0)  # [B, Hkv, G, T, S]
    di = (do * out.to(ct).reshape(B, T, Hkv, G, D)).sum(-1)  # [B, T, Hkv, G]
    dv = torch.einsum("bkgts,btkgd->bskd", p, do)
    dp = torch.einsum("btkgd,bskd->bkgts", do, vf)
    ds = p * (dp - di.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgts,bskd->btkgd", ds, kf) * scale
    dk = torch.einsum("bkgts,btkgd->bskd", ds, qg) * scale
    return (dq.reshape(B, T, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Differentiable packed flash attention: K1 forward, K2/K3 backward on
    CUDA tensors; the plain versions on CPU tensors. Saves q, k, v, the
    segment ids, out and lse; the kernels write only into tensors allocated
    here, never into a saved one."""

    @staticmethod
    def forward(ctx, q, k, v, q_segment_ids, kv_segment_ids, causal=True,
                scale=None):
        if scale is None:
            scale = q.shape[-1] ** -0.5
        out, lse = flash_attention(q, k, v, q_segment_ids, kv_segment_ids,
                                   causal=causal, scale=scale,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, q_segment_ids, kv_segment_ids, out,
                              lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qs, ks, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, qs, ks, out, lse,
                                         dout.contiguous(), ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None, None, None
