"""Packed segment-causal flash attention (K1) — the Hopper kernel and its
plain PyTorch version.

Counterpart of ``areal_tpu/ops/pallas/flash_attention.py:200
flash_attention``. The kernel (``csrc/flash_attention.cu``) is CUDA C++ for
``sm_90a``, built with ``nvcc`` into a shared library at first use (keyed by
a hash of the source, under the repository's ``build/`` directory) and called
through ``ctypes``.

Semantics, shared by the kernel and :func:`flash_attention_plain`:

 - q ``[B, T, Hq, D]``, k/v ``[B, S, Hkv, D]``, ``Hq = G * Hkv``; q head
   ``h`` reads kv head ``h // G``;
 - a (row, column) pair is kept when both segment ids are equal and nonzero
   and, when ``causal``, the column index is ``<=`` the row index (causal by
   index, as the TPU kernel; packing keeps each document contiguous, so this
   equals per-document causal order);
 - rows with no kept column (pad queries, segment 0) are exact zeros, and
   their logsumexp is ``-inf``;
 - the output has the input dtype; the logsumexp ``[B, Hq, T]`` is float32.

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
from pathlib import Path
from typing import Optional, Tuple

import torch

_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (64, 128)

_lib = None
_lib_lock = threading.Lock()
_launches = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the flash-attention kernel")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_library() -> Path:
    """Compile ``csrc/flash_attention.cu`` into a shared library (once per
    source hash) and return its path; ptxas's register/spill report goes to
    ``build.log`` beside it. Safe against concurrent builders: a file lock
    serialises them and the library is renamed into place."""
    src = _SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = _BUILD_ROOT / key
    lib_path = out_dir / "libareal_flash_attention.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists():
            return lib_path
        tmp = out_dir / f"tmp{os.getpid()}.so"
        cmd = [_nvcc(), *_NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(_SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
            )
        (out_dir / "build.log").write_text(res.stderr)
        os.replace(tmp, lib_path)
    return lib_path


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            fn = lib.areal_flash_attention_fwd
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
                ctypes.c_float, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            lib.areal_cuda_error_string.argtypes = [ctypes.c_int]
            lib.areal_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


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
    """K1 forward. Returns ``out`` (or ``(out, lse)`` with ``return_lse``)."""
    _check_inputs(q, k, v, q_segment_ids, kv_segment_ids)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        out, lse = flash_attention_plain(q, k, v, q_segment_ids,
                                         kv_segment_ids, causal, scale)
    elif q.device.type == "cuda":
        out, lse = _launch(q, k, v, q_segment_ids, kv_segment_ids, causal,
                           scale)
    else:
        raise RuntimeError(f"flash_attention: no kernel for {q.device}")
    return (out, lse) if return_lse else out


def _launch(q, k, v, q_segment_ids, kv_segment_ids, causal: bool,
            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    global _launches
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} not supported")
    tensors = (q, k, v, q_segment_ids, kv_segment_ids)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if q_segment_ids.dtype != torch.int32 or kv_segment_ids.dtype != torch.int32:
        raise ValueError("segment ids must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _library().areal_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_segment_ids.data_ptr(), kv_segment_ids.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            B, T, S, Hq, Hkv, D, _DTYPE_CODES[q.dtype], int(causal),
            float(scale), stream,
        )
    if err != 0:
        msg = _library().areal_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel failed: {msg} ({err})")
    _launches += 1
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
    """The kernel's function in plain PyTorch, computed in float32:
    ``(out in q.dtype, lse f32 [B, Hq, T])``."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = D ** -0.5
    qg = q.float().reshape(B, T, Hkv, Hq // Hkv, D) * scale
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.float())
    qs, ks = q_segment_ids[:, :, None], kv_segment_ids[:, None, :]
    keep = (qs == ks) & (qs != 0)
    if causal:
        cols = torch.arange(S, device=q.device)
        rows = torch.arange(T, device=q.device)
        keep = keep & (cols[None, :] <= rows[:, None])
    scores = scores.masked_fill(~keep[:, None, None], float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)  # -inf on rows with no kept key
    probs = torch.exp(scores - torch.where(lse.isfinite(), lse, 0.0)[..., None])
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.float())
    return out.reshape(B, T, Hq, D).to(q.dtype), lse.reshape(B, Hq, T)
