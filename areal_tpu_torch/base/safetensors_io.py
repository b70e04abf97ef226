"""The safetensors file format, read and written without the ``safetensors``
package (the machine with the card has neither it nor ``transformers``).

A file is an unsigned 64-bit little-endian header length, a JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` with an optional
``"__metadata__"`` of strings, padded with spaces to a multiple of 8 bytes,
then the tensors' raw little-endian bytes (offsets relative to the end of the
header). numpy has no bfloat16, so every tensor goes through torch and its
bytes through ``view(torch.uint8)``. The writer orders tensors by element
size, largest first, so every offset is a multiple of its tensor's element
size, as the reference writer does.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

_NAMES = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
    torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
    torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8",
    torch.bool: "BOOL",
}
_DTYPES = {v: k for k, v in _NAMES.items()}

Tensorish = Union[torch.Tensor, np.ndarray]


def _as_tensor(x: Tensorish) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.detach().to("cpu").contiguous()


def save_file(tensors: Mapping[str, Tensorish], path: str,
              metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (torch tensors on any device, or numpy arrays) to
    ``path``; returns the bytes written."""
    items = sorted(((name, _as_tensor(t)) for name, t in tensors.items()),
                   key=lambda kv: (-kv[1].element_size(), kv[0]))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in items:
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors name")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for _, t in items:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy())
    return 8 + len(head) + offset


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, as CPU tensors in their stored
    dtype and shape."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = np.fromfile(f, dtype=np.uint8)
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        raw = data[begin:end]
        itemsize = torch.empty((), dtype=dtype).element_size()
        if begin % itemsize:  # a foreign writer's unaligned tensor
            raw = raw.copy()
        out[name] = torch.from_numpy(raw).view(dtype).reshape(info["shape"])
    return out
