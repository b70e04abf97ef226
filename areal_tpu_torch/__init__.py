"""areal_tpu_torch — the PyTorch/CUDA port of areal_tpu, for NVIDIA Hopper.

Module names mirror the reference package ``areal_tpu`` so each counterpart
is easy to find. The port never imports the reference package: it keeps its
own copies of what it needs.

Importing the package loads no torch: the CPU-only processes (a sandbox
reward worker) import its host modules alone.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Union

if TYPE_CHECKING:
    import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Never picks the CPU on its own — without a GPU and without an
    explicit ``device``, it raises."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
