"""Deterministic seeding across python, numpy and torch.

The port's copy of ``areal_tpu/base/seeding.py`` (reference
``realhf/base/seeding.py``: a global seed and per-component named seeds).
The integer seeds equal the reference's for the same ``(seed, name)``;
where the reference hands out a PRNG key (its ``jax_key``),
:func:`torch_generator` hands out a ``torch.Generator`` seeded with the
same integer.
"""

from __future__ import annotations

import hashlib
import random

import numpy as np

_SEED: int | None = None


def set_random_seed(seed: int, key: str = "") -> None:
    global _SEED
    _SEED = int(seed)
    random.seed(_mix(seed, key))
    np.random.seed(_mix(seed, key) % (2**32))


def get_seed() -> int:
    if _SEED is None:
        raise RuntimeError("set_random_seed was never called")
    return _SEED


def _mix(seed: int, name: str) -> int:
    h = hashlib.blake2b(f"{seed}/{name}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little")


def component_seed(name: str) -> int:
    """A deterministic per-component integer seed."""
    return _mix(get_seed(), name) % (2**31)


def torch_generator(name: str, device=None):
    """A fresh ``torch.Generator`` for a named component on ``device``
    (cuda unless named), seeded with :func:`component_seed` (lazy torch
    import, so that host-only processes never load it)."""
    import torch

    from areal_tpu_torch import resolve_device

    return torch.Generator(device=resolve_device(device)).manual_seed(
        component_seed(name))
