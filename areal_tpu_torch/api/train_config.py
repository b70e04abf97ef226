"""Optimizer configuration.

The port's own copy of ``OptimizerConfig`` from
``areal_tpu/api/train_config.py:20``, with the same defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class OptimizerConfig:
    """Reference cli_args.py:173 (OptimizerConfig)."""

    type: str = "adamw"  # adamw | sgd
    lr: float = 1e-5
    weight_decay: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-5
    min_lr_ratio: float = 0.0
    warmup_steps_proportion: float = 0.02
    lr_scheduler_type: str = "constant"  # constant | cosine | linear
    gradient_clipping: float = 1.0
    # Adam moment storage dtypes (master params are always f32; the moment
    # math runs in f32 whatever the storage). Both default to exact f32:
    # bf16 halves the optimizer's memory at the cost of rounding the
    # carried state.
    mu_dtype: Optional[str] = "float32"
    nu_dtype: Optional[str] = "float32"
