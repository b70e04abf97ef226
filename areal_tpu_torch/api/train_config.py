"""Optimizer, weight-sync and save/eval configuration.

The port's own copies of ``OptimizerConfig``, ``WeightSyncConfig`` and
``ExperimentSaveEvalControl`` from ``areal_tpu/api/train_config.py:20, :43,
:486``, with the same defaults.
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


@dataclasses.dataclass
class WeightSyncConfig:
    """Trainer → generation-server weight transport.

    ``stream`` serves per-tensor chunks from the trainer's host cache over
    TCP (``system/weight_stream.py``); ``disk`` writes a native checkpoint
    under the trainer's ``realloc_dir``. The reference's ``device``
    transport (an on-device reshard) is not ported: asking for it raises,
    and no other transport stands in for it."""

    transport: str = "stream"  # stream | disk
    # Wire chunk size (MB) of the streamed transport.
    chunk_mb: int = 32
    # The servers' window of in-flight chunk requests (the experiments
    # thread it into GenerationServerConfig.weight_stream_pipeline_depth).
    pipeline_depth: int = 4

    def __post_init__(self):
        if self.transport == "device":
            raise NotImplementedError(
                "weight_sync.transport='device' (the on-device reshard) is "
                "not ported yet: ROADMAP.md Queue 1 item 8, multi-GPU "
                "parallelism. Use 'stream' or 'disk'.")
        if self.transport not in ("stream", "disk"):
            raise ValueError(
                f"unknown weight_sync.transport {self.transport!r}")


@dataclasses.dataclass
class ExperimentSaveEvalControl:
    """Reference cli_args.py:702."""

    total_train_epochs: int = 1
    benchmark_steps: Optional[int] = None  # stop after N train steps
    save_freq_steps: Optional[int] = None
    ckpt_freq_steps: Optional[int] = None
    ckpt_freq_secs: Optional[int] = None
    eval_freq_steps: Optional[int] = None
