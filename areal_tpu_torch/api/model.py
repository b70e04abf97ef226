"""Generation hyperparameters.

The port's own copy of ``GenerationHyperparameters`` from
``areal_tpu/api/model.py``; the registries and engine contracts there wait
for the training slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GenerationHyperparameters:
    """Sampling config (reference cli_args.py:531)."""

    n: int = 1
    max_new_tokens: int = 256
    min_new_tokens: int = 0
    greedy: bool = False
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    temperature: float = 1.0
