"""Fabricated data recipes.

The port's own copy of ``bench_trajectory_dist`` from
``areal_tpu/base/testing.py:137``: the PPO trajectory length distribution
that ``bench.py`` trains on and that ``chip_smoke.py`` rebuilds without the
JAX package.
"""

from __future__ import annotations

import numpy as np


def bench_trajectory_dist(seed: int = 0, n_seq: int = 32):
    """The bench PPO trajectory length distribution — ~250-token prompts
    + ~640-token generations — as ``(rng, plens, glens)``. Callers keep
    drawing tokens and logprobs from the returned rng, in ``bench.py``'s
    order, to rebuild its batch bit for bit."""
    rng = np.random.RandomState(seed)
    plens = rng.randint(200, 257, n_seq)
    glens = rng.randint(512, 769, n_seq)
    return rng, plens, glens
