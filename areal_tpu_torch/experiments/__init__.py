"""Experiment definitions (reference ``realhf/experiments/``).

The port's copy of ``areal_tpu/experiments/__init__.py``: each experiment
is a dataclass config whose ``initial_setup()`` turns the declarative
pieces into the DFG and the worker configs the launcher spawns.
"""

from typing import Dict, Type

_REGISTRY: Dict[str, type] = {}


def register_experiment(name: str, cls: type) -> None:
    _REGISTRY[name] = cls


def make_experiment_cls(name: str) -> Type:
    # imported for their registrations
    import areal_tpu_torch.experiments.async_ppo_math_exp  # noqa: F401
    import areal_tpu_torch.experiments.ppo_math_exp  # noqa: F401
    import areal_tpu_torch.experiments.sft_exp  # noqa: F401

    if name not in _REGISTRY:
        raise ValueError(f"unknown experiment '{name}'; have "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]
