"""Experiment definitions (reference ``realhf/experiments/``).

The port's copy of ``areal_tpu/experiments/__init__.py``: each experiment
is a dataclass config whose ``initial_setup()`` turns the declarative
pieces into the DFG and the worker configs the launcher spawns.
"""

from typing import Dict, Type

_REGISTRY: Dict[str, type] = {}


def register_experiment(name: str, cls: type) -> None:
    _REGISTRY[name] = cls


def _register_all() -> None:
    # imported for their registrations
    import areal_tpu_torch.experiments.async_ppo_math_exp  # noqa: F401
    import areal_tpu_torch.experiments.ppo_math_exp  # noqa: F401
    import areal_tpu_torch.experiments.sft_exp  # noqa: F401


def make_experiment_cls(name: str) -> Type:
    _register_all()
    if name not in _REGISTRY:
        raise ValueError(f"unknown experiment '{name}'; have "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def registered_name_of(cfg) -> str:
    """The registered name of a config instance: the most derived
    registered class wins (``AsyncPPOMATHConfig`` subclasses
    ``PPOMATHConfig``)."""
    _register_all()
    best = None
    for name, cls in _REGISTRY.items():
        if isinstance(cfg, cls) and (best is None
                                     or issubclass(cls, _REGISTRY[best])):
            best = name
    if best is None:
        raise ValueError(f"{type(cfg).__name__} is not a registered "
                         "experiment config")
    return best
