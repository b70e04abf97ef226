"""Model / backend / interface abstractions.

The port's own copy of the engine contracts of ``areal_tpu/api/model.py``:
``GenerationHyperparameters``, ``FinetuneSpec:36``, ``ModelVersion:53``,
``Model:59``, ``TrainableEngine:73``, ``ModelBackend:108`` and
``ModelInterface:122``:
 - ``Model`` bundles an engine (or the ``(config, params)`` pair a backend
   turns into one), a tokenizer and a version;
 - ``ModelBackend`` wraps a model into a ``TrainableEngine``;
 - ``ModelInterface`` is the algorithm operating on an engine and a
   ``SequenceSample``.
Plus the backend, interface, dataset, agent and env registries
(``:162-213``), so experiments build engines, interfaces, datasets, rollout
agents and reward environments by name; the model registry waits for a
later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample


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


@dataclasses.dataclass
class FinetuneSpec:
    total_train_epochs: int = 1
    dataset_size: int = 0
    train_batch_size: int = 1

    @property
    def total_train_steps(self) -> int:
        return self.total_train_epochs * self.steps_per_epoch

    @property
    def steps_per_epoch(self) -> int:
        return max(
            1, (self.dataset_size + self.train_batch_size - 1) // self.train_batch_size
        )


@dataclasses.dataclass
class ModelVersion:
    epoch: int = 0
    epoch_step: int = 0
    global_step: int = 0


class Model:
    """A live model: engine (or config + params) + tokenizer + version."""

    def __init__(self, name: str, module: Any, tokenizer: Any = None):
        self.name = name
        self.module = module  # backend-specific (e.g. a TorchTrainEngine)
        self.tokenizer = tokenizer
        self.version = ModelVersion()

    def inc_version(self):
        self.version.global_step += 1
        self.version.epoch_step += 1


class TrainableEngine:
    """What a backend produces (reference model_api.py:514)."""

    def train_batch(
        self,
        input_: SequenceSample,
        mb_spec: MicroBatchSpec,
        loss_fn: Callable,
        loss_weight_fn: Callable,
        token_normalize_scope: str = "global",
        version_steps: int = 0,
    ) -> Dict[str, float]:
        raise NotImplementedError()

    def forward(
        self,
        input_: SequenceSample,
        mb_spec: MicroBatchSpec,
        output_key: str = "logprobs",
        post_hook: Optional[Callable] = None,
    ):
        raise NotImplementedError()

    def generate(
        self,
        input_: SequenceSample,
        mb_spec: MicroBatchSpec,
        gconfig: GenerationHyperparameters,
    ):
        raise NotImplementedError()


class ModelBackend:
    def initialize(self, model: Model, spec: FinetuneSpec) -> Model:
        raise NotImplementedError()

    def destroy(self, model: Model) -> None:
        pass

    def save(self, model: Model, save_dir: str) -> None:
        raise NotImplementedError()

    def load(self, model: Model, load_dir: str) -> None:
        raise NotImplementedError()


class ModelInterface:
    """Algorithm-level operations. Every method is optional (reference
    model_api.py:759)."""

    def generate(
        self, model: Model, data: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample | None:
        raise NotImplementedError()

    def inference(
        self, model: Model, data: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample | None:
        raise NotImplementedError()

    def train_step(
        self, model: Model, data: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict[str, float]:
        raise NotImplementedError()

    def save(self, model: Model, save_dir: str) -> None:
        pass

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, d: dict) -> None:
        pass


# ---------------- registries ----------------

_BACKEND_REGISTRY: Dict[str, Callable] = {}
_INTERFACE_REGISTRY: Dict[str, Callable] = {}
_DATASET_REGISTRY: Dict[str, Callable] = {}


def _make(registry: Dict[str, Callable], kind: str, name: str, *args, **kwargs):
    if name not in registry:
        raise KeyError(f"unknown {kind} '{name}'; known: {sorted(registry)}")
    return registry[name](*args, **kwargs)


def register_backend(name: str, cls: Callable) -> None:
    _BACKEND_REGISTRY[name] = cls


def make_backend(name: str, *args, **kwargs) -> ModelBackend:
    return _make(_BACKEND_REGISTRY, "backend", name, *args, **kwargs)


def register_interface(name: str, cls: Callable) -> None:
    _INTERFACE_REGISTRY[name] = cls


def make_interface(name: str, *args, **kwargs) -> ModelInterface:
    return _make(_INTERFACE_REGISTRY, "interface", name, *args, **kwargs)


def register_dataset(name: str, cls: Callable) -> None:
    _DATASET_REGISTRY[name] = cls


def make_dataset(name: str, *args, **kwargs):
    return _make(_DATASET_REGISTRY, "dataset", name, *args, **kwargs)


_AGENT_REGISTRY: Dict[str, Callable] = {}
_ENV_REGISTRY: Dict[str, Callable] = {}


def register_agent(name: str, cls: Callable) -> None:
    _AGENT_REGISTRY[name] = cls


def make_agent(name: str, *args, **kwargs):
    return _make(_AGENT_REGISTRY, "agent", name, *args, **kwargs)


def register_env(name: str, cls: Callable) -> None:
    _ENV_REGISTRY[name] = cls


def make_env(name: str, *args, **kwargs):
    return _make(_ENV_REGISTRY, "env", name, *args, **kwargs)
