"""Fused concurrent forward interface.

The port of ``areal_tpu/algorithms/fused.py:31-80`` (reference
``realhf/impl/model/interface/fused_interface.py:23``,
FusedThreadingForwardInterface, registered "fused-threading"): one MFC
that runs several child interfaces' ``inference`` at once in a thread pool
and merges their output samples. Its use is the sync recipe's
``fuse_rew_ref``: the reference log-probs (on the card) and the rule-based
reward (on the host) overlap instead of running one after the other, and
the master makes one round trip instead of two.

Thread safety: PyTorch's grad mode is thread-local, and every engine
forward runs under its own ``torch.no_grad()``, which holds in a pool
thread too; the kernels' launch counters take a lock; the reward child
only reads the tokenizer.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model import (
    Model,
    ModelInterface,
    make_interface,
    register_interface,
)
from areal_tpu_torch.base import logging

logger = logging.getLogger("algorithms.fused")


@dataclasses.dataclass
class FusedForwardInterface(ModelInterface):
    """``interfaces``: {child_name: (registered_interface_name, kwargs)}.

    Every child runs ``inference`` on the same (model, data, mb_spec) in a
    thread pool; their outputs merge through ``SequenceSample.update_`` in
    dict order (the key sets must be disjoint)."""

    interfaces: Dict[str, Tuple[str, Dict[str, Any]]] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        self._children: Dict[str, ModelInterface] = {
            key: make_interface(name, **(kwargs or {}))
            for key, (name, kwargs) in self.interfaces.items()
        }
        assert self._children, "the fused interface needs a child"

    def _run_one(self, key: str, model, data, mb_spec):
        t0 = time.perf_counter()
        out = self._children[key].inference(model, data, mb_spec)
        logger.info(f"fused child {key} took {time.perf_counter() - t0:.3f}s")
        return out

    def inference(
        self, model: Model, data: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Optional[SequenceSample]:
        with ThreadPoolExecutor(max_workers=len(self._children)) as pool:
            futs = {key: pool.submit(self._run_one, key, model, data, mb_spec)
                    for key in self._children}
            final: Optional[SequenceSample] = None
            # Dict order, not completion order: update_ checks the ids, so
            # the order only decides which sample's ids are kept.
            for fut in futs.values():
                res = fut.result()
                if res is None:
                    continue
                if final is None:
                    final = res
                else:
                    final.update_(res)
        return final


register_interface("fused_forward", FusedForwardInterface)
register_interface("fused-threading", FusedForwardInterface)
