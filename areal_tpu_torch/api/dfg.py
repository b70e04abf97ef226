"""Dataflow graph of Model Function Calls (MFCs).

The port's copy of ``areal_tpu/api/dfg.py`` (reference
``realhf/api/core/dfg.py:56,237``): nodes are MFCs (generate / inference /
train_step on a named model role with declared input/output data keys);
edges are derived from key producer→consumer relations; hooks describe
parameter reallocation and weight publishing around a node.

No networkx dependency: the graph is small (≤ ~10 nodes), plain dicts.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Set, Tuple

from areal_tpu_torch.api.data import MicroBatchSpec


class MFCInterfaceType(enum.Enum):
    GENERATE = "generate"
    INFERENCE = "inference"
    TRAIN_STEP = "train_step"


@dataclasses.dataclass
class MFCHook:
    pass


@dataclasses.dataclass
class ParamReallocHook(MFCHook):
    """Sync params from/to another model role (EMA or weight publishing)."""

    source: Optional[str] = None
    target: Optional[str] = None
    eta: float = 1.0  # target := eta * source + (1-eta) * target


# The reference package has no OffloadHook (realhf dfg.py:42), and neither
# has the port: every role's engine stays resident on the card.


@dataclasses.dataclass
class WeightUpdateHook(MFCHook):
    """Publish trainer weights for the generation fleet (the disk/ICI
    weight-sync path; reference: gserver weight update in §3.5)."""

    role: str = "actor"


@dataclasses.dataclass
class ModelInterfaceAbstraction:
    type_: str
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MFCDef:
    name: str
    model_name: str
    interface_type: MFCInterfaceType
    interface_impl: ModelInterfaceAbstraction
    input_keys: Tuple[str, ...] = ()
    output_keys: Tuple[str, ...] = ()
    input_key_remap: Dict[str, str] = dataclasses.field(default_factory=dict)
    output_key_remap: Dict[str, str] = dataclasses.field(default_factory=dict)
    n_seqs: int = 1
    mb_spec: MicroBatchSpec = dataclasses.field(default_factory=MicroBatchSpec)
    min_n_seqs_per_pass: float = 1.0
    balanced_dp: bool = False
    log_return_value: bool = False
    pre_hooks: List[MFCHook] = dataclasses.field(default_factory=list)
    post_hooks: List[MFCHook] = dataclasses.field(default_factory=list)

    # filled by build_graph
    _parents: List[str] = dataclasses.field(default_factory=list)
    _children: List[str] = dataclasses.field(default_factory=list)

    @property
    def is_src(self) -> bool:
        return not self._parents

    @property
    def is_dst(self) -> bool:
        return not self._children

    @property
    def parents(self) -> List[str]:
        return list(self._parents)

    @property
    def children(self) -> List[str]:
        return list(self._children)


@dataclasses.dataclass
class DataFlowGraph:
    nodes: Dict[str, MFCDef]
    edges: List[Tuple[str, str, Set[str]]]  # (producer, consumer, keys)

    def topological_order(self) -> List[str]:
        indeg = {n: len(self.nodes[n]._parents) for n in self.nodes}
        order = []
        ready = sorted([n for n, d in indeg.items() if d == 0])
        while ready:
            n = ready.pop(0)
            order.append(n)
            for c in sorted(set(self.nodes[n]._children)):
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
            ready.sort()
        if len(order) != len(self.nodes):
            raise ValueError("DFG has a cycle")
        return order

    @property
    def source_keys(self) -> Set[str]:
        """Keys that must come from the dataset (consumed but never produced)."""
        produced = set()
        for n in self.nodes.values():
            produced |= {n.output_key_remap.get(k, k) for k in n.output_keys}
        needed = set()
        for n in self.nodes.values():
            needed |= set(n.input_keys)
        return needed - produced

    @property
    def model_names(self) -> Set[str]:
        return {n.model_name for n in self.nodes.values()}


def build_graph(mfcs: List[MFCDef], verbose: bool = False) -> DataFlowGraph:
    """Derive edges from output-key → input-key matches (after remaps).

    A consumer depends on the producer of each of its input keys; keys with no
    producer are dataset keys. Mirrors reference dfg.py:237.
    """
    by_name = {m.name: m for m in mfcs}
    if len(by_name) != len(mfcs):
        raise ValueError("duplicate MFC names")
    producers: Dict[str, str] = {}
    for m in mfcs:
        for k in m.output_keys:
            k = m.output_key_remap.get(k, k)
            if k in producers:
                raise ValueError(
                    f"key {k} produced by both {producers[k]} and {m.name}"
                )
            producers[k] = m.name
    edges: Dict[Tuple[str, str], Set[str]] = {}
    for m in mfcs:
        m._parents.clear()
        m._children.clear()
    for m in mfcs:
        for k in m.input_keys:
            src = producers.get(k)
            if src is None or src == m.name:
                continue
            edges.setdefault((src, m.name), set()).add(k)
    for (src, dst), keys in edges.items():
        by_name[src]._children.append(dst)
        by_name[dst]._parents.append(src)
    g = DataFlowGraph(
        nodes=by_name,
        edges=[(s, d, k) for (s, d), k in sorted(edges.items())],
    )
    g.topological_order()  # raises on cycles
    return g
