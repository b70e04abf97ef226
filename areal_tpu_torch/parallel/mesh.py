"""Device meshes and the allocation-mode vocabulary.

The port's counterpart of ``areal_tpu/parallel/mesh.py``: ``ParallelSpec``
(``:46``), ``make_mesh`` (``:107``), ``DATA_AXES`` and ``AllocationMode``
(``:135``), with the grammar of ``allocation_mode`` (``d2f2t2``,
``gen.d4+d2t2``, per-MFC ``actor_gen:d4,actor_train:f4``).

Axis order, as in the reference:

    ("dp", "fsdp", "ep", "pp", "sp", "tp")

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the current
process group, one rank per device (the reference has one process per
host owning several chips). ``tp`` is the innermost axis, so the ranks of
one tensor-parallel group are neighbours. Parameter layouts over it live
in ``parallel/sharding.py``.

Importing this module loads no torch: the launcher and the experiment
configs (torch-free processes) parse allocation strings with it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

AXIS_ORDER = ("dp", "fsdp", "ep", "pp", "sp", "tp")
_AXIS_LETTER = {"d": "dp", "f": "fsdp", "p": "pp", "s": "sp", "t": "tp",
                "e": "ep"}
# The axes a batch splits over: every flavour of data parallelism (ep is a
# slice of the data dimension whose shards own disjoint experts).
DATA_AXES = ("dp", "fsdp", "ep")


@dataclasses.dataclass(frozen=True)
class ParallelSpec:
    """Degrees along each mesh axis for one model role."""

    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1

    @property
    def world_size(self) -> int:
        return self.dp * self.fsdp * self.ep * self.pp * self.sp * self.tp

    @property
    def data_degree(self) -> int:
        """Number of distinct data shards (dp × fsdp × ep)."""
        return self.dp * self.fsdp * self.ep

    def mesh_shape(self) -> Tuple[int, ...]:
        return (self.dp, self.fsdp, self.ep, self.pp, self.sp, self.tp)

    @classmethod
    def parse(cls, s: str) -> "ParallelSpec":
        """Parse e.g. "d2f2s1t4" / "d2m2p1" (m is the reference's letter for
        tensor parallelism)."""
        s = s.strip().lower()
        if not re.fullmatch(r"(?:[a-z]\d+)+", s):
            raise ValueError(f"malformed parallel spec '{s}'")
        out: Dict[str, int] = {}
        for letter, num in re.findall(r"([a-z])(\d+)", s):
            axis = "tp" if letter == "m" else _AXIS_LETTER.get(letter)
            if axis is None:
                raise ValueError(f"unknown axis letter '{letter}' in '{s}'")
            if axis in out:
                raise ValueError(f"duplicate axis '{letter}' in '{s}'")
            out[axis] = int(num)
        return cls(**out)

    def __str__(self) -> str:
        return "".join(
            f"{l}{getattr(self, a)}"
            for l, a in (("d", "dp"), ("f", "fsdp"), ("p", "pp"),
                         ("s", "sp"), ("t", "tp"), ("e", "ep"))
            if getattr(self, a) != 1) or "d1"


# Why a generation spec takes no sp or ep (the reference's validate_config,
# areal_tpu/api/cli_args.py:501-527): the decode loop never rings and never
# exchanges experts.
GEN_AXIS_REFUSALS = {
    "sp": "sequence (ring) parallelism is training only: the decode loop "
          "never rings (a token at a time has no sequence to shard); move "
          "the sp factor into d or t for the generation fleet, e.g. s2 -> d2",
    "ep": "expert parallelism is training only: decode runs the grouped "
          "dispatch on whole experts (models/moe.py never exchanges under a "
          "KV cache); move the ep factor into d or t for the generation "
          "fleet, e.g. e2 -> d2",
}


def tp_kv_replicated(n_q_heads: int, n_kv_heads: int, tp: int) -> bool:
    """The head rules of tensor parallelism (``parallel/sharding.py
    kv_replicated``, torch-free for the config checks): whether each ``tp``
    rank keeps whole kv heads (Megatron's rule for fewer kv heads than
    ranks). Raises for counts no rule splits: ``n_q_heads % tp``, or kv
    heads that neither divide nor are divided by ``tp``."""
    if tp <= 1:
        return False
    if n_q_heads % tp:
        raise ValueError(f"tensor parallelism of {tp} does not divide "
                         f"{n_q_heads} query heads")
    if n_kv_heads % tp == 0:
        return False
    if tp % n_kv_heads:
        raise ValueError(f"tensor parallelism of {tp} neither divides nor "
                         f"is divided by {n_kv_heads} kv heads")
    return True


@dataclasses.dataclass(frozen=True)
class ServerRank:
    """One rank of a generation server whose ranks span ``spec``'s
    ``fsdp``, ``pp`` and ``tp`` axes (``dp`` counts servers, never a
    server's ranks): its coordinates in the server's mesh, in
    ``AXIS_ORDER`` (``tp`` innermost: rank ``(f·pp + p)·tp + t``). Rank 0,
    at ``(fsdp 0, pp 0, tp 0)``, leads. Torch-free, as the launcher and
    the layouts read it."""

    spec: ParallelSpec
    rank: int = 0

    def __post_init__(self):
        s = self.spec
        if s.dp != 1 or s.sp != 1 or s.ep != 1:
            raise ValueError(f"a generation server's ranks span fsdp, pp "
                             f"and tp only, not {s}")
        if not 0 <= self.rank < s.world_size:
            raise ValueError(f"rank {self.rank} of a server of "
                             f"{s.world_size} ranks ({s})")

    @property
    def fsdp_rank(self) -> int:
        return self.rank // (self.spec.pp * self.spec.tp)

    @property
    def pp_rank(self) -> int:
        return self.rank // self.spec.tp % self.spec.pp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.spec.tp

    @property
    def first_stage(self) -> bool:
        return self.pp_rank == 0

    @property
    def last_stage(self) -> bool:
        return self.pp_rank == self.spec.pp - 1


def server_spec(spec: ParallelSpec) -> ParallelSpec:
    """One server's spec of a generation spec (its ``dp`` counts
    servers)."""
    return dataclasses.replace(spec, dp=1)


def make_mesh(spec: ParallelSpec, device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``spec``'s shape over the current process group,
    with ``mesh_dim_names=AXIS_ORDER``. ``device_type`` defaults to
    ``cuda`` when the group's backend is NCCL, else ``cpu``. Raises when
    no group is up or its world size differs from ``spec.world_size``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(f"make_mesh({spec}) needs a process group: call "
                           "parallel.distributed.initialize first")
    world = dist.get_world_size()
    if world != spec.world_size:
        raise ValueError(f"spec {spec} needs a world of {spec.world_size} "
                         f"ranks, the process group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, spec.mesh_shape(),
                            mesh_dim_names=AXIS_ORDER)


@dataclasses.dataclass(frozen=True)
class AllocationMode:
    """Experiment-wide allocation: ``global_spec`` for every MFC,
    ``gen_spec`` for a decoupled generation fleet, ``per_mfc`` overrides."""

    global_spec: ParallelSpec
    gen_spec: Optional[ParallelSpec] = None
    per_mfc: Dict[str, ParallelSpec] = dataclasses.field(default_factory=dict)

    @property
    def decoupled(self) -> bool:
        return self.gen_spec is not None

    @classmethod
    def parse(cls, s: str) -> "AllocationMode":
        s = s.strip()
        if ":" in s:  # per-MFC: "actor_gen:d4t2,actor_train:f4t4"
            per = {}
            for part in s.split(","):
                name, sep, spec = part.partition(":")
                if not sep or not name.strip() or not spec.strip():
                    raise ValueError(f"malformed per-MFC allocation entry "
                                     f"'{part}' in '{s}'")
                name = name.strip()
                if name in per:
                    raise ValueError(f"duplicate MFC '{name}' in allocation "
                                     f"mode '{s}'")
                per[name] = ParallelSpec.parse(spec)
            train = per.get("actor_train") or next(iter(per.values()))
            return cls(global_spec=train, gen_spec=per.get("actor_gen"),
                       per_mfc=per)
        if "+" in s:  # decoupled: "gen.d4t2+train.f8t2" or "sglang.d4+d2t2"
            gen_part, train_part = s.split("+")
            return cls(
                global_spec=ParallelSpec.parse(train_part.split(".")[-1]),
                gen_spec=ParallelSpec.parse(gen_part.split(".")[-1]))
        return cls(global_spec=ParallelSpec.parse(s))
