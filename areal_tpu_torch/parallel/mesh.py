"""Allocation strings: ``ParallelSpec`` and ``AllocationMode`` parsing.

The port's copy of the parsing half of ``areal_tpu/parallel/mesh.py``
(``ParallelSpec:46``, ``AllocationMode:135``): the grammar of
``allocation_mode`` (``d2f2t2``, ``gen.d4+d2t2``, per-MFC
``actor_gen:d4,actor_train:f4``). The port runs on one device, so the
experiments accept only specs of world size 1 (``experiments/common.py
resolve_allocation``); meshes come with multi-GPU parallelism (ROADMAP.md
Queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

_AXIS_LETTER = {"d": "dp", "f": "fsdp", "p": "pp", "s": "sp", "t": "tp",
                "e": "ep"}


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


@dataclasses.dataclass(frozen=True)
class AllocationMode:
    """Experiment-wide allocation: ``global_spec`` for every MFC,
    ``gen_spec`` for a decoupled generation fleet, ``per_mfc`` overrides."""

    global_spec: ParallelSpec
    gen_spec: Optional[ParallelSpec] = None
    per_mfc: Dict[str, ParallelSpec] = dataclasses.field(default_factory=dict)

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
