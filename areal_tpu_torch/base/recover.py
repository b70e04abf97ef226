"""Checkpoint/resume bookkeeping.

The port's copy of ``areal_tpu/base/recover.py`` (reference
``realhf/base/recover.py:19-111``): ``RecoverInfo`` holds step counters,
frequency-control states and hashes of already-consumed data, so that a
restarted run neither repeats trained samples nor skips untrained ones;
``discover_ckpt`` finds the latest complete checkpoint under a run
directory.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Set


@dataclasses.dataclass
class StepInfo:
    epoch: int = 0
    epoch_step: int = 0
    global_step: int = 0

    def next(self) -> "StepInfo":
        return StepInfo(self.epoch, self.epoch_step + 1, self.global_step + 1)


@dataclasses.dataclass
class RecoverInfo:
    recover_start: StepInfo = dataclasses.field(default_factory=StepInfo)
    last_step_info: StepInfo = dataclasses.field(default_factory=StepInfo)
    save_ctl_states: Dict[str, dict] = dataclasses.field(default_factory=dict)
    ckpt_ctl_states: Dict[str, dict] = dataclasses.field(default_factory=dict)
    eval_ctl_states: Dict[str, dict] = dataclasses.field(default_factory=dict)
    data_loading_dp_idx: int = 0
    hash_vals_to_ignore: List[int] = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "RecoverInfo":
        d = dict(d)
        d["recover_start"] = StepInfo(**d.get("recover_start", {}))
        d["last_step_info"] = StepInfo(**d.get("last_step_info", {}))
        return cls(**d)


def recover_info_path(run_dir: str) -> str:
    return os.path.join(run_dir, "recover_info.json")


def dump(run_dir: str, info: RecoverInfo) -> None:
    os.makedirs(run_dir, exist_ok=True)
    path = recover_info_path(run_dir)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(info.to_json(), f, indent=2)
    os.replace(tmp, path)


def load(run_dir: str) -> Optional[RecoverInfo]:
    path = recover_info_path(run_dir)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return RecoverInfo.from_json(json.load(f))


def ckpt_dirname(epoch: int, epoch_step: int, global_step: int) -> str:
    return f"epoch{epoch}epochstep{epoch_step}globalstep{global_step}"


def parse_ckpt_dirname(name: str) -> Optional[StepInfo]:
    import re

    m = re.fullmatch(r"epoch(\d+)epochstep(\d+)globalstep(\d+)", name)
    if not m:
        return None
    return StepInfo(int(m.group(1)), int(m.group(2)), int(m.group(3)))


# Terminal sentinel written into a checkpoint dir AFTER every file landed.
# A crash mid-save leaves a dir without it; discovery skips such dirs so a
# recovered run never restores from a half-written checkpoint.
CKPT_COMPLETE_MARKER = ".complete"


def mark_ckpt_complete(ckpt_dir: str) -> None:
    tmp = os.path.join(ckpt_dir, CKPT_COMPLETE_MARKER + f".tmp{os.getpid()}")
    with open(tmp, "w") as f:
        f.write("ok\n")
    os.replace(tmp, os.path.join(ckpt_dir, CKPT_COMPLETE_MARKER))


def ckpt_is_complete(ckpt_dir: str) -> bool:
    if os.path.exists(os.path.join(ckpt_dir, CKPT_COMPLETE_MARKER)):
        return True
    # Pre-sentinel compat: those checkpoints end with trainer_state.json
    # (the trainer writes it after every role's train state). It must
    # PARSE — a torn write from a crash mid-dump is exactly the
    # half-written state the sentinel exists to reject.
    try:
        with open(os.path.join(ckpt_dir, "trainer_state.json")) as f:
            json.load(f)
        return True
    except Exception:  # noqa: BLE001 — missing or torn: incomplete
        return False


def discover_ckpt(save_root: str) -> Optional[str]:
    """Latest COMPLETE checkpoint directory (by global step) under
    save_root; dirs missing the terminal sentinel (crash mid-save) are
    skipped."""
    if not os.path.isdir(save_root):
        return None
    best: Optional[str] = None
    best_step = -1
    for name in os.listdir(save_root):
        info = parse_ckpt_dirname(name)
        if info is None or info.global_step <= best_step:
            continue
        path = os.path.join(save_root, name)
        if not ckpt_is_complete(path):
            continue
        best_step = info.global_step
        best = path
    return best
