"""Frequency control for save/eval/ckpt triggers.

The port's copy of ``areal_tpu/base/timeutil.py`` (reference
``realhf/base/timeutil.py:15``, ``EpochStepTimeFreqCtl``): a trigger that
fires when any of (epochs elapsed, steps elapsed, wall seconds elapsed)
crosses its configured frequency. Its state is exportable for recovery.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class FreqState:
    last_epoch: int = 0
    last_step: int = 0
    last_time: float = dataclasses.field(default_factory=time.monotonic)


class FrequencyControl:
    """check(epoch, step) returns True when a configured frequency elapsed
    since the last True. Frequencies of None never fire on that axis."""

    def __init__(
        self,
        freq_epoch: Optional[int] = None,
        freq_step: Optional[int] = None,
        freq_sec: Optional[float] = None,
        initial_value: bool = False,
    ):
        self.freq_epoch = freq_epoch
        self.freq_step = freq_step
        self.freq_sec = freq_sec
        self._state = FreqState()
        self._first = initial_value

    def check(self, epochs: int, steps: int) -> bool:
        if self._first:
            self._first = False
            self._mark(epochs, steps)
            return True
        fire = False
        if (self.freq_epoch is not None
                and epochs - self._state.last_epoch >= self.freq_epoch):
            fire = True
        if (self.freq_step is not None
                and steps - self._state.last_step >= self.freq_step):
            fire = True
        if (self.freq_sec is not None
                and time.monotonic() - self._state.last_time >= self.freq_sec):
            fire = True
        if fire:
            self._mark(epochs, steps)
        return fire

    def _mark(self, epochs: int, steps: int) -> None:
        self._state.last_epoch = epochs
        self._state.last_step = steps
        self._state.last_time = time.monotonic()

    def state_dict(self) -> dict:
        return dataclasses.asdict(self._state)

    def load_state_dict(self, d: dict) -> None:
        self._state = FreqState(**d)
        # last_time is the saving process's time.monotonic(), a clock that
        # restarts at boot: restoring re-anchors the time axis at "now"
        # (the epoch and step anchors carry over exactly).
        self._state.last_time = time.monotonic()
