"""The master's metadata buffer.

The port's copy of ``areal_tpu/system/buffer.py`` (reference
``realhf/system/buffer.py:117``, AsyncIOSequenceBuffer): a per-slot state
machine (empty → put → amend* → read* → free), asyncio condition
signalling, per-MFC readiness from input keys, oldest-first batch
selection, and slots freed once every consuming MFC has read them, with
the reference's telemetry: the ``buffer/duplicate_dropped`` counter and
the per-MFC sample-age histogram (``buffer/<mfc>_sample_age_secs``).
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Dict, Hashable, List, Optional, Sequence, Set

from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.base import telemetry


@dataclasses.dataclass
class _Slot:
    sample: SequenceSample  # metadata only (data=None)
    birth_time: float  # monotonic: local oldest-first order
    reads_left: int
    birth_wall: float = 0.0  # wall clock: composes with stitched traces
    read_by: Set[str] = dataclasses.field(default_factory=set)


class AsyncSequenceBuffer:
    """Holds SequenceSample metadata only; the tensors live in the
    trainer's data store."""

    def __init__(self, n_rpcs_reading: int, max_size: int = 65536):
        self.max_size = max_size
        self._n_reads = n_rpcs_reading
        self._slots: Dict[Hashable, _Slot] = {}
        self._lock = asyncio.Lock()
        self._changed = asyncio.Condition(self._lock)
        # ids whose slots were consumed or dropped since the last
        # pop_freed(): the master forwards them to the trainer's "clear".
        self._freed: List[Hashable] = []

    def __len__(self) -> int:
        return len(self._slots)

    async def put_batch(self, samples: Sequence[SequenceSample]) -> None:
        async with self._lock:
            for s in samples:
                if s.bs != 1:
                    raise ValueError("buffer slots hold single samples")
                sid = s.ids[0]
                if sid in self._slots:
                    # A duplicate is skipped: the live slot keeps its read
                    # state and the id does not re-enter _freed.
                    telemetry.inc("buffer/duplicate_dropped")
                    continue
                if len(self._slots) >= self.max_size:
                    raise RuntimeError("buffer overflow")
                self._slots[sid] = _Slot(sample=s.meta(),
                                         birth_time=time.monotonic(),
                                         reads_left=self._n_reads,
                                         birth_wall=time.time())
            self._changed.notify_all()

    async def amend_batch(self, sample: SequenceSample) -> None:
        """Merge new keys into existing slots (an MFC's outputs)."""
        async with self._lock:
            for i, sid in enumerate(sample.ids):
                slot = self._slots.get(sid)
                if slot is None:
                    continue  # slot already consumed (a late amend is benign)
                slot.sample.update_(sample.select_idx([i]).meta())
            self._changed.notify_all()

    async def get_batch_for_rpc(
        self,
        rpc_name: str,
        input_keys: Set[str],
        n_seqs: int,
        timeout: Optional[float] = None,
    ) -> List[SequenceSample]:
        """Block until ≥ n_seqs samples hold all ``input_keys`` and were not
        yet read by ``rpc_name``; return the n_seqs oldest (metadata)."""

        def ready() -> List[Hashable]:
            cand = [(slot.birth_time, sid) for sid, slot in self._slots.items()
                    if rpc_name not in slot.read_by
                    and input_keys <= slot.sample.keys]
            cand.sort()
            return [sid for _, sid in cand]

        deadline = time.monotonic() + timeout if timeout else None
        async with self._lock:
            while True:
                ids = ready()
                if len(ids) >= n_seqs:
                    out = []
                    now_wall = time.time()
                    for sid in ids[:n_seqs]:
                        slot = self._slots[sid]
                        slot.read_by.add(rpc_name)
                        slot.reads_left -= 1
                        # the sample's dwell at selection (no-op when off)
                        telemetry.observe(
                            f"buffer/{rpc_name}_sample_age_secs",
                            max(now_wall - slot.birth_wall, 0.0))
                        out.append(slot.sample.meta())
                        if slot.reads_left <= 0:
                            del self._slots[sid]
                            self._freed.append(sid)
                    return out
                wait = None
                if deadline is not None:
                    wait = deadline - time.monotonic()
                    if wait <= 0:
                        raise asyncio.TimeoutError(
                            f"rpc {rpc_name}: {len(ids)}/{n_seqs} ready")
                try:
                    await asyncio.wait_for(self._changed.wait(), wait)
                except asyncio.TimeoutError:
                    raise asyncio.TimeoutError(
                        f"rpc {rpc_name}: {len(ids)}/{n_seqs} ready") from None

    async def mark_read(self, ids: Sequence[Hashable], rpc_name: str) -> None:
        """Mark slots as already read by ``rpc_name`` (a generate MFC that
        replaces prompt slots with trajectory slots must not read its own
        outputs)."""
        async with self._lock:
            for sid in ids:
                slot = self._slots.get(sid)
                if slot is None or rpc_name in slot.read_by:
                    continue
                slot.read_by.add(rpc_name)
                slot.reads_left -= 1
                if slot.reads_left <= 0:
                    del self._slots[sid]
                    self._freed.append(sid)
            self._changed.notify_all()

    async def drop_ids(self, ids: Sequence[Hashable]) -> None:
        async with self._lock:
            for sid in ids:
                if self._slots.pop(sid, None) is not None:
                    self._freed.append(sid)
            self._changed.notify_all()

    async def pop_freed(self) -> List[Hashable]:
        """Fully consumed sample ids since the last call (for trainer GC)."""
        async with self._lock:
            out, self._freed = self._freed, []
            return out
