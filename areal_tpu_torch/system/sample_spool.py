"""Durable trajectory spool: at-least-once rollout -> trainer delivery.

The port of ``areal_tpu/system/sample_spool.py``. The trajectory stream
(``streams.TrajectoryPusher`` -> the trainer's ``TrajectoryPuller``) is
fire-and-forget: a trainer death loses every trajectory in flight, while
the rollout worker's ``ConsumedLog`` makes sure those prompts are never
generated again. This module closes the hole:

 - :class:`SampleSpool`, a per-rollout-worker append-only segment log.
   Every accepted trajectory is fsynced here before its prompt is marked
   consumed, so "consumed => spooled" holds at every instruction boundary.
   Records carry a CRC; recovery drops a torn tail as the ConsumedLog does
   (a record that never fully landed belongs to a prompt not yet consumed).
 - :class:`SpoolSender`, a thread that drains the spool to the trainer's
   stream (a dead trainer no longer wedges the rollout loop inside a push),
   reads acks from the worker's own ack channel, deletes acked segment
   prefixes and re-sends what was never acked (a trainer restart).
 - :class:`SpoolIngest`, the trainer's idempotent ingest decision: dedup
   by sample id, a staleness gate on replays, and the bookkeeping that
   turns the master's freed ids ("clear", after the step's recover
   checkpoint) into acks.

Records have the reference's layout byte for byte (a 24-byte header, then
the payload), so either package recovers the other's spool. Payloads are
the stream's own packing (``streams.pack``: pickle here, msgpack in the
reference). With durability off nothing is injected: the push bytes are
exactly those of the plain stream.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import struct
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from areal_tpu_torch.base import logging, telemetry

logger = logging.getLogger("system.sample_spool")

SPOOL_KEY = "_spool"

# Record layout: a 24-byte header, then the payload.
#   >Q  seqno       (from 1; also the ack unit)
#   >d  wall time   (the oldest-unacked age survives restarts)
#   >I  payload length
#   >I  crc32 over the first 20 header bytes and the payload
_HDR = struct.Struct(">QdI")
_CRC = struct.Struct(">I")
_HDR_BYTES = _HDR.size + _CRC.size


def ack_channel_name(worker_index: int) -> str:
    """The puller name of rollout worker ``worker_index``'s ack channel
    (the trainer pushes ``{"seqnos": [...]}`` to it)."""
    return f"spool_ack_{worker_index}"


class SpoolFull(RuntimeError):
    """``append`` at ``max_bytes``: the caller waits for acks to free
    space (backpressure) instead of growing the disk footprint."""


@dataclasses.dataclass
class SpoolStats:
    depth: int  # unacked records
    bytes: int  # live segment bytes on disk
    oldest_unacked_age_secs: float  # 0.0 when empty
    acked_watermark: int
    next_seqno: int


@dataclasses.dataclass
class _Segment:
    path: str
    first: int  # first seqno in the file
    last: int  # last seqno written (first - 1 when empty)
    nbytes: int


class SampleSpool:
    """Append-only segments with a durable contiguous-ack watermark.

    ``append`` returns only after the record is flushed and fsynced, so the
    caller may mark the prompt consumed knowing the trajectory can always
    be replayed. The watermark file is replaced atomically but not fsynced
    per ack: losing it only replays records the trainer dedups.

    Unacked payloads are also kept in memory (bounded by ``max_bytes``, as
    the disk is), so the sender never reads the segment files back; a
    restart reloads them. Thread-safe: the rollout loop appends (through
    ``asyncio.to_thread``) while the sender thread acks and reads."""

    def __init__(self, directory: str, segment_bytes: int = 8 << 20,
                 max_bytes: int = 256 << 20):
        if segment_bytes <= 0 or max_bytes < segment_bytes:
            raise ValueError(f"spool needs 0 < segment_bytes ({segment_bytes})"
                             f" <= max_bytes ({max_bytes})")
        self.dir = directory
        self.segment_bytes = segment_bytes
        self.max_bytes = max_bytes
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._space = threading.Condition(self._lock)
        self._fh = None  # the active segment (append mode)
        self._segments: List[_Segment] = []
        self._recs: Dict[int, Tuple[float, bytes]] = {}  # seqno -> (ts, raw)
        self._acked_above: set = set()  # acked above the watermark
        self._watermark = self._read_watermark()
        self._next = self._watermark + 1
        self._bytes = 0
        self._closed = False
        self._recover()

    # ---------------- recovery ----------------

    @property
    def _wm_path(self) -> str:
        return os.path.join(self.dir, "acked")

    def _read_watermark(self) -> int:
        try:
            with open(self._wm_path) as f:
                return int(f.read().strip() or 0)
        except (FileNotFoundError, ValueError):
            return 0

    def _write_watermark(self) -> None:
        tmp = self._wm_path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(str(self._watermark))
        os.replace(tmp, self._wm_path)

    def _recover(self) -> None:
        """Scan the segments: rebuild the unacked records and truncate a
        torn tail (a crash mid-append; its prompt was not yet consumed, so
        it is generated and trained once more, the safe direction)."""
        names = sorted(n for n in os.listdir(self.dir)
                       if n.startswith("seg-") and n.endswith(".spool"))
        expected = None
        for name in names:
            path = os.path.join(self.dir, name)
            with open(path, "rb") as f:
                raw = f.read()
            off = 0
            first = int(name[len("seg-"):-len(".spool")])
            if expected is not None and first != expected:
                logger.error(f"spool {self.dir}: segment {name} starts at "
                             f"{first}, expected {expected}; dropping it "
                             "(corruption mid-chain)")
                os.remove(path)
                continue
            seg = _Segment(path, first, first - 1, 0)
            while off + _HDR_BYTES <= len(raw):
                seqno, ts, length = _HDR.unpack_from(raw, off)
                (crc,) = _CRC.unpack_from(raw, off + _HDR.size)
                end = off + _HDR_BYTES + length
                if end > len(raw):
                    break  # torn payload
                payload = raw[off + _HDR_BYTES:end]
                if crc != zlib.crc32(raw[off:off + _HDR.size] + payload):
                    break  # torn or corrupt record
                if seqno != seg.last + 1:
                    break  # a sequence break counts as corruption
                seg.last = seqno
                seg.nbytes += end - off
                if seqno > self._watermark:
                    self._recs[seqno] = (ts, payload)
                off = end
            if off < len(raw):
                logger.warning(f"spool {self.dir}: truncating the torn tail "
                               f"of {name} at byte {off} (a crash mid-append;"
                               " that record's prompt was never consumed)")
                with open(path, "rb+") as f:
                    f.truncate(off)
            if seg.last < seg.first:  # nothing valid in the file
                os.remove(path)
                continue
            self._segments.append(seg)
            self._bytes += seg.nbytes
            expected = seg.last + 1
        if self._segments:
            self._next = max(self._next, self._segments[-1].last + 1)
        # segments wholly below the watermark outlived a crash between the
        # ack and the delete
        self._gc_locked()

    # ---------------- append ----------------

    def append(self, payload: bytes, ts: Optional[float] = None) -> int:
        """Durably append one record; returns its seqno. Raises
        :class:`SpoolFull` past ``max_bytes``."""
        return self.append_framed(lambda seqno: payload, ts=ts)

    def append_framed(self, frame: Callable[[int], bytes],
                      ts: Optional[float] = None) -> int:
        """``append`` of a payload that embeds its own seqno:
        ``frame(seqno) -> bytes`` runs under the lock, so seqno order is
        the on-disk order."""
        with self._lock:
            if self._closed:
                raise RuntimeError("spool is closed")
            seqno = self._next
            payload = frame(seqno)
            size = _HDR_BYTES + len(payload)
            if self._bytes + size > self.max_bytes:
                raise SpoolFull(f"spool at {self._bytes}B (+{size}B > "
                                f"{self.max_bytes}B cap): trainer acks are "
                                "not keeping up")
            ts = time.time() if ts is None else ts
            hdr20 = _HDR.pack(seqno, ts, len(payload))
            rec = hdr20 + _CRC.pack(zlib.crc32(hdr20 + payload)) + payload
            fh = self._active_segment(seqno)
            fh.write(rec)
            fh.flush()
            os.fsync(fh.fileno())
            self._segments[-1].last = seqno
            self._segments[-1].nbytes += len(rec)
            self._bytes += len(rec)
            self._recs[seqno] = (ts, payload)
            self._next = seqno + 1
            return seqno

    def _active_segment(self, next_seqno: int):
        if (self._fh is not None
                and self._segments[-1].nbytes >= self.segment_bytes):
            self._fh.close()
            self._fh = None
        if self._fh is None:
            # Always a fresh file named by its first seqno: a restarted
            # worker starts a segment of its own instead of appending to the
            # recovered tail.
            path = os.path.join(self.dir, f"seg-{next_seqno:016d}.spool")
            self._fh = open(path, "ab")
            if not self._segments or self._segments[-1].path != path:
                self._segments.append(
                    _Segment(path, next_seqno, next_seqno - 1, 0))
        return self._fh

    # ---------------- ack / read ----------------

    def ack(self, seqnos: Sequence[int]) -> int:
        """Mark records settled (trained or durably dropped); returns how
        many were newly acked. Advances the contiguous watermark and
        deletes fully acked segments."""
        with self._lock:
            n_new = 0
            for s in seqnos:
                s = int(s)
                if (s <= self._watermark or s in self._acked_above
                        or s >= self._next):
                    continue
                self._acked_above.add(s)
                self._recs.pop(s, None)
                n_new += 1
            advanced = False
            while self._watermark + 1 in self._acked_above:
                self._watermark += 1
                self._acked_above.discard(self._watermark)
                advanced = True
            if advanced:
                self._write_watermark()
                self._gc_locked()
            if n_new:
                self._space.notify_all()
            return n_new

    def _gc_locked(self) -> None:
        keep: List[_Segment] = []
        for seg in self._segments:
            if seg.last <= self._watermark:
                if self._fh is not None and self._fh.name == seg.path:
                    self._fh.close()
                    self._fh = None
                try:
                    os.remove(seg.path)
                except FileNotFoundError:
                    pass
                self._bytes -= seg.nbytes
            else:
                keep.append(seg)
        self._segments = keep

    def wait_for_space(self, timeout: float) -> bool:
        """Block until an ack frees space, or ``timeout``."""
        with self._space:
            return self._space.wait(timeout)

    def pending(self, after: int = 0) -> List[Tuple[int, float, bytes]]:
        """Unacked records with seqno > ``after``, in seqno order."""
        with self._lock:
            return sorted((s, ts, raw) for s, (ts, raw) in self._recs.items()
                          if s > after)

    def unacked_seqnos(self) -> List[int]:
        with self._lock:
            return sorted(self._recs)

    def stats(self) -> SpoolStats:
        with self._lock:
            oldest = min((ts for ts, _ in self._recs.values()), default=None)
            return SpoolStats(
                depth=len(self._recs), bytes=self._bytes,
                oldest_unacked_age_secs=(max(0.0, time.time() - oldest)
                                         if oldest else 0.0),
                acked_watermark=self._watermark, next_seqno=self._next)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            self._space.notify_all()


class SpoolSender(threading.Thread):
    """Drains a :class:`SampleSpool` to the trainer from a thread of its own.

    The rollout loop only calls :meth:`submit` (through
    ``asyncio.to_thread``); the pushes, the acks, the resend timer and the
    spool gauges live on this thread, so a dead or slow trainer shows as
    spool growth and backpressure, never as a wedged event loop. A record
    unacked ``resend_timeout_secs`` after its last send goes again, flagged
    ``"r": 1``; what the spool holds at startup (a respawned worker) is
    replayed at once, flagged the same way. ``counts`` keeps the delivery
    counters (``appended``, ``acked``, ``replayed``, ``resent``,
    ``backpressure_waits``) for callers without telemetry."""

    # after a failed send, the pause before the next attempt
    RETRY_SECS = 0.2

    def __init__(self, spool: SampleSpool, pusher, ack_puller,
                 worker_index: int, resend_timeout_secs: float = 30.0,
                 poll_secs: float = 0.05):
        super().__init__(name=f"spool-sender-{worker_index}", daemon=True)
        self.spool = spool
        self.pusher = pusher
        self.ack_puller = ack_puller
        self.worker_index = worker_index
        self.resend_timeout_secs = resend_timeout_secs
        self.poll_secs = poll_secs
        self.counts: Dict[str, int] = collections.Counter()
        self._wake = threading.Event()
        self._closing = threading.Event()
        self._last_sent = spool.stats().acked_watermark
        self._sent_at: Dict[int, float] = {}
        self._retry_at = 0.0
        # Everything the spool already holds predates this incarnation:
        # crash replays, flagged for the trainer's staleness gate (fresh
        # sends have just passed the manager's).
        self._replay = set(spool.unacked_seqnos())
        self._gauges_at = 0.0

    def _inc(self, name: str, n: int = 1) -> None:
        self.counts[name] += n
        telemetry.inc(f"spool/{name}", n)

    # ---- the producer's side (the rollout loop, through to_thread) ----

    def submit(self, obj: Dict[str, Any]) -> int:
        """Durably spool one trajectory dict; returns its seqno. The active
        trace is captured here (contextvars follow ``to_thread``), as the
        direct push does. Blocks under backpressure until acks free
        space."""
        from areal_tpu_torch.system.streams import pack

        obj = telemetry.inject_payload(obj)

        def frame(seqno: int) -> bytes:
            obj[SPOOL_KEY] = {"w": self.worker_index, "seq": seqno}
            return pack(obj)

        while True:
            try:
                seqno = self.spool.append_framed(frame)
                break
            except SpoolFull:
                self._inc("backpressure_waits")
                if self._closing.is_set():
                    raise
                self.spool.wait_for_space(0.5)
        self._inc("appended")
        self._wake.set()
        return seqno

    # ---- the sender thread ----

    def _drain_acks(self) -> None:
        while True:
            try:
                msg = self.ack_puller.pull(timeout_ms=0)
            except Exception:  # noqa: BLE001 — the channel closed at exit
                return
            if msg is None:
                return
            seqnos = msg.get("seqnos") if isinstance(msg, dict) else None
            if not seqnos:
                continue
            n = self.spool.ack(seqnos)
            for s in seqnos:
                self._sent_at.pop(int(s), None)
            if n:
                self._inc("acked", n)

    def _send_raw(self, seqno: int, raw: bytes, replay: bool) -> bool:
        """One send, bounded by the pusher's ``block_secs``; False: retry on
        a later tick."""
        if time.monotonic() < self._retry_at:
            return False
        if replay:
            # A re-send carries the replay flag for the trainer's staleness
            # gate; a first send goes out exactly as spooled.
            from areal_tpu_torch.system.streams import pack, unpack

            obj = unpack(raw)
            meta = obj.get(SPOOL_KEY)
            if isinstance(meta, dict):
                meta["r"] = 1
            raw = pack(obj)
        try:
            self.pusher.push_packed(raw)
        except Exception:  # noqa: BLE001 — the trainer is gone or not pulling
            self._retry_at = time.monotonic() + self.RETRY_SECS
            return False
        self._sent_at[seqno] = time.monotonic()
        return True

    def _pump(self) -> None:
        self._drain_acks()
        # first sends (and startup replays) in seqno order
        for seqno, _ts, raw in self.spool.pending(after=self._last_sent):
            replay = seqno in self._replay
            if not self._send_raw(seqno, raw, replay):
                return
            if replay:
                self._inc("replayed")
                self._replay.discard(seqno)
            self._last_sent = max(self._last_sent, seqno)
        # the resend timer: a record the trainer never settled (it died
        # between the pull and the step, or the ack was lost)
        now = time.monotonic()
        for seqno, _ts, raw in self.spool.pending(after=0):
            if seqno > self._last_sent:
                continue
            at = self._sent_at.get(seqno)
            if at is not None and now - at < self.resend_timeout_secs:
                continue
            if at is None and seqno in self._replay:
                continue  # still waiting for its first (replay) send
            if not self._send_raw(seqno, raw, replay=True):
                return
            self._inc("resent")

    def _publish_gauges(self) -> None:
        now = time.monotonic()
        if now - self._gauges_at < 1.0:
            return
        self._gauges_at = now
        st = self.spool.stats()
        telemetry.set_gauge("spool/depth", float(st.depth))
        telemetry.set_gauge("spool/bytes", float(st.bytes))
        telemetry.set_gauge("spool/oldest_unacked_age_secs",
                            st.oldest_unacked_age_secs)

    def run(self) -> None:
        while not self._closing.is_set():
            try:
                self._pump()
                self._publish_gauges()
            except Exception as e:  # noqa: BLE001 — the sender must survive
                logger.warning(f"spool sender pump failed ({e}); retrying")
                time.sleep(0.2)
            self._wake.wait(self.poll_secs)
            self._wake.clear()

    def close(self, drain_secs: float = 5.0) -> None:
        """Stop, after giving in-flight acks ``drain_secs`` to arrive (a
        clean exit with an empty spool leaves nothing to replay)."""
        deadline = time.monotonic() + max(drain_secs, 0.0)
        while (self.spool.stats().depth > 0
               and time.monotonic() < deadline):
            time.sleep(0.05)
        self._closing.set()
        self._wake.set()
        if self.is_alive():
            self.join(timeout=5.0)
        self._gauges_at = 0.0
        try:
            self._publish_gauges()
        except Exception:  # noqa: BLE001 — the registry is already down
            pass
        self.spool.close()


class SpoolIngest:
    """The trainer's idempotent ingest bookkeeping.

    ``observe`` classifies each spooled sample as it arrives:

    - ``("ingest", None)``: first sighting; train it. The ack follows when
      the master's freed ids ("clear", after the step's recover checkpoint,
      or a durable drop in its buffer) name it in :meth:`pop_settled`.
    - ``("duplicate", None)``: the original is still in the pipeline; drop
      the copy, its ack rides the original's.
    - ``("duplicate", (w, seq))``: already settled here (the ack was lost);
      ack again now so the worker stops re-sending.
    - ``("stale", (w, seq))``: a replay past the staleness bound; durably
      dropped, counted and acked.

    The set of ingested ids lives as long as the process (a trainer restart
    clears it, which is when replays must ingest again). ``counts`` keeps
    the verdicts."""

    def __init__(self, staleness_limit: int = 8):
        self.staleness_limit = staleness_limit
        self._lock = threading.Lock()
        self._ids: set = set()
        self._pending: Dict[Any, Tuple[int, int]] = {}
        self.counts: Dict[str, int] = collections.Counter()

    def observe(self, sample_id: Any, meta: Dict[str, Any],
                cur_version: float, sample_version: Optional[float]
                ) -> Tuple[str, Optional[Tuple[int, int]]]:
        verdict = self._observe(sample_id, meta, cur_version, sample_version)
        self.counts[verdict[0]] += 1
        return verdict

    def _observe(self, sample_id, meta, cur_version, sample_version):
        w, seq = int(meta["w"]), int(meta["seq"])
        with self._lock:
            if sample_id in self._ids:
                if sample_id in self._pending:
                    return "duplicate", None
                return "duplicate", (w, seq)
            if (meta.get("r") and self.staleness_limit >= 0
                    and sample_version is not None
                    and cur_version - sample_version > self.staleness_limit):
                # remembered: a later re-send of the dropped record takes
                # the settled-duplicate path and is acked again
                self._ids.add(sample_id)
                return "stale", (w, seq)
            self._ids.add(sample_id)
            self._pending[sample_id] = (w, seq)
            return "ingest", None

    def pop_settled(self, sample_ids: Sequence[Any]) -> Dict[int, List[int]]:
        """The ids the master reported freed -> ``{worker: [seqnos]}`` to
        ack."""
        out: Dict[int, List[int]] = {}
        with self._lock:
            for sid in sample_ids:
                ws = self._pending.pop(sid, None)
                if ws is not None:
                    out.setdefault(ws[0], []).append(ws[1])
        return out
