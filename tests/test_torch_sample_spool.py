"""The port's durable trajectory spool against the reference's.

Twins of the tier-1 tests of ``tests/test_sample_spool.py`` (append, ack,
watermark, segment GC, backpressure, crash recovery with torn-tail and CRC
repair, the consumed-log crash-ordering invariant, the sender and its ack
channel over the port's TCP frames, idempotent ingest, the buffer's
duplicate skip, the reply ``done`` flag, the bounded push and the wire
bytes with durability off), on tmp-dir spools, plus the cross-package
checks: the same appends with the same timestamps give byte-identical
segment files and watermark in both packages, each package recovers the
other's files (a torn tail and a bad CRC included), and both ingests decide
alike on a seeded sequence of sample ids and versions.

Every wait is bounded.
"""

import asyncio
import os
import pickle
import random
import select
import shutil
import socket
import threading
import time

import numpy as np
import pytest

from areal_tpu_torch.base import name_resolve as tnr
from areal_tpu_torch.base import telemetry
from areal_tpu_torch.system import sample_spool as tss
from areal_tpu_torch.system import streams
from areal_tpu_torch.system.rollout_worker import ConsumedLog
from areal_tpu_torch.system.sample_spool import (
    SPOOL_KEY,
    SampleSpool,
    SpoolFull,
    SpoolIngest,
    SpoolSender,
    ack_channel_name,
)
from areal_tpu_torch.system.streams import (
    MasterRequestStream,
    Payload,
    TrajectoryPuller,
    TrajectoryPusher,
    WorkerRequestServer,
)

pytestmark = pytest.mark.durability

WAIT = 30.0  # bound on every wait of a test


@pytest.fixture()
def nr(tmp_path):
    old = tnr.DEFAULT_REPO
    tnr.DEFAULT_REPO = tnr.NfsNameRecordRepo(str(tmp_path / "nr"))
    yield tnr.DEFAULT_REPO
    tnr.DEFAULT_REPO = old


@pytest.fixture()
def counters():
    """Live counter snapshots from a private (push-less) telemetry sink."""
    from areal_tpu_torch.api.train_config import TelemetryConfig

    telemetry.shutdown()
    sink = telemetry.configure("e", "t", "test", 0,
                               TelemetryConfig(enabled=True), push=False)
    yield lambda: dict(sink.snapshot()["counters"])
    telemetry.shutdown()


def _segments(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".spool"))


# ---------------- SampleSpool: append, ack, watermark, GC, backpressure ----


def test_spool_append_ack_watermark(tmp_path):
    sp = SampleSpool(str(tmp_path / "sp"))
    assert [sp.append(f"r{i}".encode()) for i in range(5)] == [1, 2, 3, 4, 5]
    st = sp.stats()
    assert st.depth == 5 and st.acked_watermark == 0 and st.next_seqno == 6
    assert [s for s, _, _ in sp.pending()] == [1, 2, 3, 4, 5]
    assert [s for s, _, _ in sp.pending(after=3)] == [4, 5]
    # out-of-order acks move the watermark only contiguously
    assert sp.ack([3, 5]) == 2
    assert sp.stats().acked_watermark == 0 and sp.stats().depth == 3
    assert sp.ack([1, 2]) == 2
    assert sp.stats().acked_watermark == 3
    # re-acks and unknown seqnos do nothing
    assert sp.ack([1, 2, 3, 5, 99]) == 0
    assert sp.ack([4]) == 1
    assert sp.stats().acked_watermark == 5 and sp.stats().depth == 0
    sp.close()


def test_spool_segment_roll_and_gc(tmp_path):
    d = str(tmp_path / "sp")
    sp = SampleSpool(d, segment_bytes=96, max_bytes=1 << 20)
    for _ in range(10):
        sp.append(b"x" * 16)
    segs = _segments(d)
    assert len(segs) > 2
    before = sp.stats().bytes
    sp.ack(range(1, 8))
    assert len(_segments(d)) < len(segs)
    assert sp.stats().bytes < before
    # the unacked tail survives on disk and in memory
    assert [s for s, _, _ in sp.pending()] == [8, 9, 10]
    sp.close()


def test_spool_full_backpressure(tmp_path):
    sp = SampleSpool(str(tmp_path / "sp"), segment_bytes=128, max_bytes=128)
    sp.append(b"y" * 64)
    with pytest.raises(SpoolFull):
        sp.append(b"y" * 64)
    t = threading.Timer(0.1, lambda: sp.ack([1]))
    t.start()
    assert sp.wait_for_space(timeout=5.0)
    t.join()
    sp.append(b"y" * 64)  # the ack freed the space
    sp.close()


def test_spool_rejects_bad_caps(tmp_path):
    with pytest.raises(ValueError):
        SampleSpool(str(tmp_path / "a"), segment_bytes=0)
    with pytest.raises(ValueError):
        SampleSpool(str(tmp_path / "b"), segment_bytes=64, max_bytes=32)


# ---------------- SampleSpool: crash recovery ----------------


def test_spool_recover_preserves_unacked_and_seqnos(tmp_path):
    d = str(tmp_path / "sp")
    sp = SampleSpool(d, segment_bytes=96, max_bytes=1 << 20)
    for i in range(6):
        sp.append(f"rec{i}".encode())
    sp.ack([1, 2])
    sp.close()  # a crash: 3..6 stay unacked
    sp2 = SampleSpool(d, segment_bytes=96, max_bytes=1 << 20)
    assert [(s, raw) for s, _, raw in sp2.pending()] == [
        (3, b"rec2"), (4, b"rec3"), (5, b"rec4"), (6, b"rec5")]
    assert sp2.stats().acked_watermark == 2
    assert sp2.append(b"rec6") == 7  # seqnos go on, never reused
    sp2.close()


def test_spool_recover_truncates_torn_tail(tmp_path):
    d = str(tmp_path / "sp")
    sp = SampleSpool(d)
    for i in range(3):
        sp.append(f"payload-{i}".encode() * 4)
    sp.close()
    (seg,) = _segments(d)
    path = os.path.join(d, seg)
    with open(path, "rb+") as f:  # the last record loses its last bytes
        f.truncate(os.path.getsize(path) - 5)
    sp2 = SampleSpool(d)
    assert [s for s, _, _ in sp2.pending()] == [1, 2]
    # the torn bytes are gone, so an append cannot merge into them
    assert sp2.append(b"fresh") == 3
    sp2.close()
    sp3 = SampleSpool(d)
    assert [raw for _, _, raw in sp3.pending()] == [
        b"payload-0" * 4, b"payload-1" * 4, b"fresh"]
    sp3.close()


def test_spool_recover_crc_corruption_drops_from_bad_record(tmp_path):
    d = str(tmp_path / "sp")
    sp = SampleSpool(d)
    offs = []
    for i in range(4):
        offs.append(sp.stats().bytes)
        sp.append(f"record-{i}".encode())
    sp.close()
    (seg,) = _segments(d)
    path = os.path.join(d, seg)
    with open(path, "rb+") as f:  # flip one payload byte of record 3
        f.seek(offs[2] + 24)
        b = f.read(1)
        f.seek(offs[2] + 24)
        f.write(bytes([b[0] ^ 0xFF]))
    sp2 = SampleSpool(d)
    assert [s for s, _, _ in sp2.pending()] == [1, 2]
    assert os.path.getsize(path) == offs[2]
    sp2.close()


def test_spool_recover_gcs_fully_acked_segments(tmp_path):
    d = str(tmp_path / "sp")
    sp = SampleSpool(d, segment_bytes=64, max_bytes=1 << 20)
    for _ in range(6):
        sp.append(b"z" * 24)
    sp.close()
    # a crash between the watermark's write and the segments' delete
    with open(os.path.join(d, "acked"), "w") as f:
        f.write("4")
    sp2 = SampleSpool(d, segment_bytes=64, max_bytes=1 << 20)
    assert [s for s, _, _ in sp2.pending()] == [5, 6]
    # two 48-byte records a segment: the two wholly below the watermark
    # were deleted at recovery
    assert _segments(d) == [f"seg-{5:016d}.spool"]
    assert sp2.stats().acked_watermark == 4
    sp2.close()


# ---------------- the consumed log and the spool: crash ordering ----------

# A trajectory's commit is (1) fsync it into the spool, (2) fsync its uid into
# the ConsumedLog. The lost-sample state is consumed and not spooled (never
# generated again, and nothing to replay): no crash point may reach it.
CRASH_POINTS = ("before_spool", "mid_spool", "after_spool", "mid_consumed",
                "after_both")


def _tear_last_bytes(path, n=4):
    size = os.path.getsize(path)
    with open(path, "rb+") as f:
        f.truncate(max(size - n, 0))


def _commit(spool, consumed, uid, crash_at):
    if crash_at == "before_spool":
        return
    spool.append(uid.encode())
    if crash_at == "mid_spool":
        spool.close()
        seg = _segments(spool.dir)[-1]
        _tear_last_bytes(os.path.join(spool.dir, seg))
        return
    if crash_at == "after_spool":
        return
    consumed.add(uid)
    if crash_at == "mid_consumed":
        consumed.close()
        _tear_last_bytes(consumed.path, n=2)  # the newline and a character


@pytest.mark.parametrize("crash_at", CRASH_POINTS)
@pytest.mark.parametrize("n_prior", [0, 2])
def test_no_interleaving_reaches_consumed_but_not_spooled(tmp_path, crash_at,
                                                          n_prior):
    d = str(tmp_path)
    spool = SampleSpool(os.path.join(d, "spool_0"))
    consumed = ConsumedLog(d, 0)
    for i in range(n_prior):
        _commit(spool, consumed, f"prior{i}", crash_at="after_both")
    _commit(spool, consumed, "victim", crash_at=crash_at)
    spool.close()
    consumed.close()
    # recover as a respawned worker does
    spool2 = SampleSpool(os.path.join(d, "spool_0"))
    consumed2 = ConsumedLog(d, 0)
    spooled = {raw.decode() for _, _, raw in spool2.pending()}
    for uid in consumed2.seen:
        assert uid in spooled, (f"lost sample at {crash_at!r}: {uid} is "
                                "consumed but not spooled")
    assert {f"prior{i}" for i in range(n_prior)} <= spooled
    if crash_at in ("after_spool", "mid_consumed"):  # the safe direction
        assert "victim" in spooled and "victim" not in consumed2.seen
    spool2.close()
    consumed2.close()


def test_torn_tail_repair_parity(tmp_path):
    """Both logs repair a torn tail alike: exactly the torn record goes, and
    appends after the recovery do not merge into the fragment."""
    d = str(tmp_path)
    spool = SampleSpool(os.path.join(d, "spool_0"))
    consumed = ConsumedLog(d, 0)
    for i in range(3):
        spool.append(f"u{i}".encode())
        consumed.add(f"u{i}")
    spool.close()
    consumed.close()
    (seg,) = _segments(spool.dir)
    _tear_last_bytes(os.path.join(spool.dir, seg), n=1)
    _tear_last_bytes(consumed.path, n=1)
    spool2 = SampleSpool(os.path.join(d, "spool_0"))
    consumed2 = ConsumedLog(d, 0)
    assert {raw.decode() for _, _, raw in spool2.pending()} == {"u0", "u1"}
    assert consumed2.seen == {"u0", "u1"}
    spool2.append(b"u3")
    consumed2.add("u3")
    spool2.close()
    consumed2.close()
    spool3 = SampleSpool(os.path.join(d, "spool_0"))
    consumed3 = ConsumedLog(d, 0)
    assert {raw.decode() for _, _, raw in spool3.pending()} == {"u0", "u1",
                                                                 "u3"}
    assert consumed3.seen == {"u0", "u1", "u3"}
    spool3.close()
    consumed3.close()


# ---------------- the sender and its ack channel (TCP frames) --------------


def _pull_n(puller, n, deadline_secs=WAIT):
    got = []
    deadline = time.monotonic() + deadline_secs
    while len(got) < n and time.monotonic() < deadline:
        obj = puller.pull(timeout_ms=100)
        if obj is not None:
            got.append(obj)
    assert len(got) == n, f"pulled {len(got)}/{n}"
    return got


def _until(cond, secs=10.0):
    deadline = time.monotonic() + secs
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


def test_sender_ack_roundtrip_drains_spool(nr, tmp_path):
    trainer_pull = TrajectoryPuller("e", "t", "trainer")
    ack_pull = TrajectoryPuller("e", "t", ack_channel_name(0))
    pusher = TrajectoryPusher("e", "t", "trainer", timeout=10.0)
    acker = TrajectoryPusher("e", "t", ack_channel_name(0), timeout=10.0)
    spool = SampleSpool(str(tmp_path / "sp"))
    sender = SpoolSender(spool, pusher, ack_pull, worker_index=0,
                         resend_timeout_secs=60.0, poll_secs=0.01)
    sender.start()
    try:
        for i in range(5):
            sender.submit({"uid": f"s{i}", "x": [1, 2, i]})
        got = _pull_n(trainer_pull, 5)
        # each push carries (worker, seqno); first sends are not replays
        assert [o[SPOOL_KEY]["seq"] for o in got] == [1, 2, 3, 4, 5]
        assert all(o[SPOOL_KEY]["w"] == 0 for o in got)
        assert all("r" not in o[SPOOL_KEY] for o in got)
        assert [o["uid"] for o in got] == [f"s{i}" for i in range(5)]
        acker.push({"seqnos": [1, 2, 3, 4, 5]})
        assert _until(lambda: spool.stats().depth == 0)
    finally:
        sender.close(drain_secs=1.0)
        for s in (trainer_pull, ack_pull, pusher, acker):
            s.close()
    assert spool.stats().acked_watermark == 5
    assert not _segments(spool.dir)  # fully acked segments were deleted
    assert sender.counts["appended"] == sender.counts["acked"] == 5


def test_sender_resends_unacked_with_replay_flag(nr, tmp_path):
    trainer_pull = TrajectoryPuller("e", "t", "trainer")
    ack_pull = TrajectoryPuller("e", "t", ack_channel_name(1))
    pusher = TrajectoryPusher("e", "t", "trainer", timeout=10.0)
    acker = TrajectoryPusher("e", "t", ack_channel_name(1), timeout=10.0)
    spool = SampleSpool(str(tmp_path / "sp"))
    sender = SpoolSender(spool, pusher, ack_pull, worker_index=1,
                         resend_timeout_secs=0.2, poll_secs=0.01)
    sender.start()
    try:
        sender.submit({"uid": "only"})
        first, second = _pull_n(trainer_pull, 2)
        assert "r" not in first[SPOOL_KEY]
        # the lost-ack recovery is flagged for the trainer's staleness gate
        assert second[SPOOL_KEY] == {"w": 1, "seq": 1, "r": 1}
        acker.push({"seqnos": [1]})
        assert _until(lambda: spool.stats().depth == 0)
    finally:
        sender.close(drain_secs=1.0)
        for s in (trainer_pull, ack_pull, pusher, acker):
            s.close()
    assert sender.counts["resent"] >= 1


def test_sender_replays_spool_found_at_startup(nr, tmp_path, counters):
    # Incarnation 1 spools three trajectories and dies before any ack (a
    # submit needs no running thread: the durable append is all the rollout
    # loop depends on).
    spool = SampleSpool(str(tmp_path / "sp"))
    dead = SpoolSender(spool, None, None, worker_index=2)
    for i in range(3):
        dead.submit({"uid": f"crash{i}"})
    spool.close()
    trainer_pull = TrajectoryPuller("e", "t", "trainer")
    ack_pull = TrajectoryPuller("e", "t", ack_channel_name(2))
    pusher = TrajectoryPusher("e", "t", "trainer", timeout=10.0)
    spool2 = SampleSpool(str(tmp_path / "sp"))
    sender = SpoolSender(spool2, pusher, ack_pull, worker_index=2,
                         resend_timeout_secs=60.0, poll_secs=0.01)
    t0 = time.monotonic()
    sender.start()
    try:
        got = _pull_n(trainer_pull, 3)
        # replayed at once, not after the resend timeout, once each, flagged
        assert time.monotonic() - t0 < 30.0
        assert [o["uid"] for o in got] == ["crash0", "crash1", "crash2"]
        assert all(o[SPOOL_KEY].get("r") == 1 for o in got)
        assert _until(lambda: counters().get("spool/replayed", 0) >= 3)
        assert counters().get("spool/replayed") == 3
        assert sender.counts["replayed"] == 3
    finally:
        sender.close(drain_secs=0.0)
        for s in (trainer_pull, ack_pull, pusher):
            s.close()


# ---------------- SpoolIngest ----------------


def test_ingest_dedup_and_settlement():
    ing = SpoolIngest(staleness_limit=8)
    m = {"w": 0, "seq": 1}
    assert ing.observe("a", m, cur_version=0, sample_version=0.0) == (
        "ingest", None)
    # the original is still in the pipeline: a silent drop, no ack
    assert ing.observe("a", dict(m, r=1), 0, 0.0) == ("duplicate", None)
    assert ing.pop_settled(["a", "never-seen"]) == {0: [1]}
    # a replay of the settled sample (its ack was lost): ack at once
    assert ing.observe("a", dict(m, r=1), 0, 0.0) == ("duplicate", (0, 1))
    assert ing.pop_settled(["a"]) == {}
    assert ing.counts == {"ingest": 1, "duplicate": 2}


def test_ingest_staleness_gate_applies_to_replays_only():
    ing = SpoolIngest(staleness_limit=2)
    # a fresh push passed the manager's gate: never gated again here
    assert ing.observe("fresh", {"w": 0, "seq": 1}, 100, 0.0)[0] == "ingest"
    act, ackp = ing.observe("old", {"w": 1, "seq": 7, "r": 1}, 100, 0.0)
    assert (act, ackp) == ("stale", (1, 7))
    # a later re-send of the dropped record is acked again
    assert ing.observe("old", {"w": 1, "seq": 7, "r": 1}, 100, 0.0) == (
        "duplicate", (1, 7))
    assert ing.observe("young", {"w": 1, "seq": 8, "r": 1}, 100, 99.0) == (
        "ingest", None)
    ing2 = SpoolIngest(staleness_limit=-1)  # the gate off
    assert ing2.observe("old", {"w": 0, "seq": 1, "r": 1}, 100,
                        0.0)[0] == "ingest"


# ---------------- the buffer's duplicate skip ----------------


def _sample(sid):
    from areal_tpu_torch.api.data import SequenceSample

    return SequenceSample.from_default(
        ids=[sid], data={"packed_prompts": np.asarray([1, 2, 3], np.int32)},
        seqlens=[3])


def test_buffer_duplicate_put_is_idempotent_skip(counters):
    from areal_tpu_torch.system.buffer import AsyncSequenceBuffer

    async def main():
        buf = AsyncSequenceBuffer(n_rpcs_reading=1)
        await buf.put_batch([_sample("a")])
        await buf.put_batch([_sample("a")])  # a duplicate: no raise
        assert len(buf) == 1
        assert buf._slots["a"].reads_left == 1
        assert await buf.pop_freed() == []
        out = await buf.get_batch_for_rpc("rpc", set(), 1, timeout=5)
        assert [s.ids[0] for s in out] == ["a"]
        assert await buf.pop_freed() == ["a"]  # freed exactly once
        assert len(buf) == 0

    asyncio.run(main())
    assert counters().get("buffer/duplicate_dropped") == 1


# ---------------- a reply completes on its done flag ----------------


def test_gather_completes_on_none_output_reply(nr):
    server = WorkerRequestServer("e", "t", "w0")
    stream = MasterRequestStream("e", "t", ["w0"], timeout=10.0)
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            p = server.poll(timeout_ms=50)
            if p is not None:
                p.output = None  # a legitimate None result
                if p.handle_name == "fail":
                    p.exception = "boom"  # a worker-side error
                server.reply(p)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    try:
        rid = stream.post(Payload(handler="w0", handle_name="noop"))
        t0 = time.monotonic()
        (reply,) = stream.gather([rid], timeout=WAIT)
        assert time.monotonic() - t0 < 20.0
        assert reply.output is None and reply.done
        rid2 = stream.post(Payload(handler="w0", handle_name="fail"))
        with pytest.raises(RuntimeError, match="boom"):
            stream.gather([rid2], timeout=WAIT)
    finally:
        stop.set()
        th.join(timeout=5)
        stream.close()
        server.close()


# ---------------- the bounded push, and the bytes with durability off ------


def _full_pair():
    """A connected socket pair whose sending end's buffers are full (the
    other end never reads)."""
    a, b = socket.socketpair()
    a.setblocking(False)
    chunk = b"\0" * 65536
    while True:
        try:
            a.send(chunk)
        except BlockingIOError:
            break
    a.setblocking(True)
    return a, b


def test_push_blocked_bounded_and_counter(nr, counters):
    puller = TrajectoryPuller("e", "t", "sink")
    pusher = TrajectoryPusher("e", "t", "sink", timeout=10.0, block_secs=0.2)
    a, b = _full_pair()
    pusher._sock = a
    try:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            pusher.push({"x": 1})
        took = time.monotonic() - t0
        assert 0.15 <= took < 5.0  # bounded by block_secs
        assert counters().get("stream/push_blocked", 0) >= 1
        assert pusher._sock is None  # dropped: the next push reconnects
    finally:
        pusher.close()
        a.close()
        b.close()
        puller.close()


def _recv_all(sock, n_expected, secs=WAIT):
    out = b""
    deadline = time.monotonic() + secs
    while len(out) < n_expected and time.monotonic() < deadline:
        if select.select([sock], [], [], 0.1)[0]:
            out += sock.recv(1 << 20)
    return out


def test_wire_bytes_bit_identical_with_durability_off(nr):
    """With durability off a push carries no spool framing, and its bytes
    are what the parent's stream sends: one frame of the pickled dict
    (``_encode([pickle.dumps(obj)])``)."""
    telemetry.shutdown()  # no trace: inject_payload is the identity
    puller = TrajectoryPuller("e", "t", "sink2")
    pusher = TrajectoryPusher("e", "t", "sink2", timeout=10.0)
    a, b = socket.socketpair()
    pusher._sock = a
    try:
        obj = {"uid": "q1", "packed_input_ids": np.arange(4, dtype=np.int32)}
        parent = b"".join(bytes(m) for m in streams._encode(
            [pickle.dumps(obj)]))
        pusher.push(obj)
        wire = _recv_all(b, len(parent))
        assert wire == parent
        sent = streams.unpack(wire[12:])  # u32 count, u64 length, payload
        assert SPOOL_KEY not in sent and "_trace" not in sent
    finally:
        pusher.close()
        b.close()
        puller.close()


# ---------------- across the packages ----------------


def _ref():
    from areal_tpu.system import sample_spool as jss

    return jss


def _script(seed):
    """A seeded sequence of appends (payload, ts) and acks."""
    rng = random.Random(seed)
    ops, n = [], 0
    for _ in range(40):
        if rng.random() < 0.7 or n == 0:
            n += 1
            ops.append(("append", bytes(rng.randrange(256) for _ in range(
                rng.randint(0, 90))), 1.7e9 + rng.random() * 1e4))
        else:
            ops.append(("ack", sorted(rng.sample(range(1, n + 1),
                                                 rng.randint(1, min(n, 4))))))
    return ops


def _play(mod, d, ops, segment_bytes):
    sp = mod.SampleSpool(d, segment_bytes=segment_bytes, max_bytes=16 << 20)
    out = []
    for op in ops:
        if op[0] == "append":
            out.append(sp.append(op[1], ts=op[2]))
        else:
            out.append(sp.ack(op[1]))
    st = sp.stats()
    sp.close()
    return out, (st.depth, st.bytes, st.acked_watermark, st.next_seqno)


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("seed,segment_bytes", [(0, 96), (1, 256),
                                                (2, 8 << 20)])
def test_spool_files_byte_identical_to_reference(tmp_path, seed,
                                                  segment_bytes):
    ops = _script(seed)
    got = {}
    for pkg, mod in (("port", tss), ("ref", _ref())):
        d = str(tmp_path / pkg)
        got[pkg] = _play(mod, d, ops, segment_bytes) + (_files(d),)
    assert got["port"] == got["ref"]
    files = got["ref"][2]
    assert "acked" in files and any(n.endswith(".spool") for n in files)


def _corrupt(d, kind):
    seg = os.path.join(d, _segments(d)[-1])
    if kind == "torn":
        _tear_last_bytes(seg, n=3)
    elif kind == "crc":
        with open(seg, "rb+") as f:
            f.seek(24)  # the first record's first payload byte
            b = f.read(1)
            f.seek(24)
            f.write(bytes([b[0] ^ 0x5A]))


@pytest.mark.parametrize("kind", ["clean", "torn", "crc"])
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_each_package_recovers_the_others_spool(tmp_path, writer, kind):
    mods = {"port": tss, "ref": _ref()}
    reader = "ref" if writer == "port" else "port"
    src = str(tmp_path / "src")
    sp = mods[writer].SampleSpool(src, segment_bytes=200, max_bytes=1 << 20)
    for i in range(9):
        sp.append(f"traj-{i}".encode() * (i + 1), ts=1.7e9 + i)
    sp.ack([1, 2, 4])
    sp.close()
    _corrupt(src, kind)
    views = {}
    for pkg in (writer, reader):
        d = str(tmp_path / f"copy_{pkg}")
        shutil.copytree(src, d)
        sp = mods[pkg].SampleSpool(d, segment_bytes=200, max_bytes=1 << 20)
        st = sp.stats()
        views[pkg] = (sp.pending(), st.depth, st.bytes, st.acked_watermark,
                      st.next_seqno, sp.append(b"after", ts=1.8e9))
        sp.close()
        views[pkg] += (_files(d),)
    assert views[reader] == views[writer]
    pending = [s for s, _, _ in views[reader][0]]
    if kind == "clean":
        # seqno 4 was acked above the watermark, which alone is durable
        assert pending == [3, 4, 5, 6, 7, 8, 9]
    else:
        assert pending and pending[-1] < 9  # the damaged tail is gone


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ingest_decisions_match_reference(seed):
    rng = random.Random(seed)
    ings = {"port": SpoolIngest(staleness_limit=3),
            "ref": _ref().SpoolIngest(staleness_limit=3)}
    ids = [f"s{i}" for i in range(150)]
    script = []
    for step in range(300):
        if rng.random() < 0.2:
            script.append(("settle", rng.sample(ids, rng.randint(1, 5))))
        else:
            meta = {"w": rng.randrange(3), "seq": rng.randint(1, 400)}
            if rng.random() < 0.5:
                meta["r"] = 1
            script.append(("observe", rng.choice(ids), meta,
                           float(step // 20),
                           rng.choice([None, float(rng.randint(0, 15))])))
    got = {}
    for pkg, ing in ings.items():
        out = []
        for op in script:
            if op[0] == "settle":
                out.append(ing.pop_settled(op[1]))
            else:
                out.append(ing.observe(op[1], dict(op[2]), op[3], op[4]))
        got[pkg] = out
    assert got["port"] == got["ref"]
    kinds = {r[0] for r in got["ref"] if isinstance(r, tuple)}
    assert kinds == {"ingest", "duplicate", "stale"}


def test_durability_config_defaults_and_checks_match_reference():
    import dataclasses

    from areal_tpu.api import cli_args as jca
    from areal_tpu.api.train_config import DurabilityConfig as JDur
    from areal_tpu_torch.api import cli_args as tca
    from areal_tpu_torch.api.train_config import DurabilityConfig

    assert dataclasses.asdict(DurabilityConfig()) == dataclasses.asdict(JDur())
    bad = [{"spool_segment_bytes": 0}, {"spool_max_bytes": 1024},
           {"resend_timeout_secs": 0.0}, {"push_block_secs": 0.0}]
    for kw in bad:
        cfg = tca.BaseExperimentConfig(backend="cpu")
        cfg.durability = DurabilityConfig(enabled=True, **kw)
        with pytest.raises(tca.ConfigError, match="durability"):
            tca.validate_config(cfg)
        ref = jca.BaseExperimentConfig()
        ref.durability = JDur(enabled=True, **kw)
        with pytest.raises(jca.ConfigError, match="durability"):
            jca.validate_config(ref)
    cfg = tca.BaseExperimentConfig(backend="cpu")
    tca.apply_overrides(cfg, ["durability.enabled=true",
                              "durability.resend_timeout_secs=2"])
    tca.validate_config(cfg)
    assert cfg.durability.resend_timeout_secs == 2.0
