"""The port's request fabric on the CPU: ``system/streams.py`` (the master's
request stream and the worker's server over ``system/frames.py``),
``system/worker_base.py`` (the control channel, heartbeats and leases),
``system/buffer.py`` and ``api/dfg.py``. The buffer and the graph run one
script of operations in both packages and must give the same sequences.
Every wait is bounded: a wedge fails the test instead of hanging it."""

import asyncio
import threading
import time

import numpy as np
import pytest

from areal_tpu_torch.base import name_resolve
from areal_tpu_torch.system.streams import (
    MasterRequestStream,
    Payload,
    WorkerRequestServer,
    req_reply_addr_key,
)
from areal_tpu_torch.system.worker_base import (
    HeartbeatThread,
    WorkerControl,
    WorkerControlPanel,
    WorkerState,
    read_heartbeats,
)

EXP, TRIAL = "fabric", "t0"
BOUND = 20.0  # seconds: the longest any test waits for a thread


@pytest.fixture
def port_nr(tmp_path):
    """The port's name_resolve on a fresh NFS root for one test."""
    old = name_resolve.DEFAULT_REPO
    name_resolve.DEFAULT_REPO = name_resolve.NfsNameRecordRepo(
        str(tmp_path / "nr"))
    yield name_resolve.DEFAULT_REPO
    name_resolve.DEFAULT_REPO = old


class _Worker:
    """A WorkerRequestServer served from a thread by ``handle(p, server)``,
    which either fills ``p`` and returns True (reply now) or keeps it and
    returns False (the handler replies later)."""

    def __init__(self, handle, handler="w"):
        self.server = WorkerRequestServer(EXP, TRIAL, handler)
        self.handle = handle
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            p = self.server.poll(timeout_ms=20)
            if p is not None and self.handle(p, self.server):
                self.server.reply(p)

    def close(self):
        self._stop.set()
        self._thread.join(BOUND)
        assert not self._thread.is_alive()
        self.server.close()


def _bounded(fn, *args):
    box = {}
    t = threading.Thread(target=lambda: box.update(out=fn(*args)),
                         daemon=True)
    t.start()
    t.join(BOUND)
    assert not t.is_alive(), f"{fn.__name__} wedged"
    return box["out"]


def test_gather_takes_replies_out_of_order(port_nr):
    held = []

    def handle(p, server):
        held.append(p)
        if len(held) == 3:  # answer the last request first
            for q in reversed(held):
                q.output = q.data * 10
                server.reply(q)
        return False

    w = _Worker(handle)
    m = MasterRequestStream(EXP, TRIAL, ["w"], timeout=BOUND)
    try:
        rids = [m.post(Payload(handler="w", handle_name="x", data=i))
                for i in range(3)]
        got = _bounded(m.gather, rids)
        assert [p.request_id for p in got] == rids
        assert [p.output for p in got] == [0, 10, 20]
        assert all(p.done for p in got)
    finally:
        m.close()
        w.close()


def test_a_none_output_reply_completes(port_nr):
    w = _Worker(lambda p, s: True)  # output stays None
    m = MasterRequestStream(EXP, TRIAL, ["w"], timeout=BOUND)
    try:
        assert _bounded(m.call, "w", "x") is None
    finally:
        m.close()
        w.close()


def test_a_worker_exception_raises(port_nr):
    def handle(p, server):
        p.exception = "boom: the handler failed"
        return True

    w = _Worker(handle)
    m = MasterRequestStream(EXP, TRIAL, ["w"], timeout=BOUND)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            m.call("w", "x")
    finally:
        m.close()
        w.close()


def test_gather_times_out(port_nr):
    w = _Worker(lambda p, s: False)  # never answers
    m = MasterRequestStream(EXP, TRIAL, ["w"], timeout=BOUND)
    try:
        rid = m.post(Payload(handler="w", handle_name="x"))
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            m.gather([rid], timeout=0.5)
        assert time.monotonic() - t0 < 5
    finally:
        m.close()
        w.close()


def test_concurrent_calls_never_wedge(port_nr):
    """8 threads share one stream, as the master's asyncio.to_thread
    workers do; every call gets its own reply."""

    def handle(p, server):
        p.output = p.data
        return True

    w = _Worker(handle)
    m = MasterRequestStream(EXP, TRIAL, ["w"], timeout=BOUND)
    results = {}

    def caller(k):
        results[k] = [m.call("w", "echo", (k, i)) for i in range(10)]

    threads = [threading.Thread(target=caller, args=(k,), daemon=True)
               for k in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(BOUND)
        assert not any(t.is_alive() for t in threads), "a caller wedged"
        assert results == {k: [(k, i) for i in range(10)] for k in range(8)}
    finally:
        m.close()
        w.close()


def test_close_withdraws_the_address(port_nr):
    key = req_reply_addr_key(EXP, TRIAL, "w")
    server = WorkerRequestServer(EXP, TRIAL, "w")
    assert name_resolve.get(key) == server._addr
    server.close()
    with pytest.raises(name_resolve.NameEntryNotFoundError):
        name_resolve.get(key)


def test_worker_control_through_the_panel(port_nr):
    """pause blocks the loop (commands are served meanwhile), resume lets
    it go on, status reports, a custom command runs, exit ends it."""
    counter = [0]
    checkpoints = []

    def loop():
        ctrl = WorkerControl(EXP, TRIAL, "w0")
        ctrl.on_command("checkpoint",
                        lambda payload: checkpoints.append(payload) or "saved")
        while True:
            ctrl.step(lambda: {"count": counter[0]}, timeout_ms=5)
            if ctrl.should_exit:
                break
            counter[0] += 1
        ctrl.close()

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    panel = WorkerControlPanel(EXP, TRIAL, timeout=BOUND)
    try:
        st = panel.status("w0")
        assert st["ok"] and st["state"] == WorkerState.RUNNING.value
        assert panel.pause("w0")["state"] == WorkerState.PAUSED.value
        frozen = panel.status("w0")["count"]
        time.sleep(0.1)
        assert panel.status("w0")["count"] == frozen
        r = panel.command("w0", "checkpoint", payload={"step": 3})
        assert r == {"ok": True, "result": "saved"}
        assert checkpoints == [{"step": 3}]
        assert not panel.command("w0", "no_such")["ok"]
        assert panel.resume("w0")["state"] == WorkerState.RUNNING.value
        deadline = time.monotonic() + BOUND
        while panel.status("w0")["count"] == frozen:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert panel.list_workers() == ["w0"]
        assert panel.exit("w0")["state"] == WorkerState.EXITING.value
        t.join(BOUND)
        assert not t.is_alive()
        assert panel.list_workers() == []
    finally:
        panel.close()


def test_a_heartbeat_renews_its_lease(port_nr):
    """A key registered with a 0.4 s lease outlives several TTLs while the
    heartbeat touches it, and lapses once the heartbeat stops; the
    heartbeat record names this process."""
    import os

    key = "fabric/t0/leased"
    name_resolve.add(key, "addr", keepalive_ttl=0.4)
    hb = HeartbeatThread(EXP, TRIAL, "w1", keys=[key], interval=0.1)
    try:
        time.sleep(1.2)
        assert name_resolve.get(key) == "addr"
        beats = read_heartbeats(EXP, TRIAL)
        assert beats["w1"]["pid"] == os.getpid()
        assert beats["w1"]["age_secs"] < 1.0
    finally:
        hb.close()
    time.sleep(0.8)
    with pytest.raises(name_resolve.NameEntryNotFoundError):
        name_resolve.get(key)
    assert "w1" not in read_heartbeats(EXP, TRIAL)


# --------------------------------------------- parity with the reference


def _buffer_script(pkg):
    """One script of buffer operations; returns what each step observed."""
    if pkg == "port":
        from areal_tpu_torch.api.data import SequenceSample
        from areal_tpu_torch.system.buffer import AsyncSequenceBuffer
    else:
        from areal_tpu.api.data import SequenceSample
        from areal_tpu.system.buffer import AsyncSequenceBuffer

    def sample(sid, **data):
        return SequenceSample.from_default(
            ids=[sid], seqlens=[3], data={k: np.asarray(v)
                                          for k, v in data.items()})

    async def run():
        buf = AsyncSequenceBuffer(n_rpcs_reading=3)
        log = []
        for i in range(6):  # one put per sample: birth order = id order
            await buf.put_batch([sample(f"s{i}", packed_prompts=[1, 2, 3])])
        await buf.put_batch([sample("s0", packed_prompts=[9, 9, 9])])  # dup
        got = await buf.get_batch_for_rpc("gen", {"packed_prompts"}, 4)
        log.append(("gen", [s.ids[0] for s in got]))
        # generate replaces 2 prompts with 2 trajectories of its own
        await buf.drop_ids(["s0", "s1"])
        await buf.put_batch([sample(f"t{i}", packed_input_ids=[4, 5, 6])
                             for i in range(2)])
        await buf.mark_read(["t0", "t1"], "gen")
        with pytest.raises(asyncio.TimeoutError):
            await buf.get_batch_for_rpc("rew", {"rewards"}, 1, timeout=0.05)
        got = await buf.get_batch_for_rpc("rew", {"packed_input_ids"}, 2)
        log.append(("rew", [s.ids[0] for s in got]))
        amend = SequenceSample.from_default(
            ids=["t1", "t0", "gone"], seqlens=[1, 1, 1],
            data={"rewards": np.zeros(3, np.float32)})
        await buf.amend_batch(amend)
        got = await buf.get_batch_for_rpc(
            "train", {"packed_input_ids", "rewards"}, 2)
        log.append(("train", [s.ids[0] for s in got],
                    [sorted(s.keys) for s in got]))
        log.append(("freed", await buf.pop_freed(), len(buf)))
        got = await buf.get_batch_for_rpc("rew", {"packed_prompts"}, 3)
        log.append(("rew2", [s.ids[0] for s in got]))
        log.append(("freed2", await buf.pop_freed(), len(buf)))
        return log

    return asyncio.run(run())


def test_buffer_matches_the_reference():
    assert _buffer_script("port") == _buffer_script("ref")


def _graph_script(pkg):
    if pkg == "port":
        from areal_tpu_torch.api import dfg
    else:
        from areal_tpu.api import dfg
    G, I, T = (dfg.MFCInterfaceType.GENERATE, dfg.MFCInterfaceType.INFERENCE,
               dfg.MFCInterfaceType.TRAIN_STEP)

    def node(name, model, itype, inputs, outputs, **kw):
        return dfg.MFCDef(name=name, model_name=model, interface_type=itype,
                          interface_impl=dfg.ModelInterfaceAbstraction("x"),
                          input_keys=tuple(inputs), output_keys=tuple(outputs),
                          **kw)

    nodes = [
        node("actor_gen", "actor", G, ["packed_prompts", "task_ids"],
             ["packed_input_ids", "packed_logprobs", "prompt_mask"]),
        node("rew_inf", "rw", I, ["packed_input_ids", "prompt_mask"],
             ["rewards"]),
        node("ref_inf", "ref", I, ["packed_input_ids"], ["ref_raw"],
             output_key_remap={"ref_raw": "packed_ref_logprobs"}),
        node("critic_inf", "critic", I, ["packed_input_ids"], ["values"]),
        node("actor_train", "actor", T,
             ["packed_input_ids", "packed_logprobs", "rewards", "values",
              "packed_ref_logprobs", "prompt_mask"], [],
             post_hooks=[dfg.WeightUpdateHook(role="actor")]),
        node("critic_train", "critic", T,
             ["packed_input_ids", "rewards", "values", "prompt_mask"], []),
    ]
    g = dfg.build_graph(nodes)
    out = [g.topological_order(), sorted(g.source_keys), sorted(g.model_names)]
    for name in sorted(g.nodes):
        n = g.nodes[name]
        out.append((name, sorted(n.parents), sorted(n.children), n.is_src,
                    n.is_dst, [type(h).__name__ for h in n.post_hooks]))
    for bad in ([node("a", "m", I, ["y"], ["x"]), node("b", "m", I, ["x"],
                                                        ["y"])],
                nodes + [node("rew2", "rw", I, ["packed_input_ids"],
                              ["rewards"])]):
        with pytest.raises(ValueError) as e:
            dfg.build_graph(bad)
        out.append(str(e.value))
    return out


def test_build_graph_matches_the_reference():
    assert _graph_script("port") == _graph_script("ref")
