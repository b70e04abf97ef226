"""The durable spool across a trainer SIGKILL and the relaunch.

The tier-1 twin of ``tests/test_durability_e2e.py:290``
(``test_trainer_sigkill_replays_spool_no_sample_loss``), on the port alone
at ``tiny_config`` size on the CPU: ``run_experiment`` with
``durability.enabled``, ``recover_mode=auto`` and a recover checkpoint every
step. Once step 1's checkpoint is in, the trainer is SIGKILLed; the
supervisor escalates, the experiment relaunches from the checkpoint, the
relaunched rollout worker replays what its spool still held, and the run
completes. Then, from what is on disk:

 - on the rollout worker, ``appended == acked watermark + depth``: no
   spooled trajectory vanished;
 - every sample of every prompt in the consumed log was settled by a
   trainer (trained, or durably dropped as stale) or is still in the spool,
   waiting for the next incarnation;
 - no prompt was consumed twice, and the relaunched worker replayed.

Every wait is bounded and every spawned process is joined or terminated.
"""

import functools
import glob
import json
import os
import signal
import threading
import time

import pytest

from areal_tpu_torch.base import name_resolve as tnr

pytestmark = [pytest.mark.durability, pytest.mark.chaos]

EXP, TRIAL = "torchdur", "t0"
STEPS = 4
WAIT_SECS = 50.0


def _trainer_probe(out_dir, worker):
    """Append every sample id the trainer settles (its ack point) or drops
    as stale to a file of this process, as it happens: a killed trainer
    keeps what it settled before the kill."""
    from areal_tpu_torch.system import sample_spool

    path = os.path.join(out_dir, f"settled_{os.getpid()}.txt")
    pop, observe = (sample_spool.SpoolIngest.pop_settled,
                    sample_spool.SpoolIngest.observe)

    def write(kind, sids):
        with open(path, "a") as f:
            for sid in sids:
                f.write(f"{kind} {sid}\n")
            f.flush()

    def pop_settled(ing, sample_ids):
        with ing._lock:
            settled = [s for s in sample_ids if s in ing._pending]
        out = pop(ing, sample_ids)
        write("trained", settled)
        return out

    def observing(ing, sample_id, meta, cur, ver):
        verdict = observe(ing, sample_id, meta, cur, ver)
        if verdict[0] == "stale":
            write("stale", [sample_id])
        return verdict

    sample_spool.SpoolIngest.pop_settled = pop_settled
    sample_spool.SpoolIngest.observe = observing


def _rollout_probe(out_dir, worker):
    def done():
        with open(os.path.join(out_dir, f"rollout_{os.getpid()}.json"),
                  "w") as f:
            json.dump(dict(worker._sender.counts), f)
    return done


def test_trainer_sigkill_relaunch_loses_no_sample(tmp_path, monkeypatch):
    from areal_tpu_torch.apps import launcher as L
    from areal_tpu_torch.base import recover
    from areal_tpu_torch.experiments import common as C
    from areal_tpu_torch.system.sample_spool import SampleSpool
    from areal_tpu_torch.system.streams import unpack
    from test_torch_supervised_loop import _config

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    old_repo = tnr.DEFAULT_REPO
    out_dir = str(tmp_path / "probe")
    os.makedirs(out_dir)
    cfg = _config(tmp_path, EXP, STEPS, [
        "recover_mode=auto", "exp_ctrl.ckpt_freq_steps=1",
        "durability.enabled=true", "durability.resend_timeout_secs=2",
        "durability.drain_timeout_secs=1",
        "fault_tolerance.relaunch_backoff_secs=0.2"])
    recover_dir = C.experiment_paths(cfg)["recover"]
    probes = {"trainer": functools.partial(_trainer_probe, out_dir),
              "rollout": functools.partial(_rollout_probe, out_dir)}
    launchers = []
    base = L.LocalLauncher

    class Recorded(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            launchers.append(self)

    monkeypatch.setattr(L, "LocalLauncher", Recorded)
    box = {}

    def run():
        try:
            box["result"] = L.run_experiment(cfg, probes=probes)
        except BaseException as e:  # noqa: BLE001 — asserted below
            box["error"] = e

    t0 = time.monotonic()
    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        deadline = t0 + WAIT_SECS
        while True:  # step 1 committed: a recover checkpoint exists
            info = recover.load(recover_dir)
            if info is not None and info.last_step_info.global_step >= 1:
                break
            assert time.monotonic() < deadline and th.is_alive(), \
                f"no checkpoint of step 1: {box.get('error')!r}"
            time.sleep(0.05)
        trainer = launchers[0].supervisor.entry("trainer").proc
        os.kill(trainer.pid, signal.SIGKILL)
        th.join(max(deadline - time.monotonic(), 1.0))
        assert not th.is_alive(), "the relaunched run did not finish"
    finally:
        if th.is_alive():
            launchers[-1].request_drain()
            th.join(20)
        for la in launchers:
            if la.supervisor is not None:
                la.supervisor.shutdown(timeout=5.0, orderly=False)
        tnr.DEFAULT_REPO = old_repo
    assert "error" not in box, box.get("error")
    assert box["result"]["steps"] == STEPS
    assert len(launchers) == 2  # the SIGKILL escalated to one relaunch
    assert not any(p.is_alive() for la in launchers for p in la.procs)
    assert time.monotonic() - t0 < 60.0

    spool = SampleSpool(os.path.join(recover_dir, "spool_0"))
    st = spool.stats()
    pending_ids = {unpack(raw)["ids"][0] for _, _, raw in spool.pending()}
    spool.close()
    assert st.next_seqno - 1 == st.acked_watermark + st.depth  # none lost
    assert st.acked_watermark > 0
    settled = {}
    for path in glob.glob(os.path.join(out_dir, "settled_*.txt")):
        with open(path) as f:
            for line in f:
                kind, sid = line.split()
                settled[sid] = kind
    assert len(glob.glob(os.path.join(out_dir, "settled_*.txt"))) == 2
    with open(os.path.join(recover_dir, "rollout_consumed_0.log")) as f:
        consumed = [ln.strip() for ln in f if ln.strip()]
    assert consumed and len(consumed) == len(set(consumed))
    for uid in consumed:
        for j in range(2):  # group_size
            sid = f"{uid}@{j}"
            assert sid in settled or sid in pending_ids, \
                f"{sid} was consumed but neither trained nor spooled"
    counts = []
    for path in glob.glob(os.path.join(out_dir, "rollout_*.json")):
        with open(path) as f:
            counts.append(json.load(f))
    assert len(counts) == 2  # both incarnations exited cleanly
    assert sum(c.get("replayed", 0) for c in counts) >= 1
    assert sum(c.get("appended", 0) for c in counts) == st.next_seqno - 1
