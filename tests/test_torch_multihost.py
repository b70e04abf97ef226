"""The port's multi-rank runtime — twin of ``tests/test_multihost.py``.

Ranks are spawned processes joined over gloo on localhost (one rank per
device; here each "device" is the CPU). Each world size runs once for the
module and every case of that size reads its results:

 - ``parallel/distributed.py initialize`` finds rank 0 through name-resolve
   and ``broadcast_pyobj`` / ``broadcast_bytes`` carry host objects;
 - a PPO actor ``train_step`` at worlds 2 and 4 (``f2``, ``t2``, ``d2f2``,
   ``f2t2``) matches world 1's loss within 1e-5;
 - rank 0's checkpoints after ``allgather_params`` (the train state and
   the trainer's HF save) equal world 1's;
 - the launcher's GPU assignment (``derive_chip_assignment``).

The launcher's runs of several ranks are in
``tests/test_torch_multirank_launcher.py``.
"""

import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

from areal_tpu_torch.parallel import distributed as D

SPECS = {2: ("f2", "t2"), 4: ("d2f2", "f2t2")}


def _batch(seed=7, n_seq=16):
    from areal_tpu_torch.api.data import SequenceSample

    rng = np.random.RandomState(seed)
    plens, glens = rng.randint(3, 6, n_seq), rng.randint(4, 9, n_seq)
    seqlens = (plens + glens).astype(int)
    total = int(seqlens.sum())
    pmask = np.concatenate([np.r_[np.ones(p, np.int32), np.zeros(g, np.int32)]
                            for p, g in zip(plens, glens)])
    return SequenceSample.from_default(
        ids=[f"d{i}" for i in range(n_seq)],
        data={"packed_input_ids": rng.randint(2, 128, total).astype(np.int32),
              "prompt_mask": pmask,
              "packed_logprobs": np.where(pmask == 0, -1.0, 0.0
                                          ).astype(np.float32),
              "rewards": rng.rand(n_seq).astype(np.float32),
              "seq_no_eos_mask": np.zeros(n_seq, np.float32)},
        seqlens=seqlens.tolist())


def _train(spec, ckpt_dir):
    """One PPO actor step on ``spec``'s mesh (None: no mesh); then the
    train state and an HF save through the trainer, rank 0 writing."""
    from areal_tpu_torch.algorithms.ppo import (
        PPOActorInterface,
        PPOHyperparameters,
    )
    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.api.model import FinetuneSpec, Model, make_backend
    from areal_tpu_torch.api.train_config import OptimizerConfig
    from areal_tpu_torch.backend import torch_train  # noqa: F401 (registry)
    from areal_tpu_torch.models.config import tiny_config
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system.trainer_worker import (
        TrainerWorker,
        TrainerWorkerConfig,
    )

    cfg = tiny_config(vocab_size=128, use_attention_bias=True)
    model = make_backend(
        "torch_train", device="cpu", compute_dtype="float32",
        optimizer=OptimizerConfig(lr=1e-4, lr_scheduler_type="constant",
                                  warmup_steps_proportion=0.0),
        length_bucket=16, rows_bucket=2, seqs_bucket=4, parallel_spec=spec,
    ).initialize(Model("actor", (cfg, init_params(cfg, 0, device="cpu"))),
                 FinetuneSpec(1, 16, 8))
    iface = PPOActorInterface(PPOHyperparameters(
        ppo_n_minibatches=2, disable_value=True, kl_ctl=0.0))
    stats = iface.train_step(model, _batch(), MicroBatchSpec(
        max_tokens_per_mb=48))
    model.module.save_train_state(os.path.join(ckpt_dir, "state"))
    rank = D.rank()
    w = TrainerWorker(TrainerWorkerConfig(
        device="cpu", dist_rank=rank,
        dist_world=torch.distributed.get_world_size()
        if torch.distributed.is_initialized() else 1))
    w.models["actor"] = model
    w._save_role("actor", os.path.join(ckpt_dir, "hf"))
    return stats


def _rank_steps(rank, world, specs, root):
    out = {}
    for spec in specs:
        d = os.path.join(root, f"w{world}_{spec}")
        out[spec] = _train(spec, d)
    out["bcast"] = (D.broadcast_pyobj({"seed": 7} if rank == 0 else None),
                    D.broadcast_bytes(b"abc" * 1000 if rank == 0 else None),
                    D.is_multiprocess())
    return out


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("multihost"))


@pytest.fixture(scope="module")
def world1(root):
    d = os.path.join(root, "w1")
    return _train(None, d)


@pytest.fixture(scope="module")
def world2(root):
    return D.run_ranks(_rank_steps, 2, SPECS[2], root, timeout=240)


@pytest.fixture(scope="module")
def world4(root):
    return D.run_ranks(_rank_steps, 4, SPECS[4], root, timeout=240)


CASES = [(2, s) for s in SPECS[2]] + [(4, s) for s in SPECS[4]]


@pytest.mark.parametrize("world,spec", CASES)
def test_multi_rank_ppo_step_matches_world_1(request, world1, world, spec):
    res = request.getfixturevalue(f"world{world}")
    for r in range(world):  # every rank reports the same stats
        got = res[r][spec]
        assert got["actor_loss"] == pytest.approx(world1["actor_loss"],
                                                  abs=1e-5, rel=1e-5)
        assert got["n_ppo_steps"] == world1["n_ppo_steps"] == 2.0
        assert got["grad_norm"] == pytest.approx(world1["grad_norm"],
                                                 rel=1e-5)


@pytest.mark.parametrize("world,spec", CASES)
def test_rank0_checkpoints_equal_world_1(request, root, world1, world, spec):
    from areal_tpu_torch.base import safetensors_io as sio
    from areal_tpu_torch.models import hf

    request.getfixturevalue(f"world{world}")
    one, many = os.path.join(root, "w1"), os.path.join(root,
                                                        f"w{world}_{spec}")
    for f in ("params.safetensors", "opt_state.safetensors"):
        want = sio.load_file(os.path.join(one, "state", f))
        got = sio.load_file(os.path.join(many, "state", f))
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=0,
                                       msg=k)
    _, want = hf.load_hf_checkpoint(os.path.join(one, "hf"), device="cpu")
    _, got = hf.load_hf_checkpoint(os.path.join(many, "hf"), device="cpu")
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=0, msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_broadcasts_reach_every_rank(request, world):
    res = request.getfixturevalue(f"world{world}")
    for r in range(world):
        obj, data, multi = res[r]["bcast"]
        assert obj == {"seed": 7} and data == b"abc" * 1000 and multi


def _initialize(rank, nr_root, q):
    from areal_tpu_torch.base import name_resolve

    name_resolve.DEFAULT_REPO = name_resolve.NfsNameRecordRepo(nr_root)
    try:
        up = D.initialize("mh", "t", rank, 2, group="test", device="cpu",
                          timeout=60)
        obj = D.broadcast_pyobj({"batch_seed": 7} if rank == 0 else None)
        addr = name_resolve.get(D.coordinator_key("mh", "t", "test"))
        q.put((rank, (up, obj, torch.distributed.get_world_size(), addr)))
    except BaseException as e:  # noqa: BLE001 — reported to the test
        q.put((rank, repr(e)))
    finally:
        D.shutdown()


def test_initialize_through_name_resolve(tmp_path):
    """Rank 0 publishes its coordinator address under name-resolve, rank 1
    finds it there; both join and see rank 0's broadcast."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_initialize, args=(r, str(tmp_path), q),
                         daemon=True) for r in (1, 0)]
    for p in procs:
        p.start()
    try:
        out = dict(q.get(timeout=120) for _ in procs)
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.terminate()
    for r in (0, 1):
        up, obj, world, addr = out[r]
        assert up and obj == {"batch_seed": 7} and world == 2
        assert addr.count(":") == 1
    assert D.initialize("mh", "t", 0, 1) is False  # world 1: no group
    assert not torch.distributed.is_initialized()


def test_chip_assignment_math():
    from areal_tpu_torch.apps.launcher import derive_chip_assignment

    assert derive_chip_assignment("", 4) == {
        "trainer": [0, 1, 2, 3], "gen": []}
    assert derive_chip_assignment("d2t2", 4) == {
        "trainer": [0, 1, 2, 3], "gen": []}
    asg = derive_chip_assignment("gen.d2+d2t2", 8)
    assert asg == {"trainer": [0, 1, 2, 3], "gen": [4, 5]}
    assert not set(asg["trainer"]) & set(asg["gen"])
    with pytest.raises(RuntimeError, match="1 trainer \\+ 1 generation"):
        derive_chip_assignment("gen.d1+d1", 1)


def test_allocation_and_trainer_ranks_must_agree():
    """The trainer's ranks are the world of its allocation spec (the
    reference's ``trainer_dist_procs``, derived in the port and refused as
    a key); trainer specs of different worlds raise."""
    from areal_tpu_torch.api.cli_args import (
        BaseExperimentConfig,
        ConfigError,
        apply_overrides,
    )
    from areal_tpu_torch.experiments import common as C

    cfg = BaseExperimentConfig(backend="cpu", allocation_mode="f2t2",
                               n_gpus_per_node=4)
    assert C.trainer_world(C.resolve_allocation(cfg)) == 4
    assert C.trainer_world(C.resolve_allocation(
        BaseExperimentConfig(backend="cpu"))) == 1
    cfg.allocation_mode = "actor_train:f2t2,ref_inf:d2"
    with pytest.raises(ValueError, match="span \\[2, 4\\] devices"):
        C.resolve_allocation(cfg)
    with pytest.raises(ConfigError, match="unknown config key "
                       "'trainer_dist_procs'"):
        apply_overrides(BaseExperimentConfig(), ["trainer_dist_procs=2"])
    if not torch.cuda.is_available():
        cfg = BaseExperimentConfig(allocation_mode="f2", n_gpus_per_node=2)
        with pytest.raises(ValueError, match="needs 2 GPUs .* 0 are visible"):
            C.resolve_allocation(cfg)
