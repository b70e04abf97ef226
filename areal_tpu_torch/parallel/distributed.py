"""Multi-rank runtime: the process group's bootstrap and host broadcasts.

The port's counterpart of ``areal_tpu/parallel/distributed.py``
(``initialize:36``, ``broadcast_bytes:93``, ``broadcast_pyobj:113``,
``allgather_params:125``). The reference runs one process per host and
joins them into one JAX program; the port runs one process per device
(a rank) and joins them into one ``torch.distributed`` group:

 - rank 0 publishes ``ip:port`` under ``names.distributed_peer(...,
   "coordinator/<group>")`` and the others poll for it, as the reference
   does; every rank then calls ``init_process_group(init_method=
   "tcp://ip:port")``. The backend is NCCL on ``cuda`` and gloo on
   ``cpu``.
 - host objects (requests, batches) never ride CUDA tensors: they go over
   a second group on gloo (the world group itself when it is gloo).
 - control stays single-controller, as in the reference: rank 0 talks to
   the master and the streams and broadcasts each request, and the other
   ranks replay it in the same order (``system/trainer_worker.py``).
"""

from __future__ import annotations

import datetime
import pickle
import time
from typing import Any, Dict, Optional

from areal_tpu_torch.base import logging, name_resolve, names, network

logger = logging.getLogger("parallel.distributed")

_HOST_GROUP = None  # the gloo group host objects travel over


def coordinator_key(experiment: str, trial: str, group: str = "trainer") -> str:
    return names.distributed_peer(experiment, trial, f"coordinator/{group}")


# Collectives wait this long: a follower rank blocks in its next broadcast
# for as long as rank 0 waits for work (a launcher brings a group whose
# rank died down as a whole).
PG_TIMEOUT_SECS = 24 * 3600.0


def initialize(experiment: str, trial: str, process_id: int,
               num_processes: int, group: str = "trainer", device=None,
               timeout: float = 120.0, force: bool = False) -> bool:
    """Join the group's process group; returns whether one is up.

    A no-op at ``num_processes == 1`` (as the reference's), unless
    ``force``: a one-rank group still puts the mesh, the DTensor masters
    and their collectives on the path. ``device`` (cuda unless named)
    picks the backend: NCCL for ``cuda``, gloo for ``cpu``; with NCCL the
    rank is bound to that device. ``timeout`` bounds the wait for the
    coordinator's address. A second call is a no-op."""
    import torch.distributed as dist

    from areal_tpu_torch import resolve_device

    if dist.is_initialized():
        return True
    if num_processes <= 1 and not force:
        return False
    dev = resolve_device(device)
    key = coordinator_key(experiment, trial, group)
    if process_id == 0:
        addr = f"{network.gethostip()}:{network.find_free_port()}"
        name_resolve.add(key, addr, replace=True)
    else:
        deadline = time.monotonic() + timeout
        addr = None
        while time.monotonic() < deadline:
            try:
                addr = name_resolve.get(key)
                break
            except name_resolve.NameEntryNotFoundError:
                time.sleep(0.1)
        if addr is None:
            raise TimeoutError(f"no coordinator under {key}")
    init_group(addr, process_id, num_processes, dev)
    logger.info(f"process group up: rank {process_id}/{num_processes} "
                f"({dist.get_backend()}) coordinator {addr}")
    return True


def init_group(addr: str, rank: int, world: int, device,
               timeout: float = PG_TIMEOUT_SECS) -> None:
    """``init_process_group`` at ``tcp://<addr>`` (``ip:port``), NCCL on a
    ``cuda`` device (the rank bound to it) and gloo on ``cpu``, plus the
    gloo group host objects travel over."""
    import torch
    import torch.distributed as dist

    global _HOST_GROUP
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw: Dict[str, Any] = {}
    if backend == "nccl":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout), **kw)
    _HOST_GROUP = (dist.new_group(
        backend="gloo", timeout=datetime.timedelta(seconds=timeout))
        if backend != "gloo" else dist.group.WORLD)


def run_ranks(fn, world: int, *args, timeout: float = 120.0,
              device: str = "cpu") -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes joined
    into one process group over localhost; returns the results in rank
    order (``fn`` and its results must pickle). Raises with the traceback
    of a rank that failed. Every process is joined within ``timeout`` and
    terminated if still alive, so a hung collective cannot outlive the
    call. ``device`` is each rank's device (gloo on ``cpu``; two ranks on
    one card need gloo too, since NCCL refuses two ranks on one device)."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    addr = f"127.0.0.1:{network.find_free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, addr, device, q, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(results))} "
                                   f"did not finish within {timeout} s")
            try:
                r, ok, out = q.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = {i: p.exitcode for i, p in enumerate(procs)
                        if not p.is_alive() and i not in results}
                if dead and q.empty():
                    raise RuntimeError(f"ranks died without a result "
                                       f"(rank: exit code) {dead}")
                continue
            if not ok:
                raise RuntimeError(f"rank {r} failed:\n{out}")
            results[r] = out
    finally:
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
            if p.is_alive():
                p.terminate()
                p.join(5)
    return [results[r] for r in range(world)]


def _rank_main(fn, rank, world, addr, device, q, args):
    import faulthandler
    import traceback

    import torch

    faulthandler.enable()  # a crash in native code still names its frame
    torch.set_num_threads(1)  # several ranks share this host's cores
    try:
        if device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        # gloo even on a card: two ranks may share it
        init_group(addr, rank, world, "cpu")
        q.put((rank, True, fn(rank, world, *args)))
    except BaseException:  # noqa: BLE001 — reported to the caller
        q.put((rank, False, traceback.format_exc()))
    finally:
        shutdown()


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    import torch.distributed as dist

    global _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


def is_multiprocess() -> bool:
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_world_size() > 1


def rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def broadcast_bytes(data: Optional[bytes]) -> bytes:
    """A byte string from rank 0 to every rank, over the gloo group: the
    length first, then the bytes (the other ranks do not know the size)."""
    import torch
    import torch.distributed as dist

    if not is_multiprocess():
        return data  # type: ignore[return-value]
    src = dist.get_rank() == 0
    n = torch.tensor([len(data) if src and data is not None else 0],
                     dtype=torch.int64)
    dist.broadcast(n, 0, group=_HOST_GROUP)
    buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8) if src
           else torch.empty(int(n), dtype=torch.uint8))
    if int(n):
        dist.broadcast(buf, 0, group=_HOST_GROUP)
    return bytes(buf.numpy().tobytes())


def broadcast_pyobj(obj: Any) -> Any:
    """A pickled host object from rank 0 to every rank."""
    if not is_multiprocess():
        return obj
    import torch.distributed as dist

    data = pickle.dumps(obj) if dist.get_rank() == 0 else None
    return pickle.loads(broadcast_bytes(data))


def allgather_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Full host tensors of a state dict on every rank: each DTensor is
    gathered (``full_tensor()``), then copied to the CPU; plain tensors are
    copied as they are. Checkpoint and export paths call it on every rank
    and let rank 0 write."""
    from torch.distributed.tensor import DTensor

    out = {}
    for name, t in params.items():
        t = t.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        out[name] = t.cpu()
    return out
