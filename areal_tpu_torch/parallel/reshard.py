"""Layout-to-layout moves of a state dict, and the ``device`` weight-sync
transport.

The port's counterpart of ``areal_tpu/parallel/reshard.py``: one
resharding core (``plan_reshard:129``, ``reshard_pytree:224``,
``reshard_via_host:265``), spent by the trainer's ``param_realloc`` hook,
and the ``device`` transport (``publish_device`` / ``consume_device``,
the manifest and its digest, latest-wins). The port's generation servers
hold whole tensors on one device each, so a publication is packed as the
trainer gathers it and does not go through the core: the reference's
reshard into a meshed fleet's layout comes with such a fleet.

Layouts. A target layout is a ``torch.device`` (the whole tensor on that
device: what an un-meshed generation server holds) or a ``(mesh,
placements)`` pair (a DTensor on a ``parallel/mesh.py`` mesh). A
:class:`ReshardPlan` passes leaves already in their target layout through
untouched (no copy) and batches the rest into transfer groups of at most
``group_mb``; each group is moved (``redistribute``, ``full_tensor`` or
``distribute_tensor``) and synchronized before the next, so the extra
device memory of a move stays about one group.

The ``device`` transport. The reference's trainer and servers share one
JAX runtime and hand the published tree over through an in-process
registry. The port's trainer and servers are separate processes on one
card, so the publication crosses processes (an accepted difference):

 - ``publish_device`` packs the compute-dtype leaves into **one**
   contiguous device buffer per publication (one IPC open for the
   consumer, not one per leaf), takes that buffer's CUDA IPC handles
   (``UntypedStorage._share_cuda_``, one share each) and writes ``{pid,
   version, digest, shares, claims, manifest, offsets}`` under
   ``names.weight_device`` (the reference writes ``{pid, version,
   digest}``);
 - ``consume_device`` runs the reference's gates (missing publication,
   version skew, digest, tree, shape) and one more, a dead publisher
   (found by pid); it then opens the handle, copies the buffer device to
   device in one copy (the server's shadow weights are views into it,
   cast where the live dtype differs), checks
   that the record it read still stands (a republish during the copy
   fails the consume rather than hand over a torn tree), and releases the
   mapping;
 - latest-wins keeps one slot per role in the publishing process: a new
   publication replaces the old, whose buffer is then freed once no
   consumer holds it. torch's CUDA IPC reference counting keeps one count
   per share, released by one consumer's mapping, so the publisher takes
   several shares (twice the registered servers, plus two) and each
   consumer claims one of its own (an exclusive file in the
   publication's claims directory); when the publication is dropped, the
   publisher claims every share left and releases its count, so the
   buffer goes exactly when the last consumer that took a share lets its
   mapping go, none or several;
 - on CPU tensors, which only the tests use, the same code shares the
   buffer through a named shared-memory file (``UntypedStorage.from_file``
   with ``shared=True``) in place of the IPC handle.

No gate falls back to another transport: a failed gate raises
:class:`DeviceReshardError`, which the generation server answers with 500
while it keeps its old weights.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import logging
import os
import shutil
import tempfile
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import torch

logger = logging.getLogger("reshard")

# Default transfer-group byte budget (the reference's DEFAULT_GROUP_MB).
DEFAULT_GROUP_MB = 64
# Leaf offsets in a packed publication are multiples of this.
_ALIGN = 256


class DeviceReshardError(RuntimeError):
    """A device-transport publication could not be consumed (missing,
    version skew, digest mismatch, tree mismatch, or a dead publisher).
    The generation server answers 500 and keeps its old weights."""


# ---------------- layouts ----------------


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _leaf_nbytes(leaf: torch.Tensor) -> int:
    return leaf.numel() * leaf.element_size()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def layout_of(leaf: torch.Tensor):
    """A leaf's live layout: ``(mesh, placements)`` for a DTensor, else its
    device."""
    if _is_dtensor(leaf):
        return (leaf.device_mesh, tuple(leaf.placements))
    return leaf.device


def _as_device(dst) -> torch.device:
    """``dst`` as a device; ``cuda`` without an index is the current one."""
    dev = torch.device(dst)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _equivalent(leaf: torch.Tensor, dst) -> bool:
    if isinstance(dst, tuple):
        return (_is_dtensor(leaf) and leaf.device_mesh == dst[0]
                and tuple(leaf.placements) == tuple(dst[1]))
    return not _is_dtensor(leaf) and leaf.device == _as_device(dst)


def _move(leaf: torch.Tensor, dst) -> torch.Tensor:
    """One leaf into layout ``dst``."""
    from torch.distributed.tensor import distribute_tensor

    leaf = leaf.detach()
    if isinstance(dst, tuple):
        mesh, placements = dst
        if _is_dtensor(leaf) and leaf.device_mesh == mesh:
            return leaf.redistribute(mesh, placements)
        whole = leaf.full_tensor() if _is_dtensor(leaf) else leaf
        dev = (torch.device("cuda", torch.cuda.current_device())
               if mesh.device_type == "cuda" else torch.device("cpu"))
        return distribute_tensor(whole.to(dev), mesh, placements,
                                 src_data_rank=None)
    whole = leaf.full_tensor() if _is_dtensor(leaf) else leaf
    return whole.to(_as_device(dst), copy=True)


def _sync(tensors) -> None:
    devs = {t.device for t in tensors
            if not _is_dtensor(t) and t.device.type == "cuda"}
    devs |= {torch.device("cuda", torch.cuda.current_device())
             for t in tensors if _is_dtensor(t)
             and t.device_mesh.device_type == "cuda"}
    for d in devs:
        torch.cuda.synchronize(d)


# ---------------- plan ----------------


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    """Per-leaf decisions for one move: ``identical`` leaves are already in
    their target layout and pass through with no copy; ``groups`` batch the
    rest so that each move-then-synchronize cycle stages at most about
    ``group_bytes`` of new buffers."""

    identical: Tuple[str, ...]
    groups: Tuple[Tuple[str, ...], ...]
    moved_bytes: int
    total_bytes: int
    group_bytes: int

    @property
    def n_moved(self) -> int:
        return sum(len(g) for g in self.groups)

    def describe(self) -> Dict[str, Any]:
        return {"identical": len(self.identical), "moved": self.n_moved,
                "groups": len(self.groups), "moved_bytes": self.moved_bytes,
                "total_bytes": self.total_bytes}


def plan_reshard(flat_src: Dict[str, torch.Tensor], flat_dst: Dict[str, Any],
                 group_bytes: int = DEFAULT_GROUP_MB << 20) -> ReshardPlan:
    """The per-leaf plan from live tensors to target layouts. The names
    must match exactly: a reshard never invents or drops tensors."""
    if set(flat_src) != set(flat_dst):
        missing = sorted(set(flat_src) ^ set(flat_dst))
        raise ValueError(
            f"reshard plan: source/target trees differ on {len(missing)} "
            f"leaves (e.g. {missing[:3]})")
    identical: List[str] = []
    moves: List[Tuple[str, int]] = []
    moved_bytes = total_bytes = 0
    for name in sorted(flat_src):
        leaf = flat_src[name]
        nbytes = _leaf_nbytes(leaf)
        total_bytes += nbytes
        if _equivalent(leaf, flat_dst[name]):
            identical.append(name)
        else:
            moves.append((name, nbytes))
            moved_bytes += nbytes
    groups: List[Tuple[str, ...]] = []
    cur: List[str] = []
    cur_bytes = 0
    for name, nbytes in moves:
        if cur and cur_bytes + nbytes > group_bytes:
            groups.append(tuple(cur))
            cur, cur_bytes = [], 0
        cur.append(name)
        cur_bytes += nbytes
    if cur:
        groups.append(tuple(cur))
    return ReshardPlan(identical=tuple(identical), groups=tuple(groups),
                       moved_bytes=moved_bytes, total_bytes=total_bytes,
                       group_bytes=group_bytes)


# ---------------- execute ----------------


def execute_reshard(flat_src: Dict[str, torch.Tensor],
                    flat_dst: Dict[str, Any],
                    plan: Optional[ReshardPlan] = None
                    ) -> Dict[str, torch.Tensor]:
    """Run ``plan`` (computed if None): identical leaves come back as the
    same tensor objects; moved leaves in their target layout, group by
    group, each group synchronized before the next."""
    if plan is None:
        plan = plan_reshard(flat_src, flat_dst)
    out = {name: flat_src[name] for name in plan.identical}
    for group in plan.groups:
        moved = {n: _move(flat_src[n], flat_dst[n]) for n in group}
        _sync(moved.values())
        out.update(moved)
    return out


def reshard_pytree(params: Dict[str, torch.Tensor], dst_layouts: Dict[str, Any],
                   group_mb: int = DEFAULT_GROUP_MB
                   ) -> Tuple[Dict[str, torch.Tensor], ReshardPlan]:
    """A state dict moved into ``dst_layouts`` (a matching dict of
    layouts); returns ``(new, plan)``. Leaves already in place pass through
    with no copy."""
    plan = plan_reshard(params, dst_layouts, group_bytes=group_mb << 20)
    return execute_reshard(params, dst_layouts, plan), plan


def reshard_via_host(params: Dict[str, torch.Tensor],
                     dst_layouts: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The host path: every leaf gathered whole to the CPU, then placed in
    its target layout (the oracle the device path is tested against)."""
    if set(params) != set(dst_layouts):
        raise ValueError("reshard_via_host: source/target trees differ")
    out = {}
    for name, leaf in params.items():
        whole = leaf.detach()
        whole = (whole.full_tensor() if _is_dtensor(whole) else whole).cpu()
        out[name] = _move(whole, dst_layouts[name])
    return out


def model_shardings(mesh, model_cfg):
    """The canonical layout of a model on ``mesh``: the placements training
    uses (``parallel/sharding.py``), as ``(mesh, placements)`` per name.
    (The reference's ``mesh=None``, one device, is a ``torch.device``
    here.)"""
    from areal_tpu_torch.parallel import sharding as psh

    specs = psh.param_partition_specs(model_cfg, psh.mesh_degree(mesh, "tp"))
    return {n: (mesh, pl) for n, pl in specs.items()}


def shardings_like(params: Dict[str, torch.Tensor], target) -> Dict[str, Any]:
    """``target`` (one layout, or a dict of them) as a dict matching
    ``params`` name for name."""
    if isinstance(target, dict):
        return target
    return {n: target for n in params}


def shardings_of(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The live layout of every leaf: the target for "move into whatever
    this consumer already holds"."""
    return {n: layout_of(t) for n, t in params.items()}


# ---------------- the device transport ----------------


@dataclasses.dataclass
class DevicePublication:
    role: str
    version: int
    buffer: torch.Tensor  # uint8, every leaf packed at its offset
    manifest: List[Dict[str, Any]]  # name/shape/dtype/nbytes per leaf
    offsets: Dict[str, int]
    digest: str
    publish_secs: float
    record: Dict[str, Any]
    path: Optional[str] = None  # the shared-memory file (CPU buffers)
    claims: Optional[str] = None  # the directory consumers claim shares in


_REGISTRY: Dict[Tuple[str, str, str], DevicePublication] = {}
# The last consume's legs in this process (seconds): opening the buffer,
# and the device-to-device copy with its casts (synchronized).
LAST_CONSUME: Dict[str, float] = {}


def build_manifest(flat: Dict[str, torch.Tensor]) -> List[Dict[str, Any]]:
    return [{"name": name, "shape": list(flat[name].shape),
             "dtype": _dtype_name(flat[name].dtype),
             "nbytes": _leaf_nbytes(flat[name])}
            for name in sorted(flat)]


def manifest_digest(manifest: List[Dict[str, Any]], version: int) -> str:
    blob = json.dumps({"version": version, "tensors": manifest},
                      sort_keys=True, separators=(",", ":"))
    return f"{zlib.crc32(blob.encode()):08x}"


def _b64(b: Optional[bytes]) -> Optional[str]:
    return None if b is None else base64.b64encode(b).decode()


def _unb64(s: Optional[str]) -> Optional[bytes]:
    return None if s is None else base64.b64decode(s)


def _share(buffer: torch.Tensor) -> Dict[str, Any]:
    """The CUDA IPC handle of ``buffer``'s storage, JSON-ready."""
    (dev, handle, size, offset, rc, rc_offset, event,
     event_sync) = buffer.untyped_storage()._share_cuda_()
    return {"kind": "cuda_ipc", "device": dev, "handle": _b64(handle),
            "storage_bytes": size, "storage_offset": offset,
            "ref_counter": _b64(rc), "ref_counter_offset": rc_offset,
            "event": _b64(event), "event_sync": event_sync,
            "tensor_offset": buffer.storage_offset(),
            "nbytes": buffer.numel()}


def _open(handle: Dict[str, Any]) -> torch.Tensor:
    """The publication's buffer (uint8) mapped into this process."""
    if handle["kind"] == "file":
        nbytes = handle["nbytes"]
        # from_file(shared=True) would create a missing file: check first
        if os.stat(handle["path"]).st_size < nbytes:
            raise ValueError(f"{handle['path']} is shorter than {nbytes} B")
        st = torch.UntypedStorage.from_file(handle["path"], True, nbytes)
        return torch.empty(0, dtype=torch.uint8).set_(st, 0, (nbytes,))
    from torch.multiprocessing.reductions import rebuild_cuda_tensor

    return rebuild_cuda_tensor(
        torch.Tensor, (handle["nbytes"],), (1,), handle["tensor_offset"],
        torch.UntypedStorage, torch.uint8, handle["device"],
        _unb64(handle["handle"]), handle["storage_bytes"],
        handle["storage_offset"], False, _unb64(handle["ref_counter"]),
        handle["ref_counter_offset"], _unb64(handle["event"]),
        handle["event_sync"])


def _leaf_view(buffer: torch.Tensor, offset: int, entry: Dict[str, Any]
               ) -> torch.Tensor:
    dtype = getattr(torch, entry["dtype"])
    return buffer[offset:offset + entry["nbytes"]].view(dtype).view(
        entry["shape"])


def _claim(claims: str, i: int) -> bool:
    """Take share ``i`` of a publication (an exclusive create); False when
    another process took it. FileNotFoundError: the publication is gone."""
    try:
        os.close(os.open(os.path.join(claims, str(i)),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        return True
    except FileExistsError:
        return False


def _give_back(share: Dict[str, Any]) -> None:
    """Release the count of a claimed share that was never opened, as the
    consumer's mapping would have (best effort: a dead publisher's
    counters are gone with it)."""
    if share["kind"] != "cuda_ipc":
        return
    try:
        torch.UntypedStorage._release_ipc_counter(
            _unb64(share["ref_counter"]), share["ref_counter_offset"],
            device=share["device"])
    except Exception as e:  # noqa: BLE001 — the open's error is raised
        logger.warning(f"releasing an unopened share's count failed: {e}")


def _share_count(experiment: str, trial: str) -> int:
    """Shares a publication offers: twice the registered generation
    servers, plus two (a retried consume takes another)."""
    from areal_tpu_torch.base import name_resolve, names

    servers = name_resolve.get_subtree(names.gen_server_root(experiment,
                                                             trial))
    return 2 * len(servers) + 2


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def publish_device(experiment: str, trial: str, role: str,
                   params: Dict[str, torch.Tensor], version: int = 0,
                   dtype: Optional[torch.dtype] = None) -> DevicePublication:
    """Trainer-side publish: pack ``params`` (whole tensors on one device,
    the layout un-meshed servers hold; cast to ``dtype`` when given) into
    one buffer, share it, and advertise it under ``names.weight_device``.
    Returns the publication; its ``digest`` is what consumers are
    handed."""
    from areal_tpu_torch.base import name_resolve, names
    from areal_tpu_torch.system import memwatch

    t0 = time.monotonic()
    if any(_is_dtensor(t) for t in params.values()):
        raise ValueError("a device publication packs whole tensors; gather "
                         "a mesh's masters first (full_params)")
    devices = {t.device for t in params.values()}
    if len(devices) != 1:
        raise ValueError(f"a device publication lives on one device; "
                         f"the leaves are on {sorted(map(str, devices))}")
    dev = devices.pop()
    with memwatch.watermark("reshard/publish"):
        specs = {n: (t.shape, dtype if dtype is not None
                     and t.is_floating_point() else t.dtype)
                 for n, t in params.items()}
        manifest = [{"name": n, "shape": list(specs[n][0]),
                     "dtype": _dtype_name(specs[n][1]),
                     "nbytes": params[n].numel() * specs[n][1].itemsize}
                    for n in sorted(params)]
        offsets, at = {}, 0
        for e in manifest:
            offsets[e["name"]] = at
            at += -(-e["nbytes"] // _ALIGN) * _ALIGN
        path = None
        if dev.type == "cuda":
            buffer = torch.empty(at, dtype=torch.uint8, device=dev)
        else:
            d = os.path.join(tempfile.gettempdir(), "areal_tpu_torch_device")
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"{experiment}_{trial}_{role}_v{version}_{os.getpid()}_"
                f"{time.monotonic_ns()}.bin")
            st = torch.UntypedStorage.from_file(path, True, max(at, 1))
            buffer = torch.empty(0, dtype=torch.uint8).set_(st, 0, (at,))
        for e in manifest:
            _leaf_view(buffer, offsets[e["name"]], e).copy_(
                params[e["name"]].detach())
        _sync([buffer])
    digest = manifest_digest(manifest, version)
    n_shares = _share_count(experiment, trial)
    shares = ([_share(buffer) for _ in range(n_shares)] if path is None
              else [{"kind": "file", "path": path, "nbytes": at}] * n_shares)
    claims = tempfile.mkdtemp(prefix=f"areal_device_claims_{role}_v{version}_")
    record = {"pid": os.getpid(), "version": version, "digest": digest,
              "shares": shares, "claims": claims, "manifest": manifest,
              "offsets": offsets}
    pub = DevicePublication(
        role=role, version=version, buffer=buffer, manifest=manifest,
        offsets=offsets, digest=digest, publish_secs=time.monotonic() - t0, record=record, path=path,
        claims=claims)
    key = (experiment, trial, role)
    old = _REGISTRY.get(key)
    _REGISTRY[key] = pub
    name_resolve.add(names.weight_device(experiment, trial, role),
                     json.dumps(record), replace=True)
    # Latest-wins: the old buffer goes only after the new record stands, so
    # a consumer's post-copy check sees the record change first.
    if old is not None:
        _release(old)
    logger.info(f"device publish {role} v{version}: {len(manifest)} leaves, "
                f"{at >> 20} MB packed, {pub.publish_secs:.3f}s")
    return pub


def _release(pub: DevicePublication) -> None:
    """Withdraw a publication: claim every share no consumer took and give
    back its count, then drop this process's reference; the buffer is
    freed once the consumers that took shares let their mappings go."""
    for i, share in enumerate(pub.record["shares"]):
        if _claim(pub.claims, i) and share["kind"] == "cuda_ipc":
            torch.UntypedStorage._release_ipc_counter(
                _unb64(share["ref_counter"]), share["ref_counter_offset"],
                device=share["device"])
    shutil.rmtree(pub.claims, ignore_errors=True)
    pub.buffer = None
    if pub.path is not None:
        try:
            os.unlink(pub.path)
        except FileNotFoundError:
            pass


def lookup_publication(experiment: str, trial: str,
                       role: str) -> Optional[Dict[str, Any]]:
    """The advertised publication record of ``role`` (any process's), or
    None."""
    from areal_tpu_torch.base import name_resolve, names

    try:
        raw = name_resolve.get(names.weight_device(experiment, trial, role))
    except name_resolve.NameEntryNotFoundError:
        return None
    return json.loads(raw)


def clear_publication(experiment: str, trial: str, role: str) -> None:
    """Drop this process's slot and the discovery key (trainer teardown, or
    a switch away from ``device``)."""
    from areal_tpu_torch.base import name_resolve, names

    pub = _REGISTRY.pop((experiment, trial, role), None)
    if pub is not None:
        _release(pub)
    try:
        name_resolve.delete(names.weight_device(experiment, trial, role))
    except name_resolve.NameEntryNotFoundError:
        pass


def consume_device(experiment: str, trial: str, role: str, version: int,
                   digest: str, live_params: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Generation-server-side consume: find the publication, verify the
    out-of-band digest and the tree against the live state dict, check the
    publisher is alive, then copy the published leaves into new tensors on
    each live leaf's device and in its dtype. Raises
    :class:`DeviceReshardError` on any gate; the caller keeps its old
    weights. The reference's ``group_mb`` is left out: the copy reads one
    packed buffer."""
    rec = lookup_publication(experiment, trial, role)
    if rec is None:
        raise DeviceReshardError(
            f"no device publication for ({experiment}, {trial}, {role}) — "
            f"the device transport needs a trainer publishing on it "
            f"(weight_sync.transport=device)")
    if rec["version"] != version:
        raise DeviceReshardError(
            f"device publication version skew: registry holds "
            f"v{rec['version']}, fanout asked for v{version}")
    manifest = rec["manifest"]
    if (manifest_digest(manifest, version) != digest
            or rec["digest"] != digest):
        raise DeviceReshardError(
            f"device publication digest mismatch for v{version}: the "
            f"registered tensors are not the ones the control plane "
            f"advertised")
    pub_names = {t["name"]: t for t in manifest}
    if set(pub_names) != set(live_params):
        missing = sorted(set(live_params) ^ set(pub_names))
        raise DeviceReshardError(
            f"device publication tree mismatch: {len(missing)} leaves "
            f"differ (e.g. {missing[:3]})")
    for name, old in live_params.items():
        if tuple(pub_names[name]["shape"]) != tuple(old.shape):
            raise DeviceReshardError(
                f"tensor {name!r}: published shape "
                f"{pub_names[name]['shape']} != live {list(old.shape)}")
    if not _pid_alive(int(rec["pid"])):
        raise DeviceReshardError(
            f"device publication v{version}: its publisher (pid "
            f"{rec['pid']}) is gone")
    from areal_tpu_torch.system import memwatch

    with memwatch.watermark("reshard/consume"):
        t0 = time.perf_counter()
        share = None
        for i, s in enumerate(rec["shares"]):
            try:
                if _claim(rec["claims"], i):
                    share = s
                    break
            except FileNotFoundError:  # withdrawn since the lookup
                break
        if share is None:
            raise DeviceReshardError(
                f"device publication v{version}: no share of its buffer is "
                f"left ({len(rec['shares'])} taken, or it was withdrawn)")
        try:
            buffer = _open(share)
        except Exception as e:  # noqa: BLE001 — surfaced as a gate
            _give_back(share)
            raise DeviceReshardError(
                f"device publication v{version}: opening its buffer "
                f"failed: {e}") from e
        _sync([buffer])
        t1 = time.perf_counter()
        # one device-to-device copy of the whole buffer; the leaves are
        # views into it, cast where the live dtype differs
        devices = {t.device for t in live_params.values()}
        local = (buffer.to(devices.pop(), copy=True) if len(devices) == 1
                 else buffer)
        out = {}
        for name, old in live_params.items():
            src = _leaf_view(local, rec["offsets"][name], pub_names[name])
            out[name] = src.to(device=old.device, dtype=old.dtype,
                               copy=local is buffer)
        _sync(list(out.values()))
        LAST_CONSUME.update(open_s=t1 - t0, copy_s=time.perf_counter() - t1,
                            nbytes=float(buffer.numel()))
        del buffer, local, src
    now = lookup_publication(experiment, trial, role)
    if now is None or now["digest"] != digest or now["claims"] != rec["claims"]:
        raise DeviceReshardError(
            f"device publication v{version} was replaced while it was "
            f"copied; the copy is discarded")
    return out
