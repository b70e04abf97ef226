"""Layout-to-layout moves of a state dict, and the ``device`` weight-sync
transport.

The port's counterpart of ``areal_tpu/parallel/reshard.py``: one
resharding core (``plan_reshard:129``, ``reshard_pytree:224``,
``reshard_via_host:265``), spent by the trainer's ``param_realloc`` hook,
and the ``device`` transport (``publish_device`` / ``consume_device``,
the manifest and its digest, latest-wins), which packs the trainer's
weights into the generation fleet's layout.

Layouts. A target layout is a ``torch.device`` (the whole tensor on that
device: what an un-meshed generation server holds) or a ``(mesh,
placements)`` pair (a DTensor on a ``parallel/mesh.py`` mesh). A
:class:`ReshardPlan` passes leaves already in their target layout through
untouched (no copy) and batches the rest into transfer groups of at most
``group_mb``; each group is moved (``redistribute``, ``full_tensor`` or
``distribute_tensor``) and synchronized before the next, so the extra
device memory of a move stays about one group. A generation spec's layout
(``model_shardings(ParallelSpec)``) is a :class:`ServingLayout`: each of a
server's ``fsdp × pp × tp`` ranks' tensors (its stage's layers and the
rest) and its cut of each (``parallel/sharding.py serving_slices``).

The ``device`` transport. The reference's trainer and servers share one
JAX runtime and hand the published tree over through an in-process
registry. The port's trainer and servers are separate processes, so the
publication crosses processes (an accepted difference):

 - ``publish_device`` packs the compute-dtype leaves into **one**
   contiguous device buffer per rank of the target layout (whole tensors:
   one buffer; a ``ServingLayout``: one per server rank, holding only that
   rank's tensors, cut), copying one transfer group (:func:`plan_publication`) at a
   time, so the publish's extra device memory is the buffers plus one
   group of gathered tensors; it takes each buffer's CUDA IPC handles
   (``UntypedStorage._share_cuda_``, one share each) and writes ``{pid,
   version, digest, ...}`` under ``names.weight_device`` with each
   buffer's ``{shares, claims, manifest, offsets}`` (at the top level for
   one buffer, under ``ranks`` for several; the reference writes ``{pid,
   version, digest}``). One digest covers every rank's manifest. A share
   names its GPU by UUID (``torch.cuda.get_device_properties(i).uuid``),
   never by index: a server process sees its own ``CUDA_VISIBLE_DEVICES``;
 - ``consume_device`` runs the reference's gates (missing publication,
   version skew, digest, tree, shape) and more: the publication's number
   of ranks against the server's, a dead publisher (found by pid), and the
   publisher's GPU among the visible ones (:func:`visible_device`; none
   with its UUID is a gate, checked before a share is claimed). It then
   opens the handle of its rank's buffer on that device, copies the buffer
   to the server's device in one copy (the shadow weights are views into
   it, cast where the live dtype differs), checks that the record it read
   still stands (a republish during the copy fails the consume rather than
   hand over a torn tree), and releases the mapping;
 - latest-wins keeps one slot per role in the publishing process: a new
   publication replaces the old, whose buffers are then freed once no
   consumer holds them. torch's CUDA IPC reference counting keeps one
   count per share, released by one consumer's mapping, so each buffer
   offers several shares (twice the registered servers, plus two; every
   server has one rank per buffer) and each consumer claims one of its own
   (an exclusive file in the buffer's claims directory); when the
   publication is dropped, the publisher claims every share left and
   releases its count, so a buffer goes exactly when the last consumer
   that took a share lets its mapping go, none or several;
 - on CPU tensors, which only the tests use, the same code shares the
   buffers through named shared-memory files (``UntypedStorage.from_file``
   with ``shared=True``) in place of the IPC handles.

No gate falls back to another transport: a failed gate raises
:class:`DeviceReshardError`, which the generation server answers with 500
while it keeps its old weights.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import logging
import math
import os
import shutil
import sys
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
    # A DTensor exists only once its module is imported: the check never
    # imports it (seconds where torch ships no bytecode).
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


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
    return ReshardPlan(identical=tuple(identical),
                       groups=_transfer_groups(moves, group_bytes),
                       moved_bytes=moved_bytes, total_bytes=total_bytes,
                       group_bytes=group_bytes)


def _transfer_groups(moves: List[Tuple[str, int]], group_bytes: int
                     ) -> Tuple[Tuple[str, ...], ...]:
    """``(name, bytes)`` in order, batched into groups of at most
    ``group_bytes`` (a larger leaf is a group of its own)."""
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
    return tuple(groups)


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
    here.) Given a generation spec (a ``ParallelSpec``) in place of a
    mesh: the :class:`ServingLayout` of its servers' ranks (the spec's
    ``dp`` counts servers, each of which holds this layout)."""
    from areal_tpu_torch.parallel import sharding as psh
    from areal_tpu_torch.parallel.mesh import ParallelSpec

    if isinstance(mesh, ParallelSpec):
        return serving_layout(mesh, model_cfg)
    specs = psh.param_partition_specs(model_cfg, psh.mesh_degree(mesh, "tp"))
    return {n: (mesh, pl) for n, pl in specs.items()}


@dataclasses.dataclass(frozen=True)
class ServingLayout:
    """A generation server's layout: for each of its ranks, the tensors it
    holds and its cut of each (``parallel/sharding.py serving_slices``;
    ``()``: whole). A device publication into it packs one buffer per
    rank."""

    ranks: List[Dict[str, Any]]

    @property
    def n_ranks(self) -> int:
        return len(self.ranks)


def serving_layout(gen_spec, model_cfg) -> ServingLayout:
    """The layout of a generation spec's servers: each server's ``fsdp``,
    ``pp`` and ``tp`` ranks (``dp`` counts servers). ``sp`` and ``ep``
    are refused, for the reference's reasons (``parallel/mesh.py
    GEN_AXIS_REFUSALS``)."""
    from areal_tpu_torch.parallel import sharding as psh
    from areal_tpu_torch.parallel.mesh import GEN_AXIS_REFUSALS, server_spec

    for axis, why in GEN_AXIS_REFUSALS.items():
        if getattr(gen_spec, axis) > 1:
            raise ValueError(f"generation spec {gen_spec} sets {axis}="
                             f"{getattr(gen_spec, axis)}: {why}")
    return ServingLayout(psh.serving_slices(model_cfg, server_spec(gen_spec)))


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
class _Part:
    """One rank's part of a publication: its packed buffer and record."""

    buffer: Optional[torch.Tensor]  # uint8, every leaf at its offset
    manifest: List[Dict[str, Any]]  # name/shape/dtype/nbytes per leaf
    offsets: Dict[str, int]
    path: Optional[str] = None  # the shared-memory file (CPU buffers)
    claims: Optional[str] = None  # the directory consumers claim shares in
    record: Optional[Dict[str, Any]] = None  # shares, claims, manifest...


@dataclasses.dataclass
class DevicePublication:
    """A published version: one :class:`_Part` per rank of the target
    layout (one for whole tensors). ``buffer``, ``manifest``, ``offsets``,
    ``path`` and ``claims`` are rank 0's."""

    role: str
    version: int
    parts: List[_Part]
    digest: str
    publish_secs: float
    record: Dict[str, Any]
    plan: ReshardPlan

    @property
    def buffer(self):
        return self.parts[0].buffer

    @property
    def manifest(self):
        return self.parts[0].manifest

    @property
    def offsets(self):
        return self.parts[0].offsets

    @property
    def path(self):
        return self.parts[0].path

    @property
    def claims(self):
        return self.parts[0].claims


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


def layout_digest(manifests: List[List[Dict[str, Any]]], version: int) -> str:
    """One digest over every rank's manifest (a whole-tensor publication's
    is :func:`manifest_digest` of its one manifest)."""
    if len(manifests) == 1:
        return manifest_digest(manifests[0], version)
    blob = json.dumps({"version": version, "ranks": manifests},
                      sort_keys=True, separators=(",", ":"))
    return f"{zlib.crc32(blob.encode()):08x}"


def _b64(b: Optional[bytes]) -> Optional[str]:
    return None if b is None else base64.b64encode(b).decode()


def _unb64(s: Optional[str]) -> Optional[bytes]:
    return None if s is None else base64.b64decode(s)


def device_uuid(index: int) -> str:
    """The UUID of visible CUDA device ``index`` (the same string in every
    process, whatever its ``CUDA_VISIBLE_DEVICES``)."""
    return str(torch.cuda.get_device_properties(index).uuid)


def visible_device(uuid: str, table: Optional[List[str]] = None) -> int:
    """The index of the visible device with ``uuid`` (``table``: the
    visible devices' UUIDs, by index; default this process's). Raises
    :class:`DeviceReshardError` naming the UUID when none matches."""
    if table is None:
        table = [device_uuid(i) for i in range(torch.cuda.device_count())]
    for i, u in enumerate(table):
        if u == uuid:
            return i
    raise DeviceReshardError(
        f"the publication's GPU {uuid} is not visible to this process "
        f"(visible: {table}); the device transport needs the trainer's GPU "
        f"in CUDA_VISIBLE_DEVICES")


def _share(buffer: torch.Tensor) -> Dict[str, Any]:
    """The CUDA IPC handle of ``buffer``'s storage, JSON-ready. ``uuid``
    names the GPU for consumers; ``device`` is the publisher's own index
    of it (its release reads it, no consumer does)."""
    (dev, handle, size, offset, rc, rc_offset, event,
     event_sync) = buffer.untyped_storage()._share_cuda_()
    return {"kind": "cuda_ipc", "device": dev, "uuid": device_uuid(dev),
            "handle": _b64(handle),
            "storage_bytes": size, "storage_offset": offset,
            "ref_counter": _b64(rc), "ref_counter_offset": rc_offset,
            "event": _b64(event), "event_sync": event_sync,
            "tensor_offset": buffer.storage_offset(),
            "nbytes": buffer.numel()}


def _open(handle: Dict[str, Any], local: Optional[int] = None
          ) -> torch.Tensor:
    """The publication's buffer (uint8) mapped into this process; a CUDA
    handle on ``local``, this process's index of the publisher's GPU."""
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
        torch.UntypedStorage, torch.uint8, local,
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


def _give_back(share: Dict[str, Any], local: Optional[int]) -> None:
    """Release the count of a claimed share that was never opened, as the
    consumer's mapping would have (best effort: a dead publisher's
    counters are gone with it)."""
    if share["kind"] != "cuda_ipc":
        return
    try:
        torch.UntypedStorage._release_ipc_counter(
            _unb64(share["ref_counter"]), share["ref_counter_offset"],
            device=local)
    except Exception as e:  # noqa: BLE001 — the open's error is raised
        logger.warning(f"releasing an unopened share's count failed: {e}")


def _share_count(experiment: str, trial: str) -> int:
    """Shares each rank's buffer offers: twice the registered generation
    servers, plus two (a retried consume takes another). Every server has
    one rank per buffer, so a publication's shares count server ranks."""
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


def _layout_of(params: Dict[str, torch.Tensor], target) -> ServingLayout:
    if target is None or isinstance(target, (str, torch.device)):
        return ServingLayout([{n: () for n in params}])
    if isinstance(target, ServingLayout):
        held = set().union(*target.ranks)
        if held != set(params):
            missing = sorted(held ^ set(params))
            raise ValueError(f"publication layout and weights differ on "
                             f"{len(missing)} leaves (e.g. {missing[:3]})")
        return target
    raise ValueError(f"a device publication's target is whole tensors or "
                     f"a ServingLayout, not {type(target).__name__}")


def plan_publication(params: Dict[str, torch.Tensor], dtype=None,
                     group_mb: int = DEFAULT_GROUP_MB) -> ReshardPlan:
    """The transfer groups of a publication: the leaves in name order,
    batched so that the whole compute-dtype tensors one group stages
    (gathered or cast) come to at most ``group_mb`` (a larger leaf is a
    group of its own). Every trainer rank computes the same plan."""
    moves = []
    for name in sorted(params):
        t = params[name]
        dt = dtype if dtype is not None and t.is_floating_point() else t.dtype
        moves.append((name, t.numel() * dt.itemsize))
    total = sum(n for _, n in moves)
    return ReshardPlan(identical=(),
                       groups=_transfer_groups(moves, group_mb << 20),
                       moved_bytes=total, total_bytes=total,
                       group_bytes=group_mb << 20)


def _alloc_part(experiment, trial, role, version, rank, manifest, dev
                ) -> _Part:
    offsets, at = {}, 0
    for e in manifest:
        offsets[e["name"]] = at
        at += -(-e["nbytes"] // _ALIGN) * _ALIGN
    if dev.type == "cuda":
        return _Part(torch.empty(at, dtype=torch.uint8, device=dev),
                     manifest, offsets)
    d = os.path.join(tempfile.gettempdir(), "areal_tpu_torch_device")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{experiment}_{trial}_{role}_v{version}_r{rank}_"
                        f"{os.getpid()}_{time.monotonic_ns()}.bin")
    st = torch.UntypedStorage.from_file(path, True, max(at, 1))
    return _Part(torch.empty(0, dtype=torch.uint8).set_(st, 0, (at,)),
                 manifest, offsets, path=path)


def publish_device(experiment: str, trial: str, role: str,
                   params: Dict[str, torch.Tensor], version: int = 0,
                   dtype: Optional[torch.dtype] = None, target=None,
                   group_mb: int = DEFAULT_GROUP_MB,
                   gather=None, device=None) -> DevicePublication:
    """Trainer-side publish: pack ``params`` (cast to ``dtype`` when
    given) into ``target``'s layout (None: whole tensors, the layout
    un-meshed servers hold; a :class:`ServingLayout`: one buffer per
    server rank holding its tensors, cut), share the buffers and advertise them
    under ``names.weight_device``. The leaves are copied one transfer
    group at a time (:func:`plan_publication`): ``params`` are whole
    tensors on one device, or, with ``gather``, tensors of the whole
    shapes (meta tensors will do) whose whole compute-dtype values
    ``gather(names)`` returns one group at a time, packed on ``device``;
    either way the publish's extra device memory is the buffers plus one
    group (a cast needs none: the copy casts). Returns the publication;
    its ``digest`` (over every rank's manifest) is what consumers are
    handed."""
    from areal_tpu_torch.base import name_resolve, names
    from areal_tpu_torch.parallel.sharding import cut_shape, take_slice
    from areal_tpu_torch.system import memwatch

    t0 = time.monotonic()
    if gather is None and any(_is_dtensor(t) for t in params.values()):
        raise ValueError("a device publication packs whole tensors; give "
                         "a mesh's masters with their gather")
    layout = _layout_of(params, target)
    if gather is None:
        devices = {t.device for t in params.values()}
        if len(devices) != 1:
            raise ValueError(f"a device publication lives on one device; "
                             f"the leaves are on "
                             f"{sorted(map(str, devices))}")
        dev = devices.pop()
    else:
        dev = _as_device(device)
    plan = plan_publication(params, dtype, group_mb)
    with memwatch.watermark("reshard/publish"):
        dts = {n: dtype if dtype is not None and t.is_floating_point()
               else t.dtype for n, t in params.items()}
        parts = []
        for r, cuts in enumerate(layout.ranks):
            manifest = []
            for n in sorted(cuts):
                shape = cut_shape(params[n].shape, cuts[n])
                manifest.append({
                    "name": n, "shape": shape, "dtype": _dtype_name(dts[n]),
                    "nbytes": math.prod(shape) * dts[n].itemsize})
            parts.append(_alloc_part(experiment, trial, role, version, r,
                                     manifest, dev))
        entries = [{e["name"]: e for e in p.manifest} for p in parts]
        for group in plan.groups:
            whole = (gather(list(group)) if gather is not None
                     else {n: params[n] for n in group})
            for n in group:
                src = whole[n].detach()
                for r, part in enumerate(parts):
                    if n not in part.offsets:  # another stage's layer
                        continue
                    # copy_ casts as it copies: no staged cast
                    _leaf_view(part.buffer, part.offsets[n],
                               entries[r][n]).copy_(
                        take_slice(src, layout.ranks[r][n]))
            _sync([p.buffer for p in parts])
            del whole
    digest = layout_digest([p.manifest for p in parts], version)
    n_shares = _share_count(experiment, trial)
    for r, part in enumerate(parts):
        part.claims = tempfile.mkdtemp(
            prefix=f"areal_device_claims_{role}_v{version}_r{r}_")
        shares = ([_share(part.buffer) for _ in range(n_shares)]
                  if part.path is None else
                  [{"kind": "file", "path": part.path,
                    "nbytes": part.buffer.numel()}] * n_shares)
        part.record = {"shares": shares, "claims": part.claims,
                       "manifest": part.manifest, "offsets": part.offsets}
    record = {"pid": os.getpid(), "version": version, "digest": digest}
    if layout.n_ranks == 1:
        record.update(parts[0].record)
    else:
        record["ranks"] = [p.record for p in parts]
    pub = DevicePublication(
        role=role, version=version, parts=parts, digest=digest,
        publish_secs=time.monotonic() - t0, record=record, plan=plan)
    key = (experiment, trial, role)
    old = _REGISTRY.get(key)
    _REGISTRY[key] = pub
    name_resolve.add(names.weight_device(experiment, trial, role),
                     json.dumps(record), replace=True)
    # Latest-wins: the old buffers go only after the new record stands, so
    # a consumer's post-copy check sees the record change first.
    if old is not None:
        _release(old)
    logger.info(
        f"device publish {role} v{version}: {len(parts[0].manifest)} leaves "
        f"(rank 0) x {layout.n_ranks} rank(s), "
        f"{sum(p.buffer.numel() for p in parts) >> 20}"
        f" MB packed in {len(plan.groups)} groups, {pub.publish_secs:.3f}s")
    return pub


def _release(pub: DevicePublication) -> None:
    """Withdraw a publication: claim every share no consumer took and give
    back its count, then drop this process's references; each buffer is
    freed once the consumers that took shares let their mappings go."""
    for part in pub.parts:
        for i, share in enumerate(part.record["shares"]):
            if _claim(part.claims, i) and share["kind"] == "cuda_ipc":
                torch.UntypedStorage._release_ipc_counter(
                    _unb64(share["ref_counter"]), share["ref_counter_offset"],
                    device=share["device"])
        shutil.rmtree(part.claims, ignore_errors=True)
        part.buffer = None
        if part.path is not None:
            try:
                os.unlink(part.path)
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


def record_parts(rec: Dict[str, Any]) -> List[Dict[str, Any]]:
    """A record's per-rank parts (a whole-tensor record is its own)."""
    return rec["ranks"] if "ranks" in rec else [rec]


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
                   digest: str, live_params: Dict[str, torch.Tensor],
                   rank: int = 0, n_ranks: int = 1,
                   uuids: Optional[List[str]] = None
                   ) -> Dict[str, torch.Tensor]:
    """Generation-server-side consume of rank ``rank`` of a server of
    ``n_ranks``: find the publication, verify the out-of-band digest, its
    number of ranks, and the rank's tree against the live state dict,
    check the publisher is alive, find the publisher's GPU among the
    visible ones by its UUID (``uuids``: the visible devices' UUIDs, by
    index; default this process's), then copy the rank's buffer to each
    live leaf's device in its dtype. Raises :class:`DeviceReshardError`
    on any gate; the caller keeps its old weights. The reference's
    ``group_mb`` is left out: the copy reads one packed buffer."""
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
    parts = record_parts(rec)
    if (layout_digest([p["manifest"] for p in parts], version) != digest
            or rec["digest"] != digest):
        raise DeviceReshardError(
            f"device publication digest mismatch for v{version}: the "
            f"registered tensors are not the ones the control plane "
            f"advertised")
    if len(parts) != n_ranks:
        raise DeviceReshardError(
            f"device publication v{version} is laid out for {len(parts)} "
            f"rank(s), this server has {n_ranks} (weight_sync."
            f"gen_parallel_spec must name the fleet's spec)")
    part = parts[rank]
    manifest = part["manifest"]
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

    # The publisher's GPU, before a share is claimed: no match is a gate.
    local = (visible_device(part["shares"][0]["uuid"], uuids)
             if part["shares"] and part["shares"][0]["kind"] == "cuda_ipc"
             else None)
    with memwatch.watermark("reshard/consume"):
        t0 = time.perf_counter()
        share = None
        for i, s in enumerate(part["shares"]):
            try:
                if _claim(part["claims"], i):
                    share = s
                    break
            except FileNotFoundError:  # withdrawn since the lookup
                break
        if share is None:
            raise DeviceReshardError(
                f"device publication v{version}: no share of its buffer is "
                f"left ({len(part['shares'])} taken, or it was withdrawn)")
        try:
            buffer = _open(share, local)
        except Exception as e:  # noqa: BLE001 — surfaced as a gate
            _give_back(share, local)
            raise DeviceReshardError(
                f"device publication v{version}: opening its buffer "
                f"failed: {e}") from e
        _sync([buffer])
        t1 = time.perf_counter()
        # one copy of the whole buffer onto the live device (from the
        # publisher's GPU, where that is another); the leaves are views
        # into it, cast where the live dtype differs
        devices = {t.device for t in live_params.values()}
        local_buf = (buffer.to(devices.pop(), copy=True) if len(devices) == 1
                     else buffer)
        out = {}
        for name, old in live_params.items():
            src = _leaf_view(local_buf, part["offsets"][name],
                             pub_names[name])
            out[name] = src.to(device=old.device, dtype=old.dtype,
                               copy=local_buf is buffer)
        _sync(list(out.values()))
        LAST_CONSUME.update(open_s=t1 - t0, copy_s=time.perf_counter() - t1,
                            nbytes=float(buffer.numel()))
        del buffer, local_buf, src
    now = lookup_publication(experiment, trial, role)
    if (now is None or now["digest"] != digest or len(record_parts(now))
            != len(parts) or record_parts(now)[rank]["claims"]
            != part["claims"]):
        raise DeviceReshardError(
            f"device publication v{version} was replaced while it was "
            f"copied; the copy is discarded")
    return out
