"""A meshed generation server's ranks: the leader's device calls, replayed
on every follower in the same order.

The port's counterpart of the reference's meshed server
(``areal_tpu/system/generation_server.py:152-171``, ``mesh=`` ->
``psh.shard_params``), where one JAX program runs each call on every chip
of the server's mesh. Here a server is a group of ``fsdp × pp × tp``
ranks (``parallel/mesh.py ServerRank``), each a process on one device
holding its part of the weights (``parallel/sharding.py serving_shards``)
and of every decode state:

 - ``tp``: the rank's heads and MLP columns, its kv heads of every state,
   and the model's two sums per block across the ``tp`` group
   (``constrain`` under ``activation_sharding``);
 - ``pp``: the rank's stage's layers and their KV; each call runs stage by
   stage, each stage handing its hidden state to the next, the last
   sampling and sending the tokens back (``models/generate.py
   StageChain``);
 - ``fsdp``: a ``1/fsdp`` shard of each tensor, gathered over the ``fsdp``
   group when a call first runs the module that uses it (ZeRO-3
   inference, ``parallel/sharding.py FsdpGather``; a decode call holds
   its layers for its steps); every ``fsdp`` rank runs the whole batch.

Control is single-controller, as in the trainer
(``system/trainer_worker.py _bcast`` / ``_follow_once``):

 - the leader (rank 0, at ``(fsdp 0, pp 0, tp 0)``) owns HTTP, the serving
   queue, admission, prefix reuse and the runner; it calls this object
   where the un-meshed server calls ``models/generate.py`` (the same
   functions, the same signatures);
 - a decode state on the leader is a :class:`MeshState` that carries an
   id; every follower keeps its own state under that id. Calls that
   only derive states (slice, stack, grow, clone) run on the leader at
   once and are queued; the next call that runs the model (prefill,
   extend, decode) or a weight swap sends the queue and the call in one
   host broadcast, and every follower replays them in order, each on its
   stage's part of the states. A state the leader lets go (a finaliser)
   is dropped on the followers the same way;
 - the ranks that sample (the last stage's) sample the same tokens: the
   embedding and the head are whole on each of them, so the logits are
   the same on each, and each rank's generator draws from the same seed
   in the same order. The tokens, the log-probs and the last logits reach
   every earlier stage, so every rank ends a call with the same outputs.
   After each decode call the ranks compare the tokens; a mismatch fails
   the server;
 - a weight swap loads on every rank, then the ranks gather their
   outcomes and all swap, or none does (500, old weights kept);
 - failures are never caught: a follower whose call raises ends its
   process, so the leader's next collective raises; a leader call that
   raises (its own fault, a dead follower, a mismatch) marks the server
   failed, fails every later call, and the process that runs it exits
   (``apps/launcher.py``), so the supervisor respawns the server's ranks
   as one unit (``system/supervisor.py``).

Calls are serialised by :attr:`ServerMesh.lock`: the runner holds it for a
whole batch, and a weight swap takes it between batches, so that a batch
never runs on two weight versions across the ranks.
"""

from __future__ import annotations

import logging
import threading
import weakref
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from areal_tpu_torch.models import generate as genmod
from areal_tpu_torch.parallel import distributed as dist_mod
from areal_tpu_torch.parallel import sharding as psh
from areal_tpu_torch.parallel.mesh import ParallelSpec, ServerRank
from areal_tpu_torch.parallel.pipeline import PipeCtx, _P2PLink, stage_bounds

logger = logging.getLogger("areal_tpu_torch.server_mesh")


class MeshServerError(RuntimeError):
    """A meshed server failed as a unit (a follower died or diverged, or a
    call raised on the leader); every later call raises it too."""


class MeshState(dict):
    """A leader's decode state (``models/generate.py State``) and the id
    under which every follower keeps its part."""

    __slots__ = ("sid", "__weakref__")


def _host(t: Optional[torch.Tensor]):
    return None if t is None else t.detach().cpu().numpy()


def _dev(a, device):
    return None if a is None else torch.from_numpy(np.asarray(a)).to(device)


def _token_crc(out: Dict[str, torch.Tensor]) -> int:
    return zlib.crc32(out["output_ids"].cpu().numpy().tobytes())


def server_rank(mesh) -> ServerRank:
    """This process's rank of the server whose mesh is ``mesh``."""
    return ServerRank(ParallelSpec(
        fsdp=psh.mesh_degree(mesh, "fsdp"), pp=psh.mesh_degree(mesh, "pp"),
        tp=psh.mesh_degree(mesh, "tp")), mesh.get_rank())


class ServerMesh:
    """One rank's side of a meshed server. ``server`` is the rank's
    ``GenerationServer`` (its model, generator and weight loading);
    ``mesh`` a ``parallel/mesh.py`` mesh of the server's process group
    (its ``fsdp``, ``pp`` and ``tp``; rank 0 leads)."""

    def __init__(self, server, mesh):
        self.server = server
        self.mesh = mesh
        self.me = server_rank(mesh)
        self.spec = self.me.spec
        self.rank = self.me.rank
        # the stages' chain and the fsdp gather (none at pp 1 and fsdp 1:
        # the whole model, its tp slices, on each rank)
        self.chain: Optional[genmod.StageChain] = None
        if self.spec.pp > 1 or self.spec.fsdp > 1:
            lo = stage_bounds(server.model_cfg.n_layers,
                              self.spec.pp)[self.me.pp_rank][0]
            self.chain = genmod.StageChain(
                pp=self.spec.pp, stage=self.me.pp_rank,
                link=(_P2PLink(PipeCtx(self.spec.pp, self.me.pp_rank,
                                       mesh.get_group("pp")))
                      if self.spec.pp > 1 else None),
                gather=(psh.FsdpGather(
                    mesh.get_group("fsdp"), self.spec.fsdp,
                    psh.shift_layers(psh.fsdp_dims(server.model_cfg,
                                                   self.spec), -lo))
                    if self.spec.fsdp > 1 else None))
        self.lock = threading.RLock()
        self.failed: Optional[BaseException] = None
        self._stopped = False
        # leader: calls not yet sent, and the next state id
        self._pending: List[Tuple] = []
        self._plock = threading.Lock()
        self._next_sid = 0
        # follower: sid -> its part of the leader's state; leader: sid ->
        # its live states (weakly)
        self._states: Dict[int, genmod.State] = {}
        self._live: "weakref.WeakValueDictionary[int, MeshState]" = \
            weakref.WeakValueDictionary()

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    # ---------------- the leader's side ----------------

    def _queue(self, entry: Tuple) -> None:
        with self._plock:
            self._pending.append(entry)

    def _sid(self) -> int:
        with self._plock:
            sid = self._next_sid
            self._next_sid += 1
        return sid

    def _wrap(self, state: genmod.State, sid: Optional[int] = None
              ) -> MeshState:
        st = MeshState(state)
        st.sid = self._sid() if sid is None else sid
        weakref.finalize(st, self._queue, ("drop", st.sid))
        self._live[st.sid] = st
        return st

    def _fail(self, e: BaseException) -> MeshServerError:
        if self.failed is None:
            self.failed = e
            logger.error(f"meshed server failed as a unit: {e!r}")
        return e if isinstance(e, MeshServerError) else MeshServerError(
            f"meshed server rank failure: {e!r}")

    def _check(self) -> None:
        if self.failed is not None:
            raise MeshServerError(f"meshed server failed: {self.failed!r}")

    def _send(self, op: Tuple) -> None:
        """The queued derivations and ``op`` to every follower."""
        with self._plock:
            pending, self._pending = self._pending, []
        dist_mod.broadcast_pyobj((pending, op))

    def _run(self, op: Tuple, fn: Callable[[], Any]) -> Any:
        """Send ``op``, then run ``fn`` (this rank's part of it) inside the
        tp context. Any failure fails the server."""
        with self.lock:
            self._check()
            try:
                self._send(op)
                with psh.activation_sharding(self.mesh):
                    return fn()
            except BaseException as e:
                raise self._fail(e) from e

    def prefill_state(self, model, prompts, prompt_lens, S, attn_impl="auto"):
        sid = self._sid()
        return self._wrap(self._run(
            ("prefill", sid, _host(prompts), _host(prompt_lens), S,
             attn_impl),
            lambda: genmod.prefill_state(model, prompts, prompt_lens, S,
                                         attn_impl, self.chain)), sid)

    def extend_state(self, model, state, tokens, token_lens,
                     attn_impl="auto"):
        sid = self._sid()
        return self._wrap(self._run(
            ("extend", sid, state.sid, _host(tokens), _host(token_lens),
             attn_impl),
            lambda: genmod.extend_state(model, state, tokens, token_lens,
                                        attn_impl, self.chain)), sid)

    def decode_chunk_rows(self, model, state, tokens_done, generator,
                          sampling, n_tokens, eos_token_id, pad_token_id,
                          row_budget=None):
        def run():
            new, out = genmod.decode_chunk_rows(
                model, state, tokens_done, generator, sampling, n_tokens,
                eos_token_id, pad_token_id, row_budget, self.chain)
            crcs = dist_mod.gather_pyobj(_token_crc(out))
            if len(set(crcs)) != 1:
                raise MeshServerError(
                    f"the ranks sampled different tokens (crc {crcs})")
            return new, out

        sid = self._sid()
        new, out = self._run(
            ("decode", sid, state.sid, _host(tokens_done),
             {k: _host(v) for k, v in sampling.items()}, n_tokens,
             eos_token_id, pad_token_id, _host(row_budget)), run)
        return self._wrap(new, sid), out

    def clone_prefix(self, state, L):
        st = self._wrap(genmod.clone_prefix(state, L))
        self._queue(("clone", state.sid, L, st.sid))
        return st

    def grow_state(self, state, new_S):
        out = genmod.grow_state(state, new_S)
        if out is state:  # already large enough, here as on every rank
            return state
        st = self._wrap(out)
        self._queue(("grow", state.sid, new_S, st.sid))
        return st

    def slice_state(self, state, i):
        st = self._wrap(genmod.slice_state(state, i))
        self._queue(("slice", state.sid, i, st.sid))
        return st

    def stack_states(self, states: Sequence[MeshState]):
        st = self._wrap(genmod.stack_states(states))
        self._queue(("stack", [s.sid for s in states], st.sid))
        return st

    def swap_weights(self, body: Dict[str, Any],
                     load: Callable[[Dict[str, Any]], Any],
                     commit: Callable[[Any], None]) -> Any:
        """Every rank loads the update ``body`` (``load``: the server's
        own transport, into its slices); if every load succeeded, every
        rank commits it (``commit``, under :attr:`lock`, so no batch runs
        between the ranks' swaps) and this returns the rank's load. If any
        failed, none commits and this raises with every rank's error."""
        with self.lock:
            self._check()
            try:
                self._send(("update", body))
                result, bad = self._gathered_load(body, load)
            except BaseException as e:
                raise self._fail(e) from e
            if bad:
                raise RuntimeError(f"weight update failed on ranks "
                                   f"{sorted(bad)}: {bad}")
            commit(result)
            return result

    @staticmethod
    def _gathered_load(body, load) -> Tuple[Any, Dict[int, str]]:
        """This rank's ``load(body)`` and every rank's error, by rank."""
        result, err = None, None
        try:
            result = load(body)
        except Exception as e:  # noqa: BLE001 — gathered, then raised
            err = repr(e)
        errs = dist_mod.gather_pyobj(err)
        return result, {r: e for r, e in enumerate(errs) if e is not None}

    def gather(self, fn: Callable, *args) -> List[Any]:
        """``fn(server, *args)`` on every rank, the results in rank order
        (``fn`` must pickle: a module-level function)."""
        return self._run(("call", fn, args),
                         lambda: dist_mod.gather_pyobj(fn(self.server, *args)))

    def stop(self) -> None:
        """End every follower's loop (a failed server sends nothing: its
        followers end with their collectives)."""
        with self.lock:
            if self.failed is None and not self._stopped:
                self._stopped = True
                self._send(("stop",))

    # ---------------- the follower's side ----------------

    def follow(self) -> None:
        """Replay the leader's calls until it stops. An exception ends the
        loop (and, by the caller, the process): never caught here."""
        dev = self.server.device
        while True:
            pending, op = dist_mod.broadcast_pyobj(None)
            for entry in pending:
                self._derive(entry)
            if op[0] == "stop":
                return
            if op[0] == "update":
                result, bad = self._gathered_load(op[1],
                                                  self.server._load_update)
                if not bad:  # else every rank keeps its weights
                    self.server._commit_update(result)
                continue
            with psh.activation_sharding(self.mesh):
                self._replay(op, dev)

    def _derive(self, entry: Tuple) -> None:
        kind, s = entry[0], self._states
        if kind == "drop":
            del s[entry[1]]
        elif kind == "clone":
            s[entry[3]] = genmod.clone_prefix(s[entry[1]], entry[2])
        elif kind == "grow":
            s[entry[3]] = genmod.grow_state(s[entry[1]], entry[2])
        elif kind == "slice":
            s[entry[3]] = genmod.slice_state(s[entry[1]], entry[2])
        elif kind == "stack":
            s[entry[2]] = genmod.stack_states([s[i] for i in entry[1]])
        else:
            raise ValueError(f"unknown derivation {kind!r}")

    def _replay(self, op: Tuple, dev) -> None:
        srv, kind, s = self.server, op[0], self._states
        model = srv.model
        if kind == "prefill":
            _, sid, prompts, lens, S, impl = op
            s[sid] = genmod.prefill_state(model, _dev(prompts, dev),
                                          _dev(lens, dev), S, impl,
                                          self.chain)
        elif kind == "extend":
            _, sid, src, toks, lens, impl = op
            s[sid] = genmod.extend_state(model, s[src], _dev(toks, dev),
                                         _dev(lens, dev), impl, self.chain)
        elif kind == "decode":
            _, sid, src, done, sampling, n, eos, pad, budget = op
            s[sid], out = genmod.decode_chunk_rows(
                model, s[src], _dev(done, dev), srv._generator,
                {k: _dev(v, dev) for k, v in sampling.items()}, n, eos, pad,
                _dev(budget, dev), self.chain)
            dist_mod.gather_pyobj(_token_crc(out))
        elif kind == "call":
            _, fn, args = op
            dist_mod.gather_pyobj(fn(srv, *args))
        else:
            raise ValueError(f"unknown mesh call {kind!r}")

    def state(self, sid: int) -> genmod.State:
        """This rank's part of the leader's state ``sid`` (for a
        :meth:`gather` that reads it)."""
        return self._live[sid] if self.is_leader else self._states[sid]
