"""Generation: prefill + KV-cache decode, and the persistent decode state.

Counterpart of ``areal_tpu/models/generate.py``. The reference runs the
decode loop as one compiled scan; here it is a Python loop under
``torch.inference_mode()``. The arithmetic, masks, sampling order and the
state layout are the reference's.

Ownership: the reference donates the decode state to ``decode_chunk_rows``
and shares KV arrays between states. Here :func:`decode_chunk_rows` and
:func:`extend_state` take ownership of the state they are given and write
its KV **in place**; every function that derives a state from another
(:func:`slice_state`, :func:`stack_states`, :func:`clone_prefix`, a growing
:func:`grow_state`) returns fresh buffers, so a retained state is never
mutated through a derived one.

A served model split over ranks (a generation server of ``fsdp`` and ``pp``,
``system/server_mesh.py``) runs these functions on every rank with a
:class:`StageChain`: each rank runs its stage's layers on its stage's KV (a
state's ``kv_k`` / ``kv_v`` hold only those layers), the first stage embeds
the tokens and each stage hands its hidden state to the next
(``parallel/pipeline.py _P2PLink``; over gloo through host memory); the last
stage applies the head and samples, and sends the tokens to the stages
before it at each step, and the last logits and log-probs once a call, so
that every rank's state and outputs are the same but for its KV. Decode
stays un-pipelined, as in the reference: one token at a time passes the
stages in turn. Under ``fsdp`` each module runs on its weights gathered
(``parallel/sharding.py FsdpGather``) at most once a call: a prefill or an
extend gathers each layer just before it runs and drops it after, a decode
call holds its stage's gathered layers for its steps (a gather a layer a
step would move the stage's weights once per token), and every call holds
the embedding and the head.

Learned positions (GPT-2): the model refuses a live token at or past
``max_position_embeddings`` (``models/transformer.py table_positions``).
Tokens whose outputs are dropped (a finished row's pad steps, the pad tail of
an extension, the prefill's pad columns) index a clamped position instead,
as the reference's gather clamps them, so they never trip the check; RoPE
models see their positions unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from areal_tpu_torch.api.model import GenerationHyperparameters
from areal_tpu_torch.models.transformer import Transformer, init_kv_cache
from areal_tpu_torch.ops.sampling import (
    sample_token,
    sample_token_rows,
    sampling_from_gconfigs,
)
from areal_tpu_torch.ops.xent import gather_logprobs

State = Dict[str, torch.Tensor]


def _model_positions(model: Transformer, positions: torch.Tensor,
                     dropped: torch.Tensor) -> torch.Tensor:
    """``positions`` as the model is given them: for a learned table, those
    of tokens whose outputs are dropped (``dropped``, broadcast against
    ``positions``) clamped into the table."""
    cfg = model.cfg
    if cfg.pos_embedding != "learned":
        return positions
    return torch.where(dropped, positions.clamp(
        max=cfg.max_position_embeddings - 1), positions)


@dataclasses.dataclass
class StageChain:
    """A served model's place among the ranks of a server of ``fsdp`` and
    ``pp``: this rank's ``stage`` of ``pp``, the ``link`` to the other
    stages of its chain (``parallel/pipeline.py _P2PLink`` over the ``pp``
    group; None at ``pp`` 1), and ``gather``, the ``fsdp`` gather of its
    shards (``parallel/sharding.py FsdpGather``; None at ``fsdp`` 1)."""

    pp: int = 1
    stage: int = 0
    link: Any = None
    gather: Any = None

    @property
    def last(self) -> bool:
        return self.stage == self.pp - 1


def _params_hook(chain: Optional[StageChain], hold_layers: bool = False):
    """One call's ``Transformer.forward`` parameters under ``fsdp``: each
    module gathered when the call first runs it; the embedding's, position
    table's, final norm's and head's held for the call, a layer's dropped
    once it has run unless ``hold_layers`` (a decode call, which runs every
    layer once a step: held for the call's steps). None without a
    gather."""
    if chain is None or chain.gather is None:
        return None
    held: Dict[str, Dict[str, torch.Tensor]] = {}

    def hook(module, prefix: str) -> Dict[str, torch.Tensor]:
        if prefix.startswith("layers.") and not hold_layers:
            return chain.gather(module, prefix)
        if prefix not in held:
            held[prefix] = chain.gather(module, prefix)
        return held[prefix]

    return hook


def _forward(model: Transformer, chain: Optional[StageChain], hook,
             x: torch.Tensor, positions: torch.Tensor, **kw):
    """The served forward: the whole model, or this rank's stage of the
    chain (its input from the stage before, its output to the stage
    after). Returns (logits, kv); logits only on the last stage (None
    elsewhere)."""
    if chain is not None and chain.stage > 0:
        x = chain.link.recv("fwd", chain.stage - 1, chain.stage,
                            (*positions.shape, model.cfg.hidden_dim),
                            model.embedding.weight.dtype, positions.device)
    out, kv = model(x, positions, params=hook, **kw)
    if chain is None or chain.last:
        return out, kv
    chain.link.send("fwd", chain.stage + 1, out)
    chain.link.flush()
    return None, kv


def _from_last(chain: Optional[StageChain], t: Optional[torch.Tensor],
               shape, dtype, device) -> torch.Tensor:
    """``t`` as the chain's last stage holds it, on every stage (sent to
    each stage before it)."""
    if chain is None or chain.pp == 1:
        return t
    last = chain.pp - 1
    if chain.last:
        for k in range(last):
            chain.link.send("last", k, t)
        chain.link.flush()
        return t
    return chain.link.recv("last", last, chain.stage, shape, dtype, device)


def _prefill(model: Transformer, prompts: torch.Tensor,
             prompt_lens: torch.Tensor, S: int, attn_impl: str,
             chain: Optional[StageChain] = None):
    """Packed forward over right-padded prompts; KV copied into a
    zero-initialised cache of capacity S. Returns (logits, cache,
    last_logits); on a stage before the last, logits and last_logits are
    None."""
    B, P = prompts.shape
    positions = torch.arange(P, device=prompts.device).expand(B, P)
    seg = (positions < prompt_lens[:, None]).to(torch.int32)
    logits, kv = _forward(model, chain, _params_hook(chain), prompts,
                          positions, segment_ids=seg, attn_impl=attn_impl)
    cache = init_kv_cache(model.cfg, B, S, dtype=kv["k"].dtype,
                          device=prompts.device)
    cache["k"][:, :, :P] = kv["k"]
    cache["v"][:, :, :P] = kv["v"]
    if logits is None:
        return None, cache, None
    last_idx = (prompt_lens.long() - 1).clamp_min(0)
    last_logits = logits[torch.arange(B, device=prompts.device), last_idx]
    return logits, cache, last_logits


@torch.inference_mode()
def generate_batch(
    model: Transformer,
    prompts: torch.Tensor,  # [B, P] right-padded with pad_token
    prompt_lens: torch.Tensor,  # [B]
    generator: torch.Generator,
    gconfig: GenerationHyperparameters,
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int,
    attn_impl: str = "auto",
) -> Dict[str, torch.Tensor]:
    """Returns {"output_ids": [B, N], "output_logprobs": [B, N],
    "output_lens": [B], "gen_mask": [B, N], "prompt_logprobs": [B, P]}.

    output_lens counts generated tokens incl. the EOS; slots beyond it hold
    pad_token / 0.0 logprob."""
    cfg = model.cfg
    B, P = prompts.shape
    N = max_new_tokens
    S = P + N
    dev = prompts.device
    logits, kv_cache, last_logits = _prefill(model, prompts, prompt_lens, S,
                                             attn_impl)
    nxt = torch.cat([prompts[:, 1:], prompts[:, :1]], dim=1)
    prompt_logprobs = gather_logprobs(logits, nxt)
    del logits

    slot_ids = torch.arange(S, device=dev)
    plens = prompt_lens.long()
    eos_col = torch.arange(last_logits.shape[-1], device=dev) == eos_token_id
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    toks, lps, was_finished = [], [], []
    for n in range(N):
        if n < gconfig.min_new_tokens:
            # Forbid EOS until min_new_tokens have been emitted.
            last_logits = last_logits.masked_fill(eos_col[None, :], -1e30)
        token, logprob = sample_token(last_logits, generator, gconfig)
        token = torch.where(finished, pad_token_id, token)
        logprob = torch.where(finished, 0.0, logprob)
        toks.append(token)
        lps.append(logprob)
        was_finished.append(finished)

        pos = plens + n
        valid = (slot_ids[None, :] < plens[:, None]) | (
            (slot_ids[None, :] >= P) & (slot_ids[None, :] <= P + n)
        )
        if cfg.sliding_window is not None:
            # Slot j holds position j (prompt) or plen + (j - P) (decode).
            slot_pos = torch.where(slot_ids[None, :] < P, slot_ids[None, :],
                                   plens[:, None] + (slot_ids[None, :] - P))
            valid = valid & ((pos[:, None] - slot_pos) < cfg.sliding_window)
        logits_step, kv_cache = model(
            token[:, None], _model_positions(model, pos, finished)[:, None],
            kv_cache=kv_cache, cache_write_index=P + n, kv_valid=valid,
        )
        finished = finished | (token == eos_token_id)
        last_logits = logits_step[:, 0]

    gen_mask = ~torch.stack(was_finished, dim=1)
    return {
        "output_ids": torch.stack(toks, dim=1),
        "output_logprobs": torch.stack(lps, dim=1).float(),
        "output_lens": gen_mask.sum(dim=1).to(torch.int32),
        "gen_mask": gen_mask,
        "prompt_logprobs": prompt_logprobs.float(),
    }


# ---------------------------------------------------------------------------
# Persistent decode state (chunked generation without re-prefill)
# ---------------------------------------------------------------------------
#
# The server keeps per-request decode state between chunks: a KV cache laid
# out compactly (slot j of row b is valid iff j < cur_len[b]; decode token n
# of a row writes slot cur_len) plus the last-step logits, so a chunk
# continuation is pure decode steps.


@torch.inference_mode()
def prefill_state(
    model: Transformer,
    prompts: torch.Tensor,  # [B, P] right-padded
    prompt_lens: torch.Tensor,  # [B]
    S: int,  # KV capacity (>= P + first chunk length)
    attn_impl: str = "auto",
    chain: Optional[StageChain] = None,
) -> State:
    """Prefill → decode state {kv_k, kv_v [L,B,S,Hkv,Dh], last_logits [B,V]
    f32, cur_len [B] int32}; on a ``chain`` L is the stage's layers."""
    if S < prompts.shape[1]:
        raise ValueError(f"KV capacity {S} < prompt width {prompts.shape[1]}")
    _, cache, last_logits = _prefill(model, prompts, prompt_lens, S, attn_impl,
                                     chain)
    B = prompts.shape[0]
    return {
        "kv_k": cache["k"],
        "kv_v": cache["v"],
        "last_logits": _from_last(
            chain, None if last_logits is None else last_logits.float(),
            (B, model.cfg.vocab_size), torch.float32, prompts.device),
        "cur_len": prompt_lens.to(torch.int32),
    }


@torch.inference_mode()
def decode_chunk_rows(
    model: Transformer,
    state: State,  # owned by the call: its KV is updated in place
    tokens_done: torch.Tensor,  # [B] tokens generated in previous chunks
    generator: torch.Generator,
    sampling: Dict[str, torch.Tensor],  # per-row tensors (ops/sampling.py)
    n_tokens: int,
    eos_token_id: int,
    pad_token_id: int,
    row_budget: Optional[torch.Tensor] = None,  # [B] max tokens THIS chunk
    chain: Optional[StageChain] = None,
) -> Tuple[State, Dict[str, torch.Tensor]]:
    """Continue decoding ``n_tokens`` from a decode state with per-row
    sampling params. ``row_budget`` finishes a row after its own allowance
    even when the chunk is longer. Returns (new_state, out) with out like
    :func:`generate_batch`'s (output_ids / output_logprobs / output_lens /
    gen_mask). On a ``chain`` only the last stage samples (from its
    generator); each step's tokens reach the stages before it."""
    cfg = model.cfg
    hook = _params_hook(chain, hold_layers=True)
    samples = chain is None or chain.last
    kv_k, kv_v = state["kv_k"], state["kv_v"]
    S = kv_k.shape[2]
    cur_len = state["cur_len"].clone()
    dev = cur_len.device
    if n_tokens < 1:
        raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
    # The reference's scatter drops out-of-range writes; indexing here would
    # raise (or trip a device assert), so the capacity is checked up front.
    if int(cur_len.max()) + n_tokens > S:
        raise ValueError(f"KV capacity {S} too small for cur_len "
                         f"{int(cur_len.max())} + {n_tokens} tokens")
    V = state["last_logits"].shape[-1]
    slot_ids = torch.arange(S, device=dev)
    eos_col = (torch.arange(V, device=dev) == eos_token_id)[None, :]
    last_logits = state["last_logits"]
    done = tokens_done.to(device=dev, dtype=torch.int32).clone()
    finished = torch.zeros(cur_len.shape, dtype=torch.bool, device=dev)
    kv = {"k": kv_k, "v": kv_v}
    toks, lps, was_fin = [], [], []
    B = cur_len.shape[0]
    for n in range(n_tokens):
        if row_budget is not None:
            finished = finished | (n >= row_budget)
        token = None
        if samples:
            # Forbid EOS while a row is under its min_new_tokens budget.
            eos_block = (done < sampling["min_new_tokens"])[:, None] & eos_col
            token, logprob = sample_token_rows(
                last_logits.masked_fill(eos_block, -1e30), generator,
                sampling)
            token = torch.where(finished, pad_token_id, token)
            logprob = torch.where(finished, 0.0, logprob)
            lps.append(logprob)
        token = _from_last(chain, token, (B,), torch.int32, dev)
        toks.append(token)
        was_fin.append(finished)

        pos = cur_len.long()  # slot & RoPE position of the new token
        valid = slot_ids[None, :] <= pos[:, None]
        if cfg.sliding_window is not None:
            valid = valid & ((pos[:, None] - slot_ids[None, :])
                             < cfg.sliding_window)
        logits_step, kv = _forward(
            model, chain, hook, token[:, None],
            _model_positions(model, pos, finished)[:, None],
            kv_cache=kv, cache_write_index=pos, kv_valid=valid)
        now_finished = finished | (token == eos_token_id)
        cur_len = torch.where(finished, cur_len, cur_len + 1)
        done = done + (~finished).to(torch.int32)
        if samples:
            # Freeze last_logits once a row is finished: later steps feed
            # pad tokens, and a retained state must carry the logits after
            # its last REAL token.
            last_logits = torch.where(finished[:, None], last_logits,
                                      logits_step[:, 0].float())
        finished = now_finished

    gen_mask = ~torch.stack(was_fin, dim=1)
    logprobs = _from_last(chain, torch.stack(lps, dim=1).float()
                          if samples else None, (B, n_tokens),
                          torch.float32, dev)
    last_logits = _from_last(chain, last_logits if samples else None,
                             (B, V), torch.float32, dev)
    new_state = {"kv_k": kv["k"], "kv_v": kv["v"],
                 "last_logits": last_logits, "cur_len": cur_len}
    out = {
        "output_ids": torch.stack(toks, dim=1),
        "output_logprobs": logprobs,
        "output_lens": gen_mask.sum(dim=1).to(torch.int32),
        "gen_mask": gen_mask,
    }
    return new_state, out


def decode_chunk(
    model: Transformer,
    state: State,
    tokens_done: torch.Tensor,
    generator: torch.Generator,
    gconfig: GenerationHyperparameters,
    n_tokens: int,
    eos_token_id: int,
    pad_token_id: int,
) -> Tuple[State, Dict[str, torch.Tensor]]:
    """Uniform-gconfig convenience wrapper over decode_chunk_rows."""
    B = int(state["cur_len"].shape[0])
    sampling = sampling_from_gconfigs([gconfig] * B,
                                      device=state["cur_len"].device)
    return decode_chunk_rows(model, state, tokens_done, generator, sampling,
                             n_tokens=n_tokens, eos_token_id=eos_token_id,
                             pad_token_id=pad_token_id)


def clone_prefix(state: State, L: int) -> State:
    """A copy of a decode state truncated to its first ``L`` tokens (slots
    >= L are masked by every later ``kv_valid``). ``last_logits`` is the
    donor's — stale for L < donor length, so callers extend with >= 1
    token unless L equals the donor's full length. The KV is copied, so
    extending or decoding the clone never touches the donor."""
    return {
        "kv_k": state["kv_k"].clone(),
        "kv_v": state["kv_v"].clone(),
        "last_logits": state["last_logits"].clone(),
        "cur_len": torch.full_like(state["cur_len"], L),
    }


@torch.inference_mode()
def extend_state(
    model: Transformer,
    state: State,  # owned by the call: its KV is updated in place
    tokens: torch.Tensor,  # [B, T] suffix, right-padded with pad tokens
    token_lens: torch.Tensor,  # [B] real suffix lengths (>= 1)
    attn_impl: str = "auto",
    chain: Optional[StageChain] = None,
) -> State:
    """Teacher-force ``tokens`` on top of an existing decode state (the
    suffix prefill of prefix seeding). Needs ``S >= max(cur_len + T)``;
    padding-tail slots hold garbage K/V at positions >= the new cur_len,
    masked by every later attention until decode overwrites them."""
    B, T = tokens.shape
    S = state["kv_k"].shape[2]
    cur = state["cur_len"].long()
    if int(cur.max()) + T > S:
        raise ValueError(f"KV capacity {S} too small for cur_len "
                         f"{int(cur.max())} + {T} tokens")
    dev = tokens.device
    positions = cur[:, None] + torch.arange(T, device=dev)[None, :]
    slot_ids = torch.arange(S, device=dev)
    # Suffix token t of row b attends slots j <= cur[b] + t.
    kv_valid = slot_ids[None, None, :] <= positions[:, :, None]
    if model.cfg.sliding_window is not None:
        kv_valid = kv_valid & ((positions[:, :, None] - slot_ids[None, None, :])
                               < model.cfg.sliding_window)
    pad_tail = torch.arange(T, device=dev)[None, :] >= token_lens[:, None]
    logits, kv = _forward(
        model, chain, _params_hook(chain), tokens,
        _model_positions(model, positions, pad_tail),
        kv_cache={"k": state["kv_k"], "v": state["kv_v"]},
        cache_write_index=cur, kv_valid=kv_valid, attn_impl=attn_impl)
    last = None
    if logits is not None:
        last_idx = (token_lens.long() - 1).clamp_min(0)
        last = logits[torch.arange(B, device=dev), last_idx].float()
    return {
        "kv_k": kv["k"],
        "kv_v": kv["v"],
        "last_logits": _from_last(chain, last, (B, model.cfg.vocab_size),
                                  torch.float32, dev),
        "cur_len": (cur + token_lens.long()).to(torch.int32),
    }


def grow_state(state: State, new_S: int) -> State:
    """Pad the KV capacity of a decode state up to new_S slots (fresh
    buffers); returns the state itself when it is already large enough."""
    L, B, S, H, D = state["kv_k"].shape
    if new_S <= S:
        return state
    out = dict(state)
    for key in ("kv_k", "kv_v"):
        t = state[key]
        grown = torch.zeros((L, B, new_S, H, D), dtype=t.dtype, device=t.device)
        grown[:, :, :S] = t
        out[key] = grown
    return out


def slice_state(state: State, i: int) -> State:
    """A copy of row i of a batched decode state (keeps a batch axis of 1)."""
    return {
        "kv_k": state["kv_k"][:, i:i + 1].clone(),
        "kv_v": state["kv_v"][:, i:i + 1].clone(),
        "last_logits": state["last_logits"][i:i + 1].clone(),
        "cur_len": state["cur_len"][i:i + 1].clone(),
    }


def stack_states(states: Sequence[State]) -> State:
    """Concatenate single-row decode states along the batch axis (always a
    copy, also for one state)."""
    return {
        "kv_k": torch.cat([s["kv_k"] for s in states], dim=1),
        "kv_v": torch.cat([s["kv_v"] for s in states], dim=1),
        "last_logits": torch.cat([s["last_logits"] for s in states]),
        "cur_len": torch.cat([s["cur_len"] for s in states]),
    }


def pad_prompts(prompt_list, pad_token_id: int,
                bucket: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Right-pad a list of int lists/arrays to a bucketed max length."""
    lens = np.array([len(p) for p in prompt_list], dtype=np.int32)
    P = max(int(np.max(lens)), 1)
    P = ((P + bucket - 1) // bucket) * bucket
    out = np.full((len(prompt_list), P), pad_token_id, dtype=np.int32)
    for i, p in enumerate(prompt_list):
        out[i, : len(p)] = np.asarray(p, dtype=np.int32)
    return out, lens
