#!/usr/bin/env python3
"""Smoke run of the areal_tpu_torch port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):

 (a) card: print its name and power limit, build the CUDA kernels from the
     sources in this checkout (one nvcc per source, in parallel, sm_90a) and
     print ptxas's registers and spills for each kernel instance; the
     tensor-core instances (bf16, fp16) must not spill;
 (b) K1, the packed flash-attention kernel, against its plain PyTorch
     version computed in float32 on the same bf16 inputs: the main-path
     shape (B=8, T=S=512, 14/2 heads of 64, packed segments and pad rows),
     a head_dim-128 GQA case (28/4 heads) and a ragged T=200. Tolerance: one
     bf16 ulp at the output's largest magnitude (2**-8 * max|ref|); pad rows
     exactly 0; nothing NaN. Times the kernel, the plain version and SDPA
     (a yardstick only; the port never calls it);
 (c) the slice: Qwen2.5-0.5B at full width in bf16 with weights from a
     seed, behind the port's GenerationServer on a free localhost port.
     Eight concurrent POST /generate requests (prompts of 100-900 tokens,
     greedy and temperature/top-p mixed) each with a 192-token budget: the
     server's 128-token chunk answers first, then continuations with the
     same rid fetch the remaining 64 from the retained KV. Then one greedy
     request twice, alone. Checks reply lengths, finite logprobs <= 0,
     greedy repeatability, K1 launches == n_layers per prefill, and no
     prefill for the continuations;
 (d) the prefill's last logits through K1 against the same prefill through
     the plain attention on the card (tolerance: 5% of the largest |logit|;
     the plain attention rounds scores and probabilities to bf16, K1 keeps
     scores and the softmax in f32 and rounds only P before P V, and 24
     layers carry the difference forward);
 (e) where the time goes: warm prefill and decode-step times at the
     slice's widest prefill, K1's share of the prefill's device time, and
     the device's idle share during decode (from torch.profiler);
 (f) K2 (dk, dv) and K3 (dq), the flash-attention backward kernels (both on
     tensor cores for bf16), against their plain PyTorch version computed
     in float32 on the same bf16 inputs (K1's out and logsumexp, a random
     dO): the train shape (B=2, T=S=1792, 14/2 heads of 64, packed segments
     with pad tails), D=128 with GQA (28/4 heads) and a ragged T=200.
     Tolerance: two bf16 ulps at each gradient's largest magnitude (2**-7 *
     max|ref|; the kernels and the plain version both sum in f32 from the
     same bf16 inputs and round once); pad rows and columns exactly 0;
     nothing NaN. Times K2, K3, the plain backward and SDPA's backward at
     the train shape, and counts the tile pairs K1, K2 and K3 execute there
     against the causal walk's (K3 must execute fewer);
 (g) the train slice: PPO actor train steps of Qwen2.5-0.5B at full width
     and depth (bf16 compute, f32 masters, weights from seed 0) on
     bench.py's batch and recipe (32 trajectories, 27,554 tokens, cap 4096
     tokens per micro-batch -> 8 micro-batches of [2, 1792]; "dots" remat,
     log-prob chunks of 512, AdamW lr 1e-5 with bf16 moments). One warm-up
     step and 3 timed ones: trained tokens/s, ms per step, the fwd-bwd /
     optimizer split, peak memory, the tile pairs K1, K2 and K3 execute on
     the micro-batches against the causal walk's. Checks finite loss and
     grad norm > 0, moved parameters, K2 and K3 launched layers x
     micro-batches x steps times, and K1 twice that (the "dots" remat
     reruns K1 in the backward);
 (h) one micro-batch's loss and per-parameter grad norms through K1-K3
     against the same micro-batch through the plain attention, on the card;
     the micro-batch with the most positive-advantage tokens, since with
     random weights only those carry a gradient (tolerance: loss within 1%,
     each grad norm within 10%, gradient cosine >= 0.99; the plain
     attention rounds scores and probabilities to bf16, the kernels keep
     scores in f32 and round only P and dS before their products, and 24
     layers carry the difference forward and back);
 (i) where the time goes in one train step (torch.profiler): the device ms,
     share and launches of K1, K2 (its partial and reduction kernels), K3,
     GEMMs and the rest of the device time, the device's idle share and the
     kernels per step; K1, K2 and K3 must each show device time;
 (j) the trainer's model functions of the async-PPO recipe (the README's
     `ppo.use_decoupled_loss=true group_size=16`, the rest at defaults:
     kl_ctl 0.1, a critic, 4 PPO minibatches, advantage whitening), the
     engines of (g) freed first: an actor and a critic (same geometry with
     a value head; trunk from the actor's seed) with f32 masters and bf16
     moments, and a bf16 reference engine without optimizer. Batch: (g)'s
     32 trajectories as 2 prompts x 16 samples, behaviour logprobs set to
     ref_inf's output (importance ratios start at 1). One warm-up and 2
     timed steps of ref_inf -> actor_inf -> critic_inf -> actor_train ->
     critic_train: ms per MFC and per step, trained tokens/s, peak memory,
     K1-K3 launches per MFC. Checks: prox_logprobs == packed_ref_logprobs
     before the first update (exactly), the first actor minibatch's
     importance weight within 2% of 1, finite losses, grad norms > 0,
     finite value moments, both models' parameters moved, no early stop,
     each inference MFC launches K1 24 x its micro-batches and no K2/K3,
     each train MFC K2 and K3 24 x its micro-batches and K1 twice that.
     Then actor_inf and one actor step with group_adv_norm (the host
     advantage path through train_batch), the same checks; before it, its
     first PPO minibatch's logprobs recomputed by engine.forward under the
     minibatch's own packing, printed against actor_inf's (which packed
     the whole batch) with the importance weight each gives; ref_inf's logprobs on one
     micro-batch's sequences through K1 against the plain attention
     (tolerance 0.3 nats: twice (d)'s logits bound, as a logprob is a logit
     minus a logsumexp); and the device ms and idle share of each MFC of
     one profiled step;
 (k) checkpoints at full width under a temporary directory (deleted): the
     actor's HF checkpoint loads into a new inference engine whose
     actor_inf logprobs equal the saved engine's exactly; the train state
     loads into a fresh engine, and one actor step on each gives equal
     masters. Seconds and bytes of each write and read;
 (l) one SFT train_step on the batch: finite loss and perplexity, K2 and
     K3 launched 24 x the micro-batches;
 (m) weight sync at full width, under a temporary directory (deleted): a
     port server in bf16 on the seed-0 weights, holding one retained KV
     state, swaps through POST /update_weights to (1) the trained actor's
     weights, published in bf16 by a TrainerWorker over "disk" (a native
     checkpoint), then (2) seed-1 weights, published over "stream" by a
     TrainerWorker on a bf16 inference engine in a second process (spawned;
     it builds the same seed-1 weights), while a client sends one greedy
     request at a time and a sampler reads the server's prefill and decode
     counters every 10 ms. Checks: each update answers 200 with its version
     and /health shows it; the KV store is empty after each swap; the live
     weights equal the published ones bit for bit; the disk swap changed
     some elements; every reply under load carries the old or the new
     version, the last one the new, and exactly the greedy tokens of its
     version's weights (the replies before the swap; a fresh server on the
     new weights). Then (3) an update from a dead endpoint answers 500 and
     leaves the version and the tokens as they were. Bytes, trainer-side
     publish seconds, seconds from the publish's start to the server's
     reply; for the stream the gather (d2h and CRCs, in the publisher's
     process), the server thread's legs (wire wait, CRCs with the
     reassembly, h2d with the layout conversion, the rest), the runner's
     decode ms per step and busy share before and during the update, the
     longest reply before and during it, and a replay of the cached publish
     into host memory (the transport alone); peak device memory and K1's
     launches per transport; K1 launched n_layers x the server's prefills.

The line before the last is the card's name and power limit, the line
before that the kernels' JSON record, and the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3, queued: bool = False) -> float:
    """Milliseconds per call of `fn` between CUDA events. With `queued`, the
    timed calls are enqueued behind a ~25 ms device-side sleep, so kernels
    shorter than their host launch path (tens of microseconds) run back to
    back and the events time the device, not the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(50_000_000)  # clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_report(log: str) -> list:
    """(kernel, type, head_dim, spill-store bytes, registers) of every
    kernel instance in an `nvcc -Xptxas -v` log."""
    out = []
    for m in re.finditer(r"Compiling entry function '(\w+)'.*?(\d+) bytes "
                         r"spill stores.*?Used (\d+) registers", log, re.S):
        name = m.group(1)
        kernel = re.search(r"(flash_(?:fwd|bwd)[a-z_]*?_kernel)I", name)
        dtype = ("bf16" if "__nv_bfloat16" in name else
                 "fp16" if "6__half" in name else "f32")
        dim = re.search(r"Li(\d+)E", name)
        out.append((kernel.group(1) if kernel else name, dtype,
                    int(dim.group(1)) if dim else None, int(m.group(2)),
                    int(m.group(3))))
    return out


# ---------------- (b) K1 against its plain version ----------------

def packed_inputs(B, T, Hq, Hkv, D, seed):
    """bf16 q/k/v on the card and int32 segment ids with several packed
    documents per row and a padded tail (pad rows have segment 0)."""
    gen = torch.Generator().manual_seed(seed)
    seg = torch.zeros(B, T, dtype=torch.int32)
    for b in range(B):
        pad = int(torch.randint(0, T // 8, (1,), generator=gen))
        cuts = sorted(torch.randint(1, T - pad, (3,), generator=gen).tolist())
        edges = [0] + cuts + [T - pad]
        for i in range(4):
            seg[b, edges[i]:edges[i + 1]] = i + 1
    q = torch.randn(B, T, Hq, D, generator=gen)
    k = torch.randn(B, T, Hkv, D, generator=gen)
    v = torch.randn(B, T, Hkv, D, generator=gen)
    dev = torch.device("cuda")
    return ([x.to(dev, torch.bfloat16) for x in (q, k, v)], seg.to(dev))


def check_k1(fa, B, T, Hq, Hkv, D, seed) -> dict:
    (q, k, v), seg = packed_inputs(B, T, Hq, Hkv, D, seed)
    out, lse = fa.flash_attention(q, k, v, seg, seg, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                            seg, seg)
    err = (out.float() - ref).abs().max().item()
    tol = 2.0 ** -8 * ref.abs().max().item()
    pad = seg == 0
    fin = torch.isfinite(ref_lse)
    lse_err = (lse[fin] - ref_lse[fin]).abs().max().item()
    rec = dict(B=B, T=T, Hq=Hq, Hkv=Hkv, D=D, max_abs_err=err, tol=tol,
               lse_max_abs_err=lse_err, pad_rows=int(pad.sum()))
    print("K1 check", json.dumps(rec), flush=True)
    check(not torch.isnan(out).any().item(), f"K1 NaN at {rec}")
    check(err <= tol, f"K1 disagrees with its plain version: {rec}")
    check(bool((out[pad] == 0).all().item()), f"K1 pad rows not 0: {rec}")
    check(torch.equal(torch.isfinite(lse), fin) and lse_err <= 1e-4,
          f"K1 logsumexp disagrees: {rec}")
    return rec


def kept_mask(seg):
    """[B, T, T] bool: the (row, column) pairs the kernels keep."""
    T = seg.shape[1]
    keep = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0)
    return keep & torch.ones(T, T, dtype=torch.bool, device=seg.device).tril()


def bound(flops: int, nbytes: int) -> dict:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes)


def k1_record(fa, B, T, Hq=14, Hkv=2, D=64, seed=0) -> dict:
    """Times at one shape, and the bound of the same work."""
    (q, k, v), seg = packed_inputs(B, T, Hq, Hkv, D, seed)
    kernel_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, seg, seg),
                        queued=True)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, seg, seg),
                       queued=True)
    keep = kept_mask(seg)
    pairs = int(keep.sum())  # (row, column) pairs this data needs, per head
    flops = 4 * D * Hq * pairs  # q.k and p.v, 2 flops per multiply-add
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) \
        + 4 * 2 * seg.numel() + 4 * B * Hq * T  # q,k,v,o bf16; segs; lse
    # The yardstick: one PyTorch call of the same function (the port never
    # calls it). Its rows with no valid key come out NaN; only timed.
    mask = keep[:, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), queued=True)
    return dict(B=B, T=T, kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, **bound(flops, nbytes))


# ---------------- (f) K2 and K3 against their plain version ----------------

def bwd_inputs(fa, B, T, Hq, Hkv, D, seed):
    """q, k, v, segment ids, K1's out and lse, and a random dO (bf16)."""
    (q, k, v), seg = packed_inputs(B, T, Hq, Hkv, D, seed)
    out, lse = fa.flash_attention(q, k, v, seg, seg, return_lse=True)
    gen = torch.Generator().manual_seed(seed + 100)
    dout = torch.randn(q.shape, generator=gen).to("cuda", torch.bfloat16)
    return q, k, v, seg, out, lse, dout


def check_bwd(fa, B, T, Hq, Hkv, D, seed) -> dict:
    q, k, v, seg, out, lse, dout = bwd_inputs(fa, B, T, Hq, Hkv, D, seed)
    got = fa.flash_attention_bwd(q, k, v, seg, seg, out, lse, dout)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), seg,
                                       seg, out.float(), lse, dout.float())
    pad = seg == 0
    rec = dict(B=B, T=T, Hq=Hq, Hkv=Hkv, D=D, pad_rows=int(pad.sum()))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        err = (a.float() - b).abs().max().item()
        tol = 2.0 ** -7 * b.abs().max().item()
        rec[f"{name}_max_abs_err"], rec[f"{name}_tol"] = err, tol
        check(not torch.isnan(a).any().item(), f"{name} NaN at {rec}")
        check(err <= tol, f"{name} disagrees with the plain backward: {rec}")
        check(bool((a[pad] == 0).all().item()), f"{name} pad rows not 0: {rec}")
    print("K2/K3 check", json.dumps(rec), flush=True)
    return rec


def kernel_tile_pairs(fa, seg, D: int) -> dict:
    """(executed, causal-walk) tile pairs per head of K1, K2 and K3 at head
    dim D, each at its own (q, kv) tile sizes: the segment-range skip at
    work."""
    return {"k1": fa.tile_pairs(seg, seg, True, 64, 64),
            "k2": fa.tile_pairs(seg, seg, True, 4096 // D, 64),
            "k3": fa.tile_pairs(seg, seg, True, 64, 4096 // D)}


def bwd_records(fa, B=2, T=1792, Hq=14, Hkv=2, D=64, seed=0) -> dict:
    """Times of K2, K3, the plain backward and SDPA's backward at one shape,
    with each kernel's bound."""
    q, k, v, seg, out, lse, dout = bwd_inputs(fa, B, T, Hq, Hkv, D, seed)
    scale = D ** -0.5
    di = fa.backward_di(out, dout)
    args = (q, k, v, seg, seg, dout, lse, di, True, scale)
    k3_ms = cuda_ms(lambda: fa.launch_bwd_dq(*args), queued=True)
    k2_ms = cuda_ms(lambda: fa.launch_bwd_dkv(*args), queued=True)
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, seg, seg, out, lse, dout), iters=5, warmup=1, queued=True)
    keep = kept_mask(seg)
    pairs = Hq * int(keep.sum())  # kept pairs over all q heads
    qkv = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, dO, k, v in bf16
    rows = 4 * 2 * B * Hq * T + 4 * 2 * seg.numel()  # lse, di; segment ids
    k2 = bound(4 * 2 * D * pairs, qkv + rows + 2 * (k.numel() + v.numel()))
    k3 = bound(3 * 2 * D * pairs, qkv + rows + 2 * q.numel())
    # The yardstick: SDPA's backward over the same bool mask (the port never
    # calls it; its fully masked rows are NaN, so it is only timed).
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep[:, None], enable_gqa=True)
    g = dout.transpose(1, 2)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        o, (qt, kt, vt), g, retain_graph=True), queued=True)
    tiles = kernel_tile_pairs(fa, seg, D)
    check(tiles["k3"][0] < tiles["k3"][1],
          f"K3 executes no fewer tile pairs than the causal walk: {tiles}")
    return {"B": B, "T": T, "plain_bwd_ms": plain_ms,
            "sdpa_bwd_ms": library_ms,
            "tile_pairs_executed_vs_causal": tiles,
            "flash_attention_bwd_dkv": dict(kernel_ms=k2_ms, **k2),
            "flash_attention_bwd_dq": dict(kernel_ms=k3_ms, **k3)}


# ---------------- (c) the slice ----------------

def post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def check_reply(r: dict, n: int, eos: int, what: str) -> None:
    ids, lps = r["output_ids"], r["output_logprobs"]
    check(len(ids) == len(lps), f"{what}: ids/logprobs lengths differ")
    if r["finished"]:
        check(0 < len(ids) <= n and ids[-1] == eos, f"{what}: bad EOS reply")
    else:
        check(len(ids) == n, f"{what}: {len(ids)} tokens, expected {n}")
    lp = torch.tensor(lps, dtype=torch.float64)
    check(bool(torch.isfinite(lp).all()) and bool((lp <= 0).all()),
          f"{what}: logprobs not finite and <= 0")


def run_slice(fa, cfg, params, eos):
    from areal_tpu_torch.system.generation_server import (
        GenerationServer,
        GenerationServerConfig,
    )

    server = GenerationServer(
        GenerationServerConfig(chunk_tokens=128, eos_token_id=eos,
                               pad_token_id=eos, batch_window_ms=20),
        cfg, params,
    )
    url = server.start()
    try:
        gen = torch.Generator().manual_seed(1)
        lens = [100, 231, 377, 456, 598, 640, 777, 900]
        prompts = [torch.randint(0, eos, (n,), generator=gen).tolist()
                   for n in lens]
        gconfigs = [{"greedy": True} if i % 2 == 0 else
                    {"temperature": 0.7 + 0.1 * i, "top_p": 0.9}
                    for i in range(len(prompts))]
        budget, chunk = 192, 128

        fa.reset_launch_count()
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
            first = list(pool.map(lambda i: post(url, {
                "prompt_ids": prompts[i], "gconfig": gconfigs[i],
                "max_tokens": budget, "rid": f"r{i}"}), range(len(prompts))))
        for i, r in enumerate(first):
            check_reply(r, chunk, eos, f"request {i}")
        s1 = server.stats()
        check(s1["prefill_calls"] >= 1, "no prefill ran")
        check(fa.launch_count() == cfg.n_layers * s1["prefill_calls"],
              f"K1 launches {fa.launch_count()} != {cfg.n_layers} x "
              f"{s1['prefill_calls']} prefills")
        open_rows = [i for i, r in enumerate(first) if not r["finished"]]
        check(server.kv.count == len(open_rows), "retained states missing")
        print(f"first chunks: {len(first)} replies, {s1['prefill_calls']} "
              f"prefills, K1 launches {fa.launch_count()} = {cfg.n_layers} "
              f"per prefill, {server.kv.count} states retained", flush=True)

        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
            cont = list(pool.map(lambda i: post(url, {
                "prompt_ids": prompts[i] + first[i]["output_ids"],
                "gconfig": gconfigs[i], "max_tokens": budget - chunk,
                "rid": f"r{i}", "tokens_done": chunk}), open_rows))
        for i, r in zip(open_rows, cont):
            check_reply(r, budget - chunk, eos, f"continuation {i}")
        s2 = server.stats()
        check(s2["prefill_calls"] == s1["prefill_calls"]
              and s2["prefill_tokens"] == s1["prefill_tokens"],
              "a continuation re-prefilled instead of reusing its KV")
        check(fa.launch_count() == cfg.n_layers * s1["prefill_calls"],
              "K1 launched during continuations")
        print(f"continuations: {len(cont)} replies from retained KV, "
              f"prefills still {s2['prefill_calls']}, K1 launches still "
              f"{fa.launch_count()}", flush=True)

        greedy = {"prompt_ids": prompts[3], "gconfig": {"greedy": True},
                  "max_tokens": 64}
        a, b = post(url, greedy), post(url, greedy)
        check(a["output_ids"] == b["output_ids"],
              "a repeated greedy request gave other tokens")
        wall = time.monotonic() - t0
        stats = server.stats()
        check(fa.launch_count() == cfg.n_layers * stats["prefill_calls"],
              "K1 launches != n_layers per prefill")
        launches = fa.launch_count()
    finally:
        server.stop()
    return stats, launches, wall, prompts


def time_breakdown(genmod, model, toks, lens, S, eos) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from areal_tpu_torch.api.model import GenerationHyperparameters
    from areal_tpu_torch.ops.sampling import sampling_from_gconfigs

    B, dev, steps = toks.shape[0], toks.device, 16
    state = genmod.prefill_state(model, toks, lens, S)
    prefill_ms = cuda_ms(lambda: genmod.prefill_state(model, toks, lens, S),
                         iters=3, warmup=1)
    sampling = sampling_from_gconfigs(
        [GenerationHyperparameters(temperature=0.9, top_p=0.9)] * B, device=dev)
    done = torch.zeros(B, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def decode():  # on a copy: decode_chunk_rows owns and updates its state
        return genmod.decode_chunk_rows(model, genmod.stack_states([state]),
                                        done, gen, sampling, steps, eos, eos)

    decode_ms = cuda_ms(decode, iters=2, warmup=1) / steps

    def device_events(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    pre = device_events(lambda: genmod.prefill_state(model, toks, lens, S))
    pre_us = sum(e.device_time for e in pre)
    k1_us = sum(e.device_time for e in pre if "flash_fwd" in e.name)
    dec = device_events(decode)
    dec_ms = sum(e.device_time for e in dec) / 1e3 / steps
    return {
        "B": B, "P": toks.shape[1], "prefill_ms": prefill_ms,
        "prefill_device_ms": pre_us / 1e3, "k1_share_of_prefill": k1_us / pre_us,
        "decode_ms_per_step": decode_ms, "decode_device_ms_per_step": dec_ms,
        "decode_device_idle_share": 1 - dec_ms / decode_ms,
        "decode_kernels_per_step": len(dec) / steps,
    }


# ---------------- (g) the train slice ----------------

def bench_batch(vocab: int):
    """bench.py's PPO batch (bench.py:98-124): 32 trajectories of ~250
    prompt + ~640 generated tokens, drawn in bench.py's order."""
    import numpy as np

    from areal_tpu_torch.api.data import SequenceSample
    from areal_tpu_torch.base.testing import bench_trajectory_dist

    n_seq = 32
    rng, plens, glens = bench_trajectory_dist(0, n_seq)
    seqlens = (plens + glens).astype(int)
    total = int(seqlens.sum())
    toks = rng.randint(2, vocab, total).astype(np.int32)
    pmask, lps = [], []
    for p, g in zip(plens, glens):
        pmask.append(np.concatenate([np.ones(p, np.int32), np.zeros(g, np.int32)]))
        lps.append(np.concatenate([np.zeros(p, np.float32),
                                   -rng.rand(g).astype(np.float32)]))
    return SequenceSample.from_default(
        ids=[f"b{i}" for i in range(n_seq)],
        data={
            "packed_input_ids": toks,
            "prompt_mask": np.concatenate(pmask),
            "packed_logprobs": np.concatenate(lps),
            "rewards": rng.rand(n_seq).astype(np.float32),
            "seq_no_eos_mask": np.zeros(n_seq, np.float32),
        },
        seqlens=seqlens.tolist(),
    )


def make_model(name: str, cfg, params, train: bool = True,
               device: str = "cuda"):
    """A Model on bench.py's backend settings (bench.py:56-96): bf16
    compute, f32 masters and AdamW lr 1e-5 with bf16 moments when
    training, "dots" remat, log-prob chunks of 512. Without ``train``, an
    inference engine that keeps ``params`` as they are."""
    from areal_tpu_torch.api.model import FinetuneSpec, Model, make_backend
    from areal_tpu_torch.api.train_config import OptimizerConfig
    from areal_tpu_torch.backend import torch_train  # noqa: F401 (registry)

    backend = make_backend(
        "torch_train" if train else "torch_inference",
        optimizer=OptimizerConfig(lr=1e-5, lr_scheduler_type="constant",
                                  warmup_steps_proportion=0.0,
                                  mu_dtype="bfloat16", nu_dtype="bfloat16"),
        device=device, compute_dtype="bfloat16", length_bucket=512,
        rows_bucket=4, seqs_bucket=16, remat="dots", logprob_chunk=512,
    )
    return backend.initialize(Model(name, (cfg, params)),
                              FinetuneSpec(1, 512, 64))


def build_trainer(cfg):
    """bench.py's backend and PPO recipe (bench.py:56-96) on the port."""
    from areal_tpu_torch.algorithms.ppo import (
        PPOActorInterface,
        PPOHyperparameters,
    )
    from areal_tpu_torch.models.transformer import init_params

    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    model = make_model("actor", cfg, params)
    del params  # the engine holds f32 masters
    hp = PPOHyperparameters(ppo_n_minibatches=1, adv_norm=True, kl_ctl=0.0,
                            disable_value=True)
    return model, PPOActorInterface(hp)


def run_train_slice(fa, cfg, model, iface, batch, spec, steps: int = 3) -> dict:
    from areal_tpu_torch.backend import microbatch as mbu

    eng = model.module
    mbs = mbu.split_into_microbatches(
        batch, spec, length_bucket=eng.length_bucket,
        rows_bucket=eng.rows_bucket, seqs_bucket=eng.seqs_bucket)
    n_mbs, shape, fill = len(mbs), mbs[0].layout.shape, mbu.pack_fill(mbs)
    check(n_mbs == 8 and shape == (2, 1792),
          f"packer gave {n_mbs} micro-batches of {shape}, expected 8 of (2, 1792)")
    tokens = int(batch.total_lens().sum())
    # The tile pairs K1-K3 execute on these micro-batches (per head and
    # layer) against the causal walk's.
    tiles = [kernel_tile_pairs(fa, torch.from_numpy(mb.grids["segment_ids"]),
                               cfg.head_dim) for mb in mbs]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = iface.train_step(model, batch, spec)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    watch = ["embedding.weight", "layers.0.wq.weight", "layers.23.w_down.weight"]
    before = {n: eng.params[n].detach().clone() for n in watch}
    eng.time_phases = True
    fa.reset_launch_count()
    stats, phases = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        stats.append(iface.train_step(model, batch, spec))
        phases.append(eng.last_phase_secs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launch_counts()
    eng.time_phases = False
    moved = {n: (eng.params[n].detach() - before[n]).abs().max().item()
             for n in watch}
    per = cfg.n_layers * n_mbs * steps
    rec = {
        "n_mbs": n_mbs, "mb_shape": list(shape), "pack_fill": fill,
        "tile_pairs_executed_vs_causal": {
            kern: [sum(t[kern][0] for t in tiles), sum(t[kern][1] for t in tiles)]
            for kern in tiles[0]},
        "tokens_per_step": tokens, "steps": steps,
        "trained_tokens_per_s": steps * tokens / wall,
        "ms_per_step": 1e3 * wall / steps, "warmup_step_s": warm_s,
        "fwd_bwd_ms": 1e3 * sum(p["fwd_bwd"] for p in phases) / steps,
        "optimizer_ms": 1e3 * sum(p["optimizer"] for p in phases) / steps,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": launches, "launches_expected_k2_k3": per,
        "loss": [s["actor_loss"] for s in stats],
        "grad_norm": [s["grad_norm"] for s in stats],
        "importance_weight": [s["importance_weight"] for s in stats],
        "warmup_loss": warm["actor_loss"], "param_max_abs_change": moved,
    }
    for s in stats:
        check(math.isfinite(s["actor_loss"]) and math.isfinite(s["grad_norm"])
              and s["grad_norm"] > 0, f"bad train stats {s}")
        check(s["n_ppo_steps"] == 1.0 and s["lr"] == 1e-5,
              f"unexpected step {s}")
    check(all(v > 0 for v in moved.values()), f"parameters did not move: {moved}")
    check(launches["flash_attention_bwd_dkv"] == per
          and launches["flash_attention_bwd_dq"] == per,
          f"K2/K3 launches {launches} != {per} "
          f"({cfg.n_layers} layers x {n_mbs} micro-batches x {steps} steps)")
    check(launches["flash_attention_fwd"] == 2 * per,
          f"K1 launches {launches['flash_attention_fwd']} != 2 x {per} "
          "(forward + the remat recompute)")
    return rec


# ---------------- (h) the backward through K1-K3 vs plain attention ----------------

def compare_attention_impls(model, iface, batch, spec) -> dict:
    from areal_tpu_torch.algorithms.ppo import _action_token_weight

    eng = model.module
    ub = eng.upload_uniform(batch, spec)
    eng.run_prep(ub, iface._prep_fn, scalars={"kl_coef": 0.0})
    # The micro-batch with the most positive-advantage tokens: with random
    # weights every ratio is far below 1 - eps_clip, so only tokens with a
    # positive advantage carry a gradient.
    positive = (ub.grids["advantages"] > 0).reshape(ub.n_mbs, -1).sum(-1)
    mb = int(positive.argmax())
    weight = _action_token_weight(ub.mbs[mb])
    res = {}
    for impl in ("auto", "reference"):
        eng.attn_impl = impl
        loss, stats = eng.accumulate_grads(ub, iface._loss_fn, [mb], [weight])
        grads = {n: p.grad.detach().clone() for n, p in eng.params.items()}
        res[impl] = (float(loss), float(stats["importance_weight_sum"]), grads)
        for p in eng.params.values():
            p.grad = None
    eng.attn_impl = "auto"
    (l_k, iw_k, g_k), (l_r, iw_r, g_r) = res["auto"], res["reference"]
    rel = {n: abs(g_k[n].norm().item() - g_r[n].norm().item())
           / max(g_r[n].norm().item(), 1e-30) for n in g_r}
    dot = sum((g_k[n].double() * g_r[n].double()).sum().item() for n in g_r)
    nk = math.sqrt(sum(g_k[n].double().pow(2).sum().item() for n in g_r))
    nr = math.sqrt(sum(g_r[n].double().pow(2).sum().item() for n in g_r))
    worst = max(rel, key=rel.get)
    rec = {"micro_batch": mb, "positive_advantage_tokens": int(positive[mb]),
           "loss_kernels": l_k, "loss_plain": l_r,
           "loss_rel_err": abs(l_k - l_r) / max(abs(l_r), 1e-30),
           "importance_weight_sum_kernels": iw_k,
           "importance_weight_sum_plain": iw_r,
           "grad_norm_kernels": nk, "grad_norm_plain": nr,
           "grad_cosine": dot / max(nk * nr, 1e-300),
           "max_grad_norm_rel_err": rel[worst], "worst_param": worst}
    print("train micro-batch K1-K3 vs plain attention", json.dumps(rec),
          flush=True)
    check(all(math.isfinite(x) for x in (l_k, nk)) and nk > 0,
          "non-finite loss or grads, or no gradient at all")
    check(rec["loss_rel_err"] <= 0.01, "loss through K1-K3 disagrees")
    check(rec["max_grad_norm_rel_err"] <= 0.1, "a grad norm disagrees")
    check(rec["grad_cosine"] >= 0.99, "grad directions disagree")
    return rec


# ---------------- (i) where the time goes in one train step ----------------

KERNEL_CLASSES = (
    # flash_fwd_kernel (f32) / flash_fwd_mma_kernel; flash_bwd_dkv_kernel
    # (f32) / flash_bwd_dkv_mma_kernel + flash_bwd_dkv_reduce_kernel
    ("K1", ("flash_fwd",)),
    ("K2", ("flash_bwd_dkv",)),
    ("K3", ("flash_bwd_dq",)),
    # cuBLAS's kernels on Hopper: nvjet_* (CUDA 12.8), else *gemm*/cutlass
    ("gemm", ("nvjet", "gemm", "cutlass", "xmma", "cublas")),
)


def train_breakdown(model, iface, batch, spec, step_ms: float) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iface.train_step(model, batch, spec)
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.device_time for e in events)
    shares = dict.fromkeys([c for c, _ in KERNEL_CLASSES] + ["rest"], 0.0)
    launches = dict.fromkeys(shares, 0)
    by_name: dict = {}
    for e in events:
        name = e.name.lower()
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(key in name for key in keys)), "rest")
        shares[cls] += e.device_time
        launches[cls] += 1
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.device_time
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    device_ms = total_us / 1e3
    for cls in ("K1", "K2", "K3"):
        check(shares[cls] > 0, f"{cls} shows no device time in the profile: "
              f"a kernel name is missing from KERNEL_CLASSES ({top})")
    return {
        "device_ms_per_step": device_ms, "step_ms": step_ms,
        "profiled_step_ms": profiled_ms,
        "device_idle_share": 1 - device_ms / step_ms,
        "kernels_per_step": len(events),
        "shares": {k: v / total_us for k, v in shares.items()},
        "device_ms": {k: v / 1e3 for k, v in shares.items()},
        "launches": launches,
        "top_kernels_ms": [(n, t / 1e3) for n, t in top],
    }


# ---------------- (j)-(l) the trainer's model functions ----------------

KERNEL_NAMES = ("flash_attention_fwd", "flash_attention_bwd_dkv",
                "flash_attention_bwd_dq")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Trainer:
    """The five model functions of the async-PPO recipe
    (experiments/ppo_math_exp.py:111 build_dfg with the README's
    ``ppo.use_decoupled_loss=true group_size=16`` and the other
    PPOHyperparameters at their defaults: kl_ctl 0.1, a critic, 4 PPO
    minibatches, advantage whitening) on three engines: the actor and the
    critic (f32 masters, bf16 moments) and the reference policy (bf16, no
    optimizer). Every call goes through ``mfc``, which times it and reads
    K1-K3's launches around it."""

    ORDER = ("ref_inf", "actor_inf", "critic_inf", "actor_train",
             "critic_train")

    def __init__(self, fa, cfg, device="cuda"):
        from areal_tpu_torch.algorithms.ppo import (
            LogprobInterface,
            PPOActorInterface,
            PPOCriticInterface,
            PPOHyperparameters,
        )
        from areal_tpu_torch.models.transformer import init_params

        self.fa, self.device = fa, device
        params = init_params(cfg, seed=0, device=device, dtype=torch.bfloat16)
        # The reference engine keeps these bf16 tensors; the actor copies
        # them into f32 masters.
        self.ref = make_model("ref", cfg, params, train=False, device=device)
        self.actor = make_model("actor", cfg, params, device=device)
        del params
        ccfg = dataclasses.replace(cfg, is_critic=True)
        # The critic's trunk draws the actor's seed-0 numbers, its value
        # head the next ones (init_params draws in module order).
        self.critic = make_model("critic", ccfg, init_params(
            ccfg, seed=0, device=device, dtype=torch.bfloat16), device=device)
        self.hp = PPOHyperparameters(use_decoupled_loss=True, group_size=16)
        self.ref_iface = LogprobInterface()
        self.actor_iface = PPOActorInterface(self.hp)
        self.critic_iface = PPOCriticInterface(self.hp)
        self.group_iface = PPOActorInterface(
            dataclasses.replace(self.hp, group_adv_norm=True))
        self.launches = dict.fromkeys(KERNEL_NAMES, 0)
        # Every optimizer step's stats, in order (train_batch runs through
        # train_uniform).
        self.steps = []
        eng = self.actor.module
        train_uniform = eng.train_uniform
        eng.train_uniform = lambda *a, **k: self.steps.append(
            train_uniform(*a, **k)) or self.steps[-1]

    def mfc(self, fn, *args):
        """(result, seconds, K1-K3 launches) of one call; the launches also
        add up into ``self.launches``, the trainer path's count."""
        self.fa.reset_launch_count()
        sync(self.device)
        t0 = time.perf_counter()
        out = fn(*args)
        sync(self.device)
        secs = time.perf_counter() - t0
        counts = {k: self.fa.launch_counts()[k] for k in KERNEL_NAMES}
        for k, v in counts.items():
            self.launches[k] += v
        return out, secs, counts

    def step(self, batch, spec):
        """One trainer step in DFG order; (stats, data, seconds and
        launches per MFC)."""
        from areal_tpu_torch.algorithms.ppo import attach_keys

        ref, t_ref, l_ref = self.mfc(self.ref_iface.inference, self.ref,
                                     batch, spec)
        prox, t_prox, l_prox = self.mfc(self.actor_iface.inference,
                                        self.actor, batch, spec)
        vals, t_val, l_val = self.mfc(self.critic_iface.inference,
                                      self.critic, batch, spec)
        data = attach_keys(batch, {**ref.data, **prox.data, **vals.data})
        a, t_a, l_a = self.mfc(self.actor_iface.train_step, self.actor, data,
                               spec)
        c, t_c, l_c = self.mfc(self.critic_iface.train_step, self.critic,
                               data, spec)
        secs = dict(zip(self.ORDER, (t_ref, t_prox, t_val, t_a, t_c)))
        launches = dict(zip(self.ORDER, (l_ref, l_prox, l_val, l_a, l_c)))
        return {"actor": a, "critic": c}, data, secs, launches


def n_micro_batches(eng, sample, spec, k=None) -> int:
    """How many micro-batches the engine packs ``sample`` into; with ``k``,
    summed over the sample's k PPO minibatches (the train_batch path)."""
    from areal_tpu_torch.backend import microbatch as mbu

    parts = sample.split(k=k)[0] if k else [sample]
    return sum(len(mbu.split_into_microbatches(
        p, spec, length_bucket=eng.length_bucket, rows_bucket=eng.rows_bucket,
        seqs_bucket=eng.seqs_bucket, fill_bucket=eng.fill_bucket))
        for p in parts if p.bs)


def trainer_batch(vocab: int):
    """bench_batch's 32 trajectories regrouped as 2 prompts x 16 samples,
    generated at version 0."""
    import numpy as np

    from areal_tpu_torch.api.data import SequenceSample

    b = bench_batch(vocab)
    return SequenceSample.from_default(
        ids=b.ids, data={**b.data, "version_start": np.zeros(b.bs, np.int32)},
        seqlens=b.total_lens().tolist(),
        metadata={"group": [f"p{i // 16}" for i in range(b.bs)]})


def check_launches(name: str, counts: dict, n_mbs: int, layers: int,
                   train: bool) -> None:
    want = {"flash_attention_fwd": (2 if train else 1) * layers * n_mbs,
            "flash_attention_bwd_dkv": layers * n_mbs if train else 0,
            "flash_attention_bwd_dq": layers * n_mbs if train else 0}
    check(counts == want, f"{name}: K1-K3 launches {counts}, expected {want} "
          f"({layers} layers x {n_mbs} micro-batches)")


def check_train_stats(name: str, st: dict, loss_key: str) -> None:
    check(math.isfinite(st[loss_key]) and math.isfinite(st["grad_norm"])
          and st["grad_norm"] > 0, f"{name}: bad stats {st}")


def recompute_first_minibatch(tr, data, spec) -> dict:
    """The group step's first PPO minibatch (``data.split``, as its
    train_step splits it), its logprobs recomputed by ``engine.forward``,
    which packs it as ``train_batch`` does, with the weights unchanged;
    against actor_inf's prox logprobs, which packed the whole batch, on the
    same action tokens. Returns the largest difference and the importance
    weight the recompute gives."""
    import numpy as np

    from areal_tpu_torch.algorithms.ppo import _logprob_hook

    mb = data.split(k=min(tr.hp.ppo_n_minibatches, data.bs))[0][0]
    got = np.concatenate(tr.actor.module.forward(mb, spec,
                                                 post_hook=_logprob_hook))
    prox = np.asarray(mb.data["prox_logprobs"])
    lens = mb.total_lens()
    doc_first = np.zeros(len(prox), bool)
    doc_first[np.cumsum(lens) - lens] = True
    action = (np.asarray(mb.data["prompt_mask"]) == 0) & ~doc_first
    d = (got - prox)[action].astype(np.float64)
    return {"sequences": mb.bs, "action_tokens": int(action.sum()),
            "max_abs_diff": float(np.abs(d).max()),
            "tokens_differing": int((d != 0).sum()),
            "importance_weight": float(np.exp(d).mean())}


def run_trainer(fa, cfg, batch, spec, device="cuda", steps: int = 2):
    """(j): one warm-up and ``steps`` timed trainer steps, then one actor
    step with group_adv_norm (the host advantage path through
    train_batch), with the checks of chip_smoke's docstring."""
    import numpy as np

    from areal_tpu_torch.algorithms.ppo import attach_keys

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(fa, cfg, device)
    build_s = time.perf_counter() - t0
    act, crit, ref = tr.actor.module, tr.critic.module, tr.ref.module
    # Behaviour logprobs := the reference policy's, so the importance
    # ratios start at 1 and the decoupled loss has a real gradient.
    ref_lp, _, _ = tr.mfc(tr.ref_iface.inference, tr.ref, batch, spec)
    batch = attach_keys(batch, {
        "packed_logprobs": ref_lp.data["packed_ref_logprobs"]})
    n_inf = n_micro_batches(ref, batch, spec)
    n_actor = n_micro_batches(act, batch, dataclasses.replace(
        spec, n_mbs=max(spec.n_mbs or 1, tr.hp.ppo_n_minibatches)))
    n_critic = n_micro_batches(crit, batch, spec, k=tr.hp.ppo_n_minibatches)
    expect_mbs = {"ref_inf": n_inf, "actor_inf": n_inf, "critic_inf": n_inf,
                  "actor_train": n_actor, "critic_train": n_critic}
    watch = ["embedding.weight", "layers.0.wq.weight",
             f"layers.{cfg.n_layers - 1}.w_down.weight"]
    before = {m: {n: e.params[n].detach().clone() for n in watch}
              for m, e in (("actor", act), ("critic", crit))}
    before["critic"]["value_head.weight"] = \
        crit.params["value_head.weight"].detach().clone()

    records = []
    for i in range(1 + steps):
        n_opt = len(tr.steps)
        t0 = time.perf_counter()
        stats, data, secs, launches = tr.step(batch, spec)
        wall = time.perf_counter() - t0
        if i == 0:
            prox = data.data["prox_logprobs"]
            refd = data.data["packed_ref_logprobs"]
            diff = float(np.abs(prox - refd).max())
            print("trainer: prox_logprobs vs packed_ref_logprobs before the "
                  f"first actor_train: max |diff| {diff}", flush=True)
            check(np.array_equal(prox, refd), "prox_logprobs != "
                  "packed_ref_logprobs before any update (same bf16 weights, "
                  "same packing, deterministic kernels)")
            first = tr.steps[n_opt]
            iw = first["importance_weight_sum"] / max(first["n_action_tokens"], 1)
            print(f"trainer: first actor minibatch importance weight {iw}",
                  flush=True)
            check(abs(iw - 1) <= 0.02, f"first importance weight {iw} not "
                  "within 2% of 1")
        check_train_stats("actor_train", stats["actor"], "actor_loss")
        check_train_stats("critic_train", stats["critic"], "critic_loss")
        check(stats["actor"]["n_ppo_steps"] == tr.hp.ppo_n_minibatches,
              f"actor early-stopped: {stats['actor']}")
        check(math.isfinite(stats["critic"]["value_mean"])
              and math.isfinite(stats["critic"]["value_var"]),
              f"critic moments not finite: {stats['critic']}")
        for name in Trainer.ORDER:
            check_launches(name, launches[name], expect_mbs[name],
                           cfg.n_layers, train=name.endswith("train"))
        records.append({"wall_s": wall, "secs": secs, "launches": launches,
                        "actor": stats["actor"], "critic": stats["critic"]})
    moved = {m: {n: (e.params[n].detach() - before[m][n]).abs().max().item()
                 for n in before[m]} for m, e in (("actor", act),
                                                  ("critic", crit))}
    check(all(v > 0 for d in moved.values() for v in d.values()),
          f"parameters did not move: {moved}")

    # The host path: group-normalised advantages, minibatches through
    # train_batch, after a fresh actor_inf (as in the DFG).
    prox, _, _ = tr.mfc(tr.actor_iface.inference, tr.actor, data, spec)
    data = attach_keys(data, prox.data)
    recompute = recompute_first_minibatch(tr, data, spec)
    n_group = n_micro_batches(act, data, spec, k=tr.hp.ppo_n_minibatches)
    before = {n: act.params[n].detach().clone() for n in watch}
    n_opt = len(tr.steps)
    gstats, gsecs, glaunch = tr.mfc(tr.group_iface.train_step, tr.actor, data,
                                    spec)
    check_train_stats("actor_train (group_adv_norm)", gstats, "actor_loss")
    check_launches("actor_train (group_adv_norm)", glaunch, n_group,
                   cfg.n_layers, train=True)
    check(gstats["n_ppo_steps"] == tr.hp.ppo_n_minibatches,
          f"group step early-stopped: {gstats}")
    first = tr.steps[n_opt]
    giw = first["importance_weight_sum"] / max(first["n_action_tokens"], 1)
    recompute["train_step_importance_weight"] = giw
    recompute["train_step_action_tokens"] = first["n_action_tokens"]
    print("group step: prox logprobs of the first minibatch recomputed under "
          "its own packing", json.dumps(recompute), flush=True)
    check(abs(giw - 1) <= 0.02, f"group step: first importance weight {giw}")
    gmoved = {n: (act.params[n].detach() - before[n]).abs().max().item()
              for n in watch}
    check(all(v > 0 for v in gmoved.values()),
          f"group step: parameters did not move: {gmoved}")

    timed = records[1:]
    tokens = int(batch.total_lens().sum())
    step_s = sum(r["wall_s"] for r in timed) / len(timed)
    rec = {
        "tokens_per_step": tokens, "timed_steps": len(timed),
        "build_s": build_s, "warmup_step_s": records[0]["wall_s"],
        "ms_per_step": 1e3 * step_s,
        "trained_tokens_per_s": tokens / step_s,
        "ms_per_mfc": {n: 1e3 * sum(r["secs"][n] for r in timed) / len(timed)
                       for n in Trainer.ORDER},
        "micro_batches_per_mfc": expect_mbs,
        "launches_per_mfc": timed[-1]["launches"],
        "group_adv_norm_step": {"ms": 1e3 * gsecs, "micro_batches": n_group,
                                "launches": glaunch,
                                "actor_loss": gstats["actor_loss"],
                                "grad_norm": gstats["grad_norm"],
                                "first_importance_weight": giw,
                                "prox_recompute": recompute,
                                "param_max_abs_change": gmoved},
        "actor": [{k: r["actor"][k] for k in ("actor_loss", "grad_norm",
                                              "importance_weight", "mean_kl",
                                              "n_ppo_steps")} for r in records],
        "critic": [{k: r["critic"][k] for k in ("critic_loss", "grad_norm",
                                                "value_mean", "value_var")}
                   for r in records],
        "param_max_abs_change": moved,
    }
    if torch.device(device).type == "cuda":
        rec["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 2**30
    return tr, batch, data, rec


def compare_ref_inf(tr, batch, spec) -> dict:
    """ref_inf's logprobs on the first micro-batch's sequences through K1
    against the same through the plain attention (attn_impl="reference").
    Tolerance 0.3 nats: phase (d) holds the prefill's logits through K1 to
    5% of max |logit| (~3 for these weights, so ~0.15) of the plain
    attention's, and a logprob is a logit minus a logsumexp, each carrying
    that error."""
    import numpy as np

    from areal_tpu_torch.backend import microbatch as mbu

    eng = tr.ref.module
    mb = mbu.split_into_microbatches(
        batch, spec, length_bucket=eng.length_bucket,
        rows_bucket=eng.rows_bucket, seqs_bucket=eng.seqs_bucket)[0]
    sub = batch.select_idx(mb.sample_indices)
    got = tr.ref_iface.inference(tr.ref, sub, spec).data["packed_ref_logprobs"]
    eng.attn_impl = "reference"
    try:
        ref = tr.ref_iface.inference(tr.ref, sub, spec).data[
            "packed_ref_logprobs"]
    finally:
        eng.attn_impl = "auto"
    err = np.abs(got - ref)
    rec = {"sequences": sub.bs, "tokens": int(sub.total_lens().sum()),
           "max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
           "tol": 0.3, "max_abs_ref": float(np.abs(ref).max())}
    print("ref_inf logprobs K1 vs plain attention", json.dumps(rec), flush=True)
    check(np.isfinite(got).all() and got.shape == ref.shape,
          "ref_inf logprobs not finite / wrong shape")
    check(np.array_equal(got == 0, ref == 0), "zero (masked) slots differ")
    check(rec["max_abs_err"] <= rec["tol"],
          "ref_inf through K1 disagrees with the plain attention")
    return rec


def run_checkpoints(tr, cfg, batch, data, spec, tmp: str,
                    device="cuda") -> dict:
    """(k), under ``tmp``: the actor's HF checkpoint into a new inference
    engine (its logprobs equal the saved engine's), and the train state
    into a fresh engine (one actor step on ``data`` on each gives equal
    masters)."""
    import numpy as np

    from areal_tpu_torch.algorithms.ppo import PPOActorInterface
    from areal_tpu_torch.models.hf import load_hf_checkpoint
    from areal_tpu_torch.models.transformer import init_params

    def timed(fn, *args):
        sync(device)
        t0 = time.perf_counter()
        out = fn(*args)
        sync(device)
        return out, time.perf_counter() - t0

    def du(path: str) -> int:
        return sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))

    rec = {}
    hf_dir, st_dir = os.path.join(tmp, "hf"), os.path.join(tmp, "train_state")
    _, rec["hf_write_s"] = timed(tr.actor_iface.save, tr.actor, hf_dir)
    rec["hf_bytes"] = du(hf_dir)
    (lcfg, lparams), rec["hf_read_s"] = timed(load_hf_checkpoint, hf_dir,
                                              device)
    check(lcfg == cfg, f"checkpoint config {lcfg} != {cfg}")
    loaded = make_model("loaded", lcfg, lparams, train=False, device=device)
    del lparams
    saved_lp, _, _ = tr.mfc(tr.actor_iface.inference, tr.actor, batch, spec)
    loaded_lp, _, _ = tr.mfc(tr.actor_iface.inference, loaded, batch, spec)
    a, b = saved_lp.data["prox_logprobs"], loaded_lp.data["prox_logprobs"]
    rec["hf_logprobs_max_abs_diff"] = float(np.abs(a - b).max())
    check(np.array_equal(a, b), "the loaded checkpoint's actor_inf logprobs "
          "differ from the saved engine's")
    del loaded

    _, rec["train_state_write_s"] = timed(tr.actor.module.save_train_state,
                                          st_dir)
    rec["train_state_bytes"] = du(st_dir)
    fresh = make_model("fresh", cfg, init_params(
        cfg, seed=1, device=device, dtype=torch.bfloat16), device=device)
    _, rec["train_state_read_s"] = timed(fresh.module.load_train_state, st_dir)
    check(fresh.module.opt_step_count == tr.actor.module.opt_step_count,
          "step count not restored")
    for model in (tr.actor, fresh):
        st, _, _ = tr.mfc(PPOActorInterface(tr.hp).train_step, model, data,
                          spec)
        check_train_stats("train_state step", st, "actor_loss")
    pa, pb = tr.actor.module.params, fresh.module.params
    rec["train_state_masters_max_abs_diff"] = max(
        (pa[n] - pb[n]).abs().max().item() for n in pa)
    check(all(torch.equal(pa[n], pb[n]) for n in pa),
          "masters differ after a train step from a restored train state: "
          f"max |diff| {rec['train_state_masters_max_abs_diff']}")
    print("checkpoints", json.dumps(rec), flush=True)
    return rec


def run_sft(tr, cfg, batch, spec) -> dict:
    """(l): one SFT train_step on the batch through train_batch."""
    from areal_tpu_torch.algorithms.sft import SFTInterface

    n = n_micro_batches(tr.actor.module, batch, spec)
    st, secs, launches = tr.mfc(SFTInterface().train_step, tr.actor, batch,
                                spec)
    check(math.isfinite(st["loss"]) and math.isfinite(st["ppl"])
          and st["grad_norm"] > 0, f"bad SFT stats {st}")
    check_launches("sft", launches, n, cfg.n_layers, train=True)
    rec = {"ms": 1e3 * secs, "micro_batches": n, "launches": launches,
           "loss": st["loss"], "ppl": st["ppl"], "grad_norm": st["grad_norm"]}
    print("sft", json.dumps(rec), flush=True)
    return rec


def trainer_breakdown(tr, batch, spec) -> dict:
    """Device ms, wall ms and the device's idle share of each MFC of one
    trainer step (torch.profiler, device activity only: the host-side
    events of a train MFC, hundreds of thousands, take longer to collect
    than the step)."""
    from torch.profiler import ProfilerActivity, profile

    from areal_tpu_torch.algorithms.ppo import attach_keys

    out, data = {}, batch

    def run(name, fn, *args):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn(*args)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        dev = sum(e.device_time for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        check(dev > 0, f"{name}: the profiler shows no device time")
        out[name] = {"wall_ms": wall, "device_ms": dev,
                     "device_idle_share": 1 - dev / wall}
        return res

    ref = run("ref_inf", tr.ref_iface.inference, tr.ref, data, spec)
    prox = run("actor_inf", tr.actor_iface.inference, tr.actor, data, spec)
    vals = run("critic_inf", tr.critic_iface.inference, tr.critic, data, spec)
    data = attach_keys(data, {**ref.data, **prox.data, **vals.data})
    run("actor_train", tr.actor_iface.train_step, tr.actor, data, spec)
    run("critic_train", tr.critic_iface.train_step, tr.critic, data, spec)
    wall = sum(v["wall_ms"] for v in out.values())
    dev = sum(v["device_ms"] for v in out.values())
    out["step"] = {"wall_ms": wall, "device_ms": dev,
                   "device_idle_share": 1 - dev / wall}
    return out


# ---------------- (m) weight sync ----------------

def post_json(url: str, path: str, body: dict, timeout: float = 600):
    """(HTTP status, reply) of one POST, error statuses included."""
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def health(url: str) -> dict:
    with urllib.request.urlopen(url + "/health", timeout=60) as r:
        return json.loads(r.read())


def mem_reset(device):
    """Start a peak-memory window; returns the GB allocated now (None off
    the card)."""
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2 ** 30


def mem_peak(device):
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 2 ** 30


def stream_publisher(conn, cfg, tmp: str, exp: str, trial: str,
                     version: int, device: str) -> None:
    """(m)'s trainer side of the stream, in a process of its own, so that
    only the server's legs share the server's process: a bf16 inference
    engine on the seed-1 weights behind a TrainerWorker that publishes over
    "stream". On ``conn`` it sends ("ready", None), takes "publish", sends
    ("published", seconds), takes "close" and sends ("closed", stats); on
    a failure it sends ("error", traceback)."""
    import traceback

    try:
        from areal_tpu_torch.api.train_config import WeightSyncConfig
        from areal_tpu_torch.base import name_resolve
        from areal_tpu_torch.models.transformer import init_params
        from areal_tpu_torch.system.trainer_worker import (
            TrainerWorker,
            TrainerWorkerConfig,
        )

        def expect(what: str) -> None:
            if not conn.poll(600):
                raise TimeoutError(f"no {what!r} from the parent in 600 s")
            got = conn.recv()
            if got != what:
                raise RuntimeError(f"expected {what!r}, got {got!r}")

        name_resolve.reconfigure(name_resolve.NameResolveConfig(
            type="nfs", nfs_record_root=os.path.join(tmp, "name_resolve")))
        src = make_model("stream_src", cfg, init_params(
            cfg, seed=1, device=device, dtype=torch.bfloat16), train=False,
            device=device)
        src.version.global_step = version
        w = TrainerWorker(TrainerWorkerConfig(
            experiment=exp, trial=trial,
            realloc_dir=os.path.join(tmp, "realloc"),
            weight_sync=WeightSyncConfig(transport="stream")),
            models={"actor": src})
        try:
            conn.send(("ready", None))
            expect("publish")
            mem_reset(device)
            t0 = time.perf_counter()
            w.publish_weights("actor")
            conn.send(("published", time.perf_counter() - t0))
            expect("close")
            pub = w._weight_publishers["actor"]
            done = pub.wait_complete(version, timeout=120)
            conn.send(("closed", {
                "gather_s": pub._cache[version].gather_secs if done else None,
                "peak_gb": mem_peak(device)}))
        finally:
            w.close()
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise


def from_publisher(conn, proc, what: str, timeout: float = 300):
    """The stream publisher's next message, which must be ``what``."""
    deadline = time.monotonic() + timeout
    while not conn.poll(0.5):
        check(proc.is_alive() and time.monotonic() < deadline,
              f"stream publisher: no {what!r} (exit code {proc.exitcode})")
    kind, val = conn.recv()
    check(kind == what, f"stream publisher sent {kind}: {val}")
    return val


def runner_window(timeline, a: float, b: float):
    """The server runner's progress between two perf_counter times, from
    the stats samples inside them: seconds, prefills, decode steps, decode
    ms per step and the share of the window spent in prefill and decode."""
    inside = [x for x in timeline if a <= x[0] <= b]
    if len(inside) < 2:
        return None
    (t0, p0, ps0, d0, ds0), (t1, p1, ps1, d1, ds1) = inside[0], inside[-1]
    return {"s": t1 - t0, "prefills": p1 - p0, "decode_steps": d1 - d0,
            "decode_ms_per_step": (1e3 * (ds1 - ds0) / (d1 - d0)
                                   if d1 > d0 else None),
            "busy": (ps1 - ps0 + ds1 - ds0) / (t1 - t0)}


def run_weight_sync(fa, cfg, actor, eos: int, tmp: str,
                    device="cuda") -> dict:
    """(m): a port server in bf16 on the seed-0 weights swaps to (1) the
    trained actor's weights published over ``disk`` by a TrainerWorker and
    (2) seed-1 weights published over ``stream`` by a TrainerWorker in a
    process of its own, while a client sends one greedy request at a time;
    then (3) an update from a dead endpoint fails. Checks and numbers as in
    the docstring."""
    import multiprocessing

    from areal_tpu_torch.api.train_config import WeightSyncConfig
    from areal_tpu_torch.base import name_resolve, names, network
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system.generation_server import (
        GenerationServer,
        GenerationServerConfig,
    )
    from areal_tpu_torch.system.trainer_worker import (
        TrainerWorker,
        TrainerWorkerConfig,
    )
    from areal_tpu_torch.system.weight_stream import WeightStreamConsumer

    exp, trial = "chip_smoke", "m"
    old_repo = name_resolve.DEFAULT_REPO
    name_resolve.reconfigure(name_resolve.NameResolveConfig(
        type="nfs", nfs_record_root=os.path.join(tmp, "name_resolve")))
    scfg = GenerationServerConfig(chunk_tokens=32, eos_token_id=eos,
                                  pad_token_id=eos, batch_window_ms=2)
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, eos, (n,), generator=gen).tolist()
               for n in (37, 150, 301)]
    v1 = actor.version.global_step
    v2 = v1 + 1

    def greedy(url, i):
        return post(url, {"prompt_ids": prompts[i],
                          "gconfig": {"greedy": True}, "max_tokens": 16})

    def same(live, want, what):
        check(set(live) == set(want) and all(
            live[k].dtype == want[k].dtype and torch.equal(live[k], want[k])
            for k in want), f"{what}: live weights != the published ones")

    # The stream's publisher starts first: it builds its engine while this
    # process computes the new version's greedy tokens on the same seed-1
    # weights with a fresh server, before the counts are reset (they are
    # the check's launches).
    ctx = multiprocessing.get_context("spawn")
    conn, child_conn = ctx.Pipe()
    proc = ctx.Process(target=stream_publisher, daemon=True,
                       name="stream-publisher",
                       args=(child_conn, cfg, tmp, exp, trial, v2, device))
    proc.start()
    server = None
    workers = []
    rec: dict = {}
    try:
        src_params = init_params(cfg, seed=1, device=device,
                                 dtype=torch.bfloat16)
        ref_server = GenerationServer(scfg, cfg, src_params, device)
        url = ref_server.start()
        try:
            want_new = [greedy(url, i)["output_ids"]
                        for i in range(len(prompts))]
        finally:
            ref_server.stop()
        del ref_server
        from_publisher(conn, proc, "ready")

        fa.reset_launch_count()
        server = GenerationServer(scfg, cfg, init_params(
            cfg, seed=0, device=device, dtype=torch.bfloat16), device)
        url = server.start()

        def retain_one_state():
            post(url, {"prompt_ids": prompts[1], "gconfig": {"greedy": True},
                       "max_tokens": 64, "rid": "m"})
            check(server.stats()["kv_states"] == 1, "no retained KV state")

        # (1) disk: the trained actor's masters in bf16
        retain_one_state()
        old = server.model.state_dict()  # swapped, never written: no copy
        workers.append(TrainerWorker(TrainerWorkerConfig(
            experiment=exp, trial=trial,
            realloc_dir=os.path.join(tmp, "realloc"),
            weight_sync=WeightSyncConfig(transport="disk")),
            models={"actor": actor}))
        path = os.path.join(tmp, "realloc", "actor", str(v1))
        resident = mem_reset(device)
        k1 = fa.launch_count()
        t0 = time.perf_counter()
        workers[-1].publish_weights("actor")
        publish_s = time.perf_counter() - t0
        status, body = post_json(url, "/update_weights",
                                 {"path": path, "version": v1})
        reply_s = time.perf_counter() - t0
        check(status == 200 and body["version"] == v1,
              f"disk update: {status} {body}")
        check(health(url)["version"] == v1, "disk: /health not at the new "
              "version")
        check(server.stats()["kv_states"] == 0, "disk: KV store not cleared")
        live = server.model.state_dict()
        same(live, workers[-1]._compute_dtype_params("actor"), "disk")
        changed = sum(int((live[k] != old[k]).sum()) for k in live)
        check(changed > 0, "disk: no element differs from the old weights")
        want_old = [greedy(url, i)["output_ids"] for i in range(len(prompts))]
        rec["disk"] = {
            "version": v1, "bytes": sum(os.path.getsize(os.path.join(path, f))
                                        for f in os.listdir(path)),
            "publish_s": publish_s, "publish_to_reply_s": reply_s,
            "server_update_s": body["latency_s"],
            "elements_changed": changed,
            "elements": sum(v.numel() for v in live.values()),
            "peak_gb": mem_peak(device), "resident_gb_before": resident,
            "k1_launches": fa.launch_count() - k1}
        del old, live
        print("weight sync disk", json.dumps(rec["disk"]), flush=True)

        # (2) stream, from the other process, under one-at-a-time greedy
        # traffic; a sampler records the runner's cumulative prefill and
        # decode counters every 10 ms
        retain_one_state()
        replies, timeline, stop = [], [], threading.Event()

        def load():
            i = 0
            while not stop.is_set() and i < 1000:
                t = time.perf_counter()
                r = greedy(url, i % len(prompts))
                replies.append((i % len(prompts), r, t, time.perf_counter()))
                i += 1

        def sample():
            while not stop.is_set():
                st = server.stats()
                timeline.append((time.perf_counter(), st["prefill_calls"],
                                 st["prefill_secs"], st["decode_steps"],
                                 st["decode_secs"]))
                time.sleep(0.01)

        k1 = fa.launch_count()
        threads = [threading.Thread(target=f, daemon=True)
                   for f in (load, sample)]
        t_load = time.perf_counter()
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        while len(replies) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        resident = mem_reset(device)
        t0 = time.perf_counter()
        conn.send("publish")
        publish_s = from_publisher(conn, proc, "published")
        endpoint = name_resolve.get(names.weight_stream(exp, trial, "actor"))
        t_post = time.perf_counter()
        status, body = post_json(url, "/update_weights",
                                 {"endpoint": endpoint, "version": v2})
        t_reply = time.perf_counter()
        reply_s = t_reply - t0
        n_swap = len(replies)
        deadline = time.monotonic() + 120
        while len(replies) < n_swap + 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        stop.set()
        for t in threads:
            t.join(timeout=120)
        check(not any(t.is_alive() for t in threads),
              "the load client or the sampler did not stop")
        check(status == 200 and body["version"] == v2,
              f"stream update: {status} {body}")
        versions = [r["version"] for _, r, _, _ in replies]
        check(set(versions) <= {v1, v2} and versions[-1] == v2,
              f"stream: reply versions {versions}")
        want = {v1: want_old, v2: want_new}
        wrong = [(i, r["version"]) for i, r, _, _ in replies
                 if r["output_ids"] != want[r["version"]][i]]
        check(not wrong, f"stream: replies with another version's tokens: "
              f"{wrong}")
        same(server.model.state_dict(), src_params, "stream")
        del src_params
        stats = server.stats()
        check(stats["kv_states"] == 0, "stream: KV store not cleared")
        # What generation felt: the replies that overlapped the update, and
        # the runner's progress before and during it.
        during = [b - a for _, _, a, b in replies if a < t_reply and b > t0]
        before = [b - a for _, _, a, b in replies if b <= t0]
        # The transport alone: a replay of the cached publish from the
        # other process into host memory, with no upload and no load.
        consumer = WeightStreamConsumer(endpoint, timeout_secs=600)
        try:
            t = time.perf_counter()
            consumer.fetch(v2)
            replay_s = time.perf_counter() - t
        finally:
            consumer.close()
        conn.send("close")
        publisher = from_publisher(conn, proc, "closed")
        proc.join(timeout=60)
        check(proc.exitcode == 0, f"stream publisher exit code {proc.exitcode}")
        legs = {k: stats[f"last_stream_{k}"] for k in
                ("wire_wait_secs", "digest_verify_secs", "upload_secs")}
        rec["stream"] = {
            "version": v2, "bytes": stats["last_stream_stream_bytes"],
            "publish_s": publish_s, "publish_to_reply_s": reply_s,
            "server_update_s": body["latency_s"],
            "wire_wait_s": legs["wire_wait_secs"],
            "checksum_s": legs["digest_verify_secs"],
            "upload_s": legs["upload_secs"],
            "other_s": body["latency_s"] - sum(legs.values()),
            "replies_old_new": [versions.count(v1), versions.count(v2)],
            "reply_s_before_max": max(before),
            "replies_during_update": len(during),
            "reply_s_during_max": max(during, default=0.0),
            "runner_before": runner_window(timeline, t_load, t0),
            "runner_during": runner_window(timeline, t_post, t_reply),
            "gather_s": publisher["gather_s"], "replay_fetch_s": replay_s,
            "peak_gb": mem_peak(device), "resident_gb_before": resident,
            "publisher_peak_gb": publisher["peak_gb"],
            "k1_launches": fa.launch_count() - k1}
        print("weight sync stream", json.dumps(rec["stream"]), flush=True)

        # (3) a dead endpoint: 500, the new weights stay live
        dead = f"tcp://127.0.0.1:{network.find_free_port()}"
        status, body = post_json(url, "/update_weights",
                                 {"endpoint": dead, "version": v2 + 1,
                                  "timeout": 2})
        check(status == 500 and body["version"] == v2
              and health(url)["version"] == v2,
              f"dead endpoint: {status} {body}")
        r = greedy(url, 0)
        check(r["version"] == v2 and r["output_ids"] == want_new[0],
              "dead endpoint: the served tokens changed")
        rec["failure"] = {"status": status, "version": body["version"],
                          "error": body["error"]}
        stats = server.stats()
        rec["k1_launches"] = fa.launch_count()
        rec["prefill_calls"] = stats["prefill_calls"]
        check(rec["k1_launches"] == cfg.n_layers * stats["prefill_calls"] > 0,
              f"weight sync: K1 launches {rec['k1_launches']} != "
              f"{cfg.n_layers} x {stats['prefill_calls']} prefills")
    finally:
        if server is not None:
            server.stop()
        for w in workers:
            w.close()
        if proc.is_alive():
            try:
                conn.send("close")
            except OSError:
                pass
            proc.join(timeout=30)
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=10)
        conn.close()
        name_resolve.DEFAULT_REPO = old_repo
    return rec


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card")
    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.models.config import qwen2_5_0_5b
    from areal_tpu_torch.models import generate as genmod
    from areal_tpu_torch.models.transformer import Transformer, init_params
    from areal_tpu_torch.ops import flash_attention as fa

    t_start = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # (a) build, one nvcc per source, together
    t0 = time.monotonic()
    libs = fa.build_libraries()
    ptxas = [rec for lib in libs.values()
             for rec in ptxas_report((lib.parent / "build.log").read_text())]
    print(f"built {', '.join(os.path.relpath(p) for p in libs.values())} in "
          f"{time.monotonic() - t0:.1f}s; ptxas (kernel, type, head_dim, "
          "spill-store bytes, registers):", json.dumps(ptxas), flush=True)
    # K1: 2 scalar f32 + 4 tensor-core; K2: 2 + 4 + 2 reductions; K3: 2 + 4
    check(len(ptxas) == 20, f"expected 20 kernel instances, ptxas shows {ptxas}")
    check(sorted((r[1], r[2]) for r in ptxas if r[0] == "flash_bwd_dq_mma_kernel")
          == [("bf16", 64), ("bf16", 128), ("fp16", 64), ("fp16", 128)],
          f"K3's tensor-core instances missing from {ptxas}")
    spills = [r for r in ptxas if r[1] != "f32" and r[3] > 0]
    check(not spills, f"tensor-core instances spill: {spills}")

    # (b) K1 against its plain version
    check_k1(fa, 8, 512, 14, 2, 64, seed=0)
    check_k1(fa, 2, 512, 28, 4, 128, seed=1)
    check_k1(fa, 3, 200, 14, 2, 64, seed=2)
    k1_train_check = check_k1(fa, 2, 1792, 14, 2, 64, seed=3)
    timing = k1_record(fa, 8, 512)
    timing_train = k1_record(fa, 2, 1792)
    print("K1 timing", json.dumps([timing, timing_train]), f"({card})",
          flush=True)

    # (c) the serving slice, through the server's HTTP entry point
    cfg = qwen2_5_0_5b()
    eos = 151643  # Qwen2.5's <|endoftext|>
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    stats, serve_launches, wall, prompts = run_slice(fa, cfg, params, eos)
    prefill_ms = 1e3 * stats["prefill_secs"] / stats["prefill_calls"]
    decode_ms = 1e3 * stats["decode_secs"] / stats["decode_steps"]
    tok_s = stats["generated_tokens"] / (stats["prefill_secs"]
                                         + stats["decode_secs"])
    print("slice", json.dumps({
        "prefill_calls": stats["prefill_calls"],
        "prefill_tokens": stats["prefill_tokens"],
        "prefill_ms_per_call": prefill_ms,
        "decode_ms_per_step": decode_ms,
        "generated_tokens": stats["generated_tokens"],
        "tokens_per_s": tok_s, "wall_s": wall, "k1_launches": serve_launches,
        "shapes": stats["shapes"]}), f"({card})", flush=True)

    # (d) prefill through K1 against the plain attention, same weights
    model = Transformer.from_params(cfg, params)
    padded, plens = genmod.pad_prompts(prompts, eos, bucket=128)
    toks = torch.from_numpy(padded).cuda()
    lens = torch.from_numpy(plens).cuda()
    S = padded.shape[1] + 128
    got = genmod.prefill_state(model, toks, lens, S)["last_logits"]
    ref = genmod.prefill_state(model, toks, lens, S,
                               attn_impl="reference")["last_logits"]
    diff = (got - ref).abs().max().item()
    tol = 0.05 * ref.abs().max().item()
    print("prefill last_logits K1 vs reference", json.dumps({
        "max_abs_err": diff, "tol": tol, "max_abs_ref": ref.abs().max().item(),
        "argmax_agree": (got.argmax(-1) == ref.argmax(-1)).float().mean().item(),
    }), flush=True)
    check(bool(torch.isfinite(got).all()) and got.shape == (8, cfg.vocab_size),
          "prefill logits not finite / wrong shape")
    check(diff <= tol, "prefill through K1 disagrees with the plain attention")

    # (e) where the time goes in serving
    print("breakdown", json.dumps(time_breakdown(genmod, model, toks, lens, S,
                                                 eos)), f"({card})", flush=True)
    del model, params, got, ref
    torch.cuda.empty_cache()

    # (f) K2 and K3 against their plain version
    bwd_train_check = check_bwd(fa, 2, 1792, 14, 2, 64, seed=0)
    check_bwd(fa, 2, 512, 28, 4, 128, seed=1)
    check_bwd(fa, 3, 200, 14, 2, 64, seed=2)
    bwd_timing = bwd_records(fa)
    print("K2/K3 timing", json.dumps(bwd_timing), f"({card})", flush=True)
    torch.cuda.empty_cache()

    # (g) the train slice, through PPOActorInterface.train_step
    model, iface = build_trainer(cfg)
    batch = bench_batch(cfg.vocab_size)
    spec = MicroBatchSpec(max_tokens_per_mb=4096)
    train = run_train_slice(fa, cfg, model, iface, batch, spec)
    print("train slice", json.dumps(train), f"({card})", flush=True)

    # (h) one micro-batch through K1-K3 against the plain attention
    compare_attention_impls(model, iface, batch, spec)

    # (i) where the time goes in one train step
    print("train breakdown", json.dumps(train_breakdown(
        model, iface, batch, spec, train["ms_per_step"])), f"({card})",
        flush=True)
    del model, iface  # (j) builds three engines of its own
    torch.cuda.empty_cache()

    # (j) trainer steps of the async-PPO recipe, then the host path
    t_trainer = time.monotonic()
    tr, tbatch, tdata, trainer = run_trainer(fa, cfg, trainer_batch(
        cfg.vocab_size), spec)
    print("trainer step", json.dumps(trainer), f"({card})", flush=True)
    compare_ref_inf(tr, tbatch, spec)
    print("trainer breakdown", json.dumps(trainer_breakdown(tr, tbatch, spec)),
          f"({card})", flush=True)

    # (k) checkpoints at full width, under a temporary directory
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ckpt = run_checkpoints(tr, cfg, tbatch, tdata, spec, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (l) one SFT step
    sft = run_sft(tr, cfg, tbatch, spec)
    print("trainer path", json.dumps({
        "launches": tr.launches, "checkpoints": ckpt, "sft_ms": sft["ms"],
        "phases_j_to_l_s": time.monotonic() - t_trainer,
        "script_s": time.monotonic() - t_start}), f"({card})", flush=True)

    # (m) weight sync: the trained actor over disk, a second model over the
    # stream, a dead endpoint; under a temporary directory
    t_sync = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sync_")
    try:
        wsync = run_weight_sync(fa, cfg, tr.actor, eos, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("weight sync", json.dumps({
        **wsync, "phase_m_s": time.monotonic() - t_sync,
        "script_s": time.monotonic() - t_start}), f"({card})", flush=True)

    lib_line = ("areal_tpu/ops/pallas/flash_attention.py:200 backward: the "
                "Pallas TPU library's {} :{} (pallas_call :{})")
    train_launches = train["launches"]
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "areal_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "areal_tpu/ops/pallas/flash_attention.py:200",
        "launches": serve_launches + train_launches["flash_attention_fwd"]
        + tr.launches["flash_attention_fwd"] + wsync["k1_launches"],
        "launches_by_path": {"serve": serve_launches,
                             "train": train_launches["flash_attention_fwd"],
                             "trainer": tr.launches["flash_attention_fwd"],
                             "weight_sync": wsync["k1_launches"]},
        "max_abs_err": k1_train_check["max_abs_err"],
        "ms": timing_train["kernel_ms"], "kernel_ms": timing_train["kernel_ms"],
        "plain_ms": timing_train["plain_ms"],
        "bound_ms": timing_train["bound_ms"],
        "bound_by": timing_train["bound_by"],
        "library_ms": timing_train["library_ms"],
    }]
    for name, fn, line, call, err in (
            ("flash_attention_bwd_dkv", "_flash_attention_bwd_dkv", 941, 1121,
             max(bwd_train_check["dk_max_abs_err"],
                 bwd_train_check["dv_max_abs_err"])),
            ("flash_attention_bwd_dq", "_flash_attention_bwd_dq", 1287, 1456,
             bwd_train_check["dq_max_abs_err"])):
        rec = bwd_timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "areal_tpu_torch/ops/csrc/flash_attention_bwd.cu",
            "replaces": lib_line.format(fn, line, call),
            "launches": train_launches[name] + tr.launches[name],
            "launches_by_path": {"train": train_launches[name],
                                 "trainer": tr.launches[name]},
            "max_abs_err": err,
            "ms": rec["kernel_ms"], "kernel_ms": rec["kernel_ms"],
            "plain_ms": bwd_timing["plain_bwd_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": bwd_timing["sdpa_bwd_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
