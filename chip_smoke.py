#!/usr/bin/env python3
"""Smoke run of the areal_tpu_torch port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):

 (a) card: print its name and power limit, build the CUDA kernels from the
     sources in this checkout (nvcc, sm_90a);
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
     them in f32, and 24 layers carry the difference forward);
 (e) where the time goes: warm prefill and decode-step times at the
     slice's widest prefill, K1's share of the prefill's device time, and
     the device's idle share during decode (from torch.profiler).

The line before the last is the card's name and power limit, the line
before that the kernels' JSON record, and the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import subprocess
import sys
import time
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


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def k1_record(fa, seed=0) -> dict:
    """Times at the main-path shape, and the bound of the same work."""
    B, T, Hq, Hkv, D = 8, 512, 14, 2, 64
    (q, k, v), seg = packed_inputs(B, T, Hq, Hkv, D, seed)
    kernel_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, seg, seg))
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, seg, seg))
    keep = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0)
    keep &= torch.ones(T, T, dtype=torch.bool, device=seg.device).tril()
    pairs = int(keep.sum())  # (row, column) pairs this data needs, per head
    flops = 4 * D * Hq * pairs  # q.k and p.v, 2 flops per multiply-add
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) \
        + 4 * 2 * seg.numel() + 4 * B * Hq * T  # q,k,v,o bf16; segs; lse
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    # The yardstick: one PyTorch call of the same function (the port never
    # calls it). Its rows with no valid key come out NaN; only timed.
    mask = keep[:, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    return dict(kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=library_ms, flops=flops, bytes=nbytes)


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
    k1_us = sum(e.device_time for e in pre if "flash_fwd_kernel" in e.name)
    dec = device_events(decode)
    dec_ms = sum(e.device_time for e in dec) / 1e3 / steps
    return {
        "B": B, "P": toks.shape[1], "prefill_ms": prefill_ms,
        "prefill_device_ms": pre_us / 1e3, "k1_share_of_prefill": k1_us / pre_us,
        "decode_ms_per_step": decode_ms, "decode_device_ms_per_step": dec_ms,
        "decode_device_idle_share": 1 - dec_ms / decode_ms,
        "decode_kernels_per_step": len(dec) / steps,
    }


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card")
    from areal_tpu_torch.models.config import qwen2_5_0_5b
    from areal_tpu_torch.models import generate as genmod
    from areal_tpu_torch.models.transformer import Transformer, init_params
    from areal_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # (a) build
    t0 = time.monotonic()
    lib = fa.build_library()
    ptxas = re.findall(r"flash_fwd_kernelI(\w+?)Li(\d+)E.*?(\d+) bytes spill "
                       r"stores.*?Used (\d+) registers",
                       (lib.parent / "build.log").read_text(), re.S)
    print(f"built {os.path.relpath(lib)} in {time.monotonic() - t0:.1f}s; "
          "ptxas (type, head_dim, spill-store bytes, registers):",
          json.dumps(ptxas), flush=True)

    # (b) K1 against its plain version
    main_rec = check_k1(fa, 8, 512, 14, 2, 64, seed=0)
    check_k1(fa, 2, 512, 28, 4, 128, seed=1)
    check_k1(fa, 3, 200, 14, 2, 64, seed=2)
    timing = k1_record(fa)
    print("K1 timing", json.dumps(timing), f"({card})", flush=True)

    # (c) the slice, through the server's HTTP entry point
    cfg = qwen2_5_0_5b()
    eos = 151643  # Qwen2.5's <|endoftext|>
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    stats, launches, wall, prompts = run_slice(fa, cfg, params, eos)
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
        "tokens_per_s": tok_s, "wall_s": wall, "k1_launches": launches,
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

    # (e) where the time goes
    print("breakdown", json.dumps(time_breakdown(genmod, model, toks, lens, S,
                                                 eos)), f"({card})", flush=True)

    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "areal_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "areal_tpu/ops/pallas/flash_attention.py:200",
        "launches": launches, "max_abs_err": main_rec["max_abs_err"],
        "ms": timing["kernel_ms"], "kernel_ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": timing["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
