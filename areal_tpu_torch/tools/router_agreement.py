"""How often bf16 rounding alone changes an MoE router's top-k choices.

    python -m areal_tpu_torch.tools.router_agreement [--tokens 1024]

One attention block at Qwen3-30B-A3B's width (hidden 2048, 32 q over 4 kv
heads of 128, qk-norm, RoPE) and its router (128 experts, top-8), weights
from a seed at N(0, 0.02) as ``models/transformer.py init_params`` draws
them, on the CPU. The same block runs twice on the same embedded tokens
(rows of an N(0, 0.02) table): in float32, and in bfloat16 as the served
model runs; both through the plain attention. Prints one JSON object: the
share of top-k choices the two runs agree on (per token |top-k ∩ top-k| /
k, averaged; and the worst token), the largest router-logit difference,
and the gap between the k-th and (k+1)-th router probabilities in float32
(median, and the share of tokens whose gap is below the largest
probability difference between the runs: the near ties a rounding can
flip).
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from areal_tpu_torch.models.config import qwen3_30b_a3b
from areal_tpu_torch.models.transformer import (
    Block,
    apply_rope,
    rope_tables,
)
from areal_tpu_torch.ops.attention import packed_attention


def router_input(blk: Block, h: torch.Tensor, cos, sin, seg, pos):
    """The block's MLP input (``ln2`` after the attention's residual): what
    its router reads."""
    B, T, _ = h.shape
    dh = blk.cfg.head_dim
    x = blk.ln1(h)
    q = blk.q_norm(blk.wq(x).reshape(B, T, -1, dh))
    k = blk.k_norm(blk.wk(x).reshape(B, T, -1, dh))
    v = blk.wv(x).reshape(B, T, -1, dh)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    attn = packed_attention(q, k, v, seg, seg, q_positions=pos,
                            kv_positions=pos, causal=True, impl="reference")
    return blk.ln2(h + blk.wo(attn.reshape(B, T, -1)))


def measure(batch: int = 2, tokens: int = 1024, seed: int = 0) -> dict:
    cfg = qwen3_30b_a3b(n_layers=1, moe=None, intermediate_dim=8)
    E, k = 128, 8
    gen = torch.Generator().manual_seed(seed)
    blk = Block(cfg)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if name.endswith("norm.weight") or name.startswith("ln"):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    router = torch.randn(E, cfg.hidden_dim, generator=gen) * 0.02
    h = torch.randn(batch, tokens, cfg.hidden_dim, generator=gen) * 0.02
    pos = torch.arange(tokens).repeat(batch, 1)
    seg = torch.ones(batch, tokens, dtype=torch.int32)
    cos, sin = rope_tables(pos, cfg.head_dim, cfg.rotary_base)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        b = Block(cfg, device="meta")
        b.load_state_dict({n: p.to(dt) for n, p in blk.state_dict().items()},
                          assign=True)
        with torch.no_grad():
            x = router_input(b, h.to(dt), cos, sin, seg, pos)
            logits = F.linear(x, router.to(dt)).float().reshape(-1, E)
        out[dt] = logits
    l32, l16 = out[torch.float32], out[torch.bfloat16]
    p32, p16 = torch.softmax(l32, -1), torch.softmax(l16, -1)
    i32, i16 = p32.topk(k, -1).indices, p16.topk(k, -1).indices
    agree = (i32[:, :, None] == i16[:, None, :]).any(-1).float().mean(-1)
    srt = p32.sort(-1, descending=True).values
    gap = srt[:, k - 1] - srt[:, k]
    dp = (p32 - p16).abs().max(-1).values
    return {
        "tokens": int(l32.shape[0]), "experts": E, "top_k": k,
        "topk_agreement": agree.mean().item(),
        "topk_agreement_worst_token": agree.min().item(),
        "tokens_all_k_agree": (agree == 1).float().mean().item(),
        "router_logit_max_abs_diff": (l32 - l16).abs().max().item(),
        "kth_gap_median": gap.median().item(),
        "tokens_gap_below_prob_diff": (gap < dp).float().mean().item(),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--tokens", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    print(json.dumps(measure(a.batch, a.tokens, a.seed)))


if __name__ == "__main__":
    main()
