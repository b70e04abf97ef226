"""Test fixtures: a mock tokenizer and fabricated datasets.

The port's own copies from ``areal_tpu/base/testing.py``: ``MockTokenizer``
(and ``ByteTokenizer``, its decode for any vocabulary) and the jsonl makers
(``:18-135``, ``make_sft_jsonl`` among them), and ``bench_trajectory_dist`` (``:137``),
the PPO trajectory length distribution that ``bench.py`` trains on and that
``chip_smoke.py`` rebuilds without the JAX package.
"""

from __future__ import annotations

import json
import random
from typing import List

import numpy as np

PAD_TOKEN = 0
EOS_TOKEN = 1


class MockTokenizer:
    """Deterministic char-level tokenizer: byte + 2 (0 = pad, 1 = eos)."""

    def __init__(self, vocab_size: int = 258):
        self.vocab_size = vocab_size
        self.pad_token_id = PAD_TOKEN
        self.eos_token_id = EOS_TOKEN

    def encode(self, text: str) -> List[int]:
        return [(b % (self.vocab_size - 2)) + 2 for b in text.encode()]

    def decode(self, ids) -> str:
        return bytes(
            max(int(i) - 2, 0) for i in ids if int(i) not in (PAD_TOKEN, EOS_TOKEN)
        ).decode(errors="replace")

    def __call__(self, texts, **kw):
        if isinstance(texts, str):
            texts = [texts]
        return {"input_ids": [self.encode(t) for t in texts]}


class ByteTokenizer(MockTokenizer):
    """``MockTokenizer`` whose ``decode`` maps any id to a byte (id - 2 mod
    256; pad and eos dropped), so that what a model with a larger
    vocabulary samples decodes too (``MockTokenizer``, as the reference's,
    raises past id 257); on ids below 258 the two agree. The experiments'
    tokenizer under ``mock_tokenizer=true``."""

    def decode(self, ids) -> str:
        return bytes(
            (int(i) - 2) % 256 for i in ids
            if int(i) not in (PAD_TOKEN, EOS_TOKEN)
        ).decode(errors="replace")


def make_math_jsonl(path: str, n: int = 32, seed: int = 0) -> List[dict]:
    """Solvable arithmetic prompts with boxed ground truths."""
    rng = random.Random(seed)
    records = []
    for i in range(n):
        a, b = rng.randint(0, 50), rng.randint(0, 50)
        records.append(
            {
                "query_id": f"q{i}",
                "prompt": f"What is {a}+{b}? ",
                "task": "math",
                "solutions": [f"\\boxed{{{a + b}}}"],
            }
        )
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return records


def make_sft_jsonl(path: str, n: int = 32, seed: int = 0) -> List[dict]:
    rng = random.Random(seed)
    records = []
    for i in range(n):
        a, b = rng.randint(0, 50), rng.randint(0, 50)
        records.append(
            {
                "query_id": f"s{i}",
                "prompt": f"What is {a}+{b}? ",
                "answer": f"The answer is {a + b}.",
            }
        )
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return records


def make_code_jsonl(path: str, n: int = 4, seed: int = 0) -> List[dict]:
    rng = random.Random(seed)
    records = []
    for i in range(n):
        k = rng.randint(1, 5)
        io = {
            "inputs": [f"{x}\n" for x in range(3)],
            "outputs": [f"{x + k}\n" for x in range(3)],
        }
        records.append(
            {
                "query_id": f"c{i}",
                "prompt": f"Write a program that reads x and prints x+{k}.",
                "task": "code",
                "solutions": [],
                "input_output": json.dumps(io),
            }
        )
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return records


def make_mixed_jsonl(path: str, n_math: int = 6, n_code: int = 2,
                     seed: int = 0) -> List[dict]:
    """Mixed math+code RL fixture: the code-RL e2e / pass@k eval dataset
    shape (docs/rewards.md). Math records carry boxed solutions; code
    records carry stdin/stdout ``input_output`` cases a one-liner can
    pass — graded by the sandbox, fully solvable in principle."""
    rng = random.Random(seed)
    records = []
    for i in range(n_math):
        a, b = rng.randint(0, 50), rng.randint(0, 50)
        records.append({
            "query_id": f"m{i}",
            "prompt": f"What is {a}+{b}? ",
            "task": "math",
            "solutions": [f"\\boxed{{{a + b}}}"],
        })
    for i in range(n_code):
        k = rng.randint(1, 5)
        io = {
            "inputs": [f"{x}\n" for x in range(2)],
            "outputs": [f"{x + k}\n" for x in range(2)],
        }
        records.append({
            "query_id": f"c{i}",
            "prompt": f"Write a program that reads x and prints x+{k}. ",
            "task": "code",
            "solutions": [],
            "input_output": json.dumps(io),
        })
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return records




def bench_trajectory_dist(seed: int = 0, n_seq: int = 32):
    """The bench PPO trajectory length distribution — ~250-token prompts
    + ~640-token generations — as ``(rng, plens, glens)``. Callers keep
    drawing tokens and logprobs from the returned rng, in ``bench.py``'s
    order, to rebuild its batch bit for bit."""
    rng = np.random.RandomState(seed)
    plens = rng.randint(200, 257, n_seq)
    glens = rng.randint(512, 769, n_seq)
    return rng, plens, glens
