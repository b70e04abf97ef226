"""Offline checkpoint evaluation: pass@k over mixed math and code.

The port of ``areal_tpu/apps/eval_ckpt.py`` (the reference's
``evaluation/`` harness as ``realhf/scheduler/evaluator.py`` drives it: one
subprocess per saved checkpoint generates on an eval set, grades and writes
its scores). The checkpoint loads through ``models/hf.py``, generation runs
through ``models/generate.py`` (its prefill through K1 on the card), and
grading goes per task kind through ``rewards/client.py``: locally, or on
the reward fleet with ``--reward-service``.

``--k 1`` (the default) is the greedy single-sample accuracy. ``--k N``
draws N temperature-sampled generations per prompt and reports the
unbiased pass@k (Chen et al. 2021: 1 - C(n-c,k)/C(n,k)) and pass^k (all k
draws right: C(c,k)/C(n,k)), overall and per task kind (``math/pass@1``,
``code/pass@4``, ...).

Differences: the process runs on ``--device`` (``cuda`` unless asked for
the CPU), where the reference's runs on the CPU beside a TPU trainer; on
the card the model generates in bfloat16, as the generation servers do,
and elsewhere in the checkpoint's dtype, as the reference does; a draw's
batch samples from one ``torch.Generator`` seeded from ``(seed + draw,
batch offset)`` where the reference folds the batch offset into
``PRNGKey(seed + draw)``, so sampled draws differ between the packages
(greedy ones agree); the result's ``device`` entry holds the process's
K1 launches, the model's dtype and peak device memory.

Usage:
    python -m areal_tpu_torch.apps.eval_ckpt --ckpt <hf_dir> \\
        --dataset <jsonl> --output scores.json [--k 4] [--temperature 0.6] \\
        [--max-gen-tokens 512] [--mock-tokenizer] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Dict, List, Optional

import numpy as np

from areal_tpu_torch.base import logging

logger = logging.getLogger("apps.eval")


def pass_at_k(n: int, c: int, k: int) -> float:
    """Unbiased pass@k from n samples with c correct (Codex paper eq. 1):
    1 - C(n-c, k) / C(n, k). Requires n >= k."""
    if n - c < k:
        return 1.0
    return 1.0 - math.comb(n - c, k) / math.comb(n, k)


def pass_hat_k(n: int, c: int, k: int) -> float:
    """pass^k, the probability that all k independent draws are correct:
    C(c, k) / C(n, k)."""
    if c < k:
        return 0.0
    return math.comb(c, k) / math.comb(n, k)


def _configure_reward_service(service_config: Optional[Dict],
                              experiment: str, trial: str) -> None:
    """Grade on the live reward fleet of ``experiment``/``trial``, found
    through name_resolve (``AREAL_NAME_RESOLVE_ROOT``, which the evaluator
    exports), under the run's own RewardServiceConfig: generated code never
    runs in the eval process while a fleet is up."""
    import dataclasses

    from areal_tpu_torch.api.train_config import RewardServiceConfig
    from areal_tpu_torch.rewards.client import configure_service

    known = {f.name for f in dataclasses.fields(RewardServiceConfig)}
    kw = {k: v for k, v in (service_config or {}).items() if k in known}
    kw["enabled"] = True
    configure_service(RewardServiceConfig(**kw), experiment, trial)


def evaluate_checkpoint(
    ckpt_dir: str,
    dataset_path: str,
    max_gen_tokens: int = 512,
    batch_size: int = 16,
    mock_tokenizer: bool = False,
    limit: Optional[int] = None,
    k: int = 1,
    temperature: float = 0.6,
    seed: int = 0,
    service_experiment: str = "",
    service_trial: str = "",
    service_config: Optional[Dict] = None,
    device=None,
) -> dict:
    """Scores of the checkpoint in ``ckpt_dir`` on ``dataset_path``'s
    records, generated on ``device`` (cuda unless named): in bfloat16 on
    the card, in the checkpoint's dtype elsewhere."""
    import torch

    from areal_tpu_torch import resolve_device
    from areal_tpu_torch.api.model import GenerationHyperparameters
    from areal_tpu_torch.base.seeding import _mix
    from areal_tpu_torch.datasets.jsonl import load_jsonl
    from areal_tpu_torch.models import generate as G
    from areal_tpu_torch.models import hf
    from areal_tpu_torch.models.transformer import Transformer
    from areal_tpu_torch.ops import flash_attention as fa
    from areal_tpu_torch.rewards.client import batch_reward, task_from_record

    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    dev = resolve_device(device)
    if service_experiment:
        _configure_reward_service(service_config, service_experiment,
                                  service_trial)
    cfg, params = hf.load_hf_checkpoint(ckpt_dir, device=dev)
    if dev.type == "cuda":
        params = {n: p.to(torch.bfloat16) for n, p in params.items()}
    model = Transformer.from_params(cfg, params)
    del params
    if mock_tokenizer:
        from areal_tpu_torch.base.testing import ByteTokenizer

        tok = ByteTokenizer()
    else:
        raise NotImplementedError(
            "a checkpoint's own tokenizer needs `transformers`, which the "
            "port does not use; pass --mock-tokenizer (the byte tokenizer)")
    records = load_jsonl(dataset_path)
    if limit:
        records = records[:limit]
    eos = getattr(tok, "eos_token_id", None) or 1
    pad = getattr(tok, "pad_token_id", None) or eos
    # k = 1 keeps the deterministic greedy eval; k > 1 is the sampled
    # estimator (k greedy draws would be k identical samples).
    gconfig = GenerationHyperparameters(greedy=(k == 1),
                                        temperature=temperature)
    per_rec_correct: List[int] = [0] * len(records)
    kinds: List[str] = [r.get("task", "math") for r in records]
    k1_before = fa.launch_count("flash_attention_fwd")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    # Tokenization and padding do not depend on the draw: once per batch.
    batches = []
    for i in range(0, len(records), batch_size):
        chunk = records[i:i + batch_size]
        prompts, plens = G.pad_prompts(
            [list(map(int, tok.encode(r["prompt"]))) for r in chunk], pad)
        batches.append((i, chunk, torch.from_numpy(prompts).to(dev),
                        torch.from_numpy(plens).to(dev)))
    for draw in range(k):
        for i, chunk, prompts, plens in batches:
            gen = torch.Generator(device=dev).manual_seed(
                _mix(seed + draw, str(i)) % (2**63))
            out = G.generate_batch(
                model, prompts, plens, gen, gconfig,
                max_new_tokens=max_gen_tokens, eos_token_id=eos,
                pad_token_id=pad)
            out_ids = out["output_ids"].cpu().numpy()
            out_lens = out["output_lens"].cpu().numpy()
            tasks = [
                task_from_record(rec, tok.decode(list(map(int, toks[:int(n)]))))
                for rec, toks, n in zip(chunk, out_ids, out_lens)
            ]
            for j, s in enumerate(batch_reward(tasks)):
                per_rec_correct[i + j] += int(s > 0)

    def _estimators(idxs: List[int]) -> Dict[str, float]:
        if not idxs:
            return {}
        est: Dict[str, float] = {
            "pass@1": float(np.mean([per_rec_correct[i] / k for i in idxs])),
        }
        if k > 1:
            est[f"pass@{k}"] = float(np.mean(
                [pass_at_k(k, per_rec_correct[i], k) for i in idxs]))
            est[f"pass^{k}"] = float(np.mean(
                [pass_hat_k(k, per_rec_correct[i], k) for i in idxs]))
        return est

    overall = _estimators(list(range(len(records))))
    result = {
        "ckpt": ckpt_dir,
        "dataset": dataset_path,
        "n": len(records),
        "k": k,
        "temperature": None if k == 1 else temperature,
        # pass@1 is the greedy accuracy at k = 1
        "accuracy": overall.get("pass@1", 0.0),
        **overall,
        "eval_secs": round(time.time() - t0, 2),
    }
    for kind in sorted(set(kinds)):
        idxs = [i for i, kk in enumerate(kinds) if kk == kind]
        for name, v in _estimators(idxs).items():
            result[f"{kind}/{name}"] = v
        result[f"{kind}/n"] = len(idxs)
    # not a score: the evaluator's metric writer skips non-numbers
    result["device"] = {
        "type": dev.type,
        "dtype": str(model.embedding.weight.dtype).replace("torch.", ""),
        "flash_attention_fwd_launches":
            fa.launch_count("flash_attention_fwd") - k1_before,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
    }
    return result


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--max-gen-tokens", type=int, default=512)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--k", type=int, default=1,
                    help="samples per prompt (1 = greedy accuracy)")
    ap.add_argument("--temperature", type=float, default=0.6,
                    help="sampling temperature for k > 1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mock-tokenizer", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    ap.add_argument("--reward-service", nargs=2, default=None,
                    metavar=("EXPERIMENT", "TRIAL"),
                    help="grade on the live reward fleet of this "
                         "experiment/trial")
    ap.add_argument("--reward-service-config", default=None,
                    help="JSON of the run's RewardServiceConfig, so that "
                         "its settings (local_fallback, languages, "
                         "timeouts) hold here too")
    args = ap.parse_args(argv)
    result = evaluate_checkpoint(
        args.ckpt, args.dataset,
        max_gen_tokens=args.max_gen_tokens,
        batch_size=args.batch_size,
        mock_tokenizer=args.mock_tokenizer,
        limit=args.limit,
        k=args.k,
        temperature=args.temperature,
        seed=args.seed,
        service_experiment=(args.reward_service[0] if args.reward_service
                            else ""),
        service_trial=args.reward_service[1] if args.reward_service else "",
        service_config=(json.loads(args.reward_service_config)
                        if args.reward_service_config else None),
        device=args.device,
    )
    with open(args.output, "w") as f:
        json.dump(result, f)
    logger.info(f"eval done: {result}")


if __name__ == "__main__":
    main()
