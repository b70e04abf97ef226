"""Datasets: jsonl prompt and math/code loaders.

The port's copy of ``areal_tpu/datasets/jsonl.py:30-233`` (reference
``realhf/impl/dataset/``): ``PromptDataset`` (prompt_dataset.py:16),
``PromptAnswerDataset`` (prompt_answer_dataset.py, SFT),
``RewardModelingPairedDataset`` (rw_paired_dataset.py),
``MathCodePromptDataset`` (math_code_dataset.py:90, with dynamic difficulty
filtering) and the shared loader ``load_shuffle_split`` (realhf
data_api.py:754: every DP rank deterministically owns a disjoint shard by
seed).

A dataset is a plain object with ``__len__`` / ``__getitem__`` returning
``SequenceSample``s (host numpy), plus an optional ``filter(eval_scores)``
hook. Tokenizers are anything with ``encode(str) -> List[int]``.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Callable, Dict, Hashable, List, Optional

import numpy as np

from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.api.model import register_dataset
from areal_tpu_torch.base import logging

logger = logging.getLogger("datasets")

RL_TASKS = ("math", "code", "rlhf", "stem")


def _encode(tokenizer, text: str) -> List[int]:
    ids = tokenizer.encode(text)
    if hasattr(ids, "ids"):  # tokenizers.Encoding
        ids = ids.ids
    return list(ids)


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    # "@" is reserved as the structural separator in sample ids
    # ("<query_id>@<group_idx>", "<query_id>@r<epoch>"); a raw query_id
    # containing it would make reward lookups silently miss. Fail loudly.
    for r in records:
        if "@" in str(r.get("query_id", "")):
            raise ValueError(
                f"query_id {r['query_id']!r} in {path} contains '@', which "
                "is reserved for sample-id suffixes; rename the record"
            )
    return records


def load_shuffle_split(
    data: List[Dict],
    seed: int,
    dp_rank: int,
    dp_size: int,
) -> List[Dict]:
    """Deterministic disjoint shard per DP rank (reference data_api.py:754):
    one global shuffle by seed, then a contiguous slice per rank."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(len(data))
    bounds = np.linspace(0, len(data), dp_size + 1).astype(int)
    idx = perm[bounds[dp_rank] : bounds[dp_rank + 1]]
    return [data[i] for i in idx]


class JsonlDatasetBase:
    """Common machinery: load → validate → shard → tokenize lazily."""

    def __init__(
        self,
        dataset_path: Optional[str] = None,
        dataset_builder: Optional[Callable[[], List[Dict]]] = None,
        tokenizer=None,
        seed: int = 1,
        dp_rank: int = 0,
        dp_size: int = 1,
        max_length: Optional[int] = None,
    ):
        raw = load_jsonl(dataset_path) if dataset_path else dataset_builder()
        raw = [d for d in raw if self._validate(d)]
        self.records = load_shuffle_split(raw, seed, dp_rank, dp_size)
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.seed = seed

    def _validate(self, d: Dict) -> bool:
        return True

    def __len__(self) -> int:
        return len(self.records)

    def filter(self, eval_scores: Dict[Hashable, float]) -> None:
        """Dynamic difficulty filtering hook (no-op by default)."""

    def _truncate(self, ids: List[int]) -> List[int]:
        if self.max_length is not None and len(ids) > self.max_length:
            return ids[: self.max_length]
        return ids


class PromptDataset(JsonlDatasetBase):
    """Records: {"prompt": str, "query_id": str} → SequenceSample with
    ``packed_prompts`` (reference prompt_dataset.py:16)."""

    def _validate(self, d):
        return isinstance(d.get("prompt"), str)

    def __getitem__(self, i: int) -> SequenceSample:
        d = self.records[i]
        ids = self._truncate(_encode(self.tokenizer, d["prompt"]))
        return SequenceSample.from_default(
            ids=[str(d.get("query_id", i))],
            data={"packed_prompts": np.asarray(ids, np.int32)},
            seqlens=[len(ids)],
            metadata={"task": [d.get("task", "math")]},
        )


class PromptAnswerDataset(JsonlDatasetBase):
    """SFT records: {"prompt": str, "answer": str} → packed_input_ids +
    prompt_mask (1 on prompt tokens, excluded from the loss; reference
    prompt_answer_dataset.py)."""

    def _validate(self, d):
        return (isinstance(d.get("prompt"), str)
                and isinstance(d.get("answer"), str))

    def __getitem__(self, i: int) -> SequenceSample:
        d = self.records[i]
        p = _encode(self.tokenizer, d["prompt"])
        a = _encode(self.tokenizer, d["prompt"] + d["answer"])[len(p):]
        if not a:  # degenerate tokenization; fall back to direct encoding
            a = _encode(self.tokenizer, d["answer"])
        ids = self._truncate(p + a)
        mask = ([1] * len(p) + [0] * len(a))[: len(ids)]
        return SequenceSample.from_default(
            ids=[str(d.get("query_id", i))],
            data={
                "packed_input_ids": np.asarray(ids, np.int32),
                "prompt_mask": np.asarray(mask, np.int32),
            },
            seqlens=[len(ids)],
        )


class RewardModelingPairedDataset(JsonlDatasetBase):
    """Records: {"prompt", "pos_answers": [...], "neg_answers": [...]} →
    packed_input_ids holding the pos/neg pairs interleaved as segments of
    one sample, ``metadata["n_pairs"]`` (reference rw_paired_dataset.py)."""

    def _validate(self, d):
        return (
            isinstance(d.get("prompt"), str)
            and d.get("pos_answers")
            and d.get("neg_answers")
            and len(d["pos_answers"]) == len(d["neg_answers"])
        )

    def __getitem__(self, i: int) -> SequenceSample:
        d = self.records[i]
        p = _encode(self.tokenizer, d["prompt"])
        seqs: List[List[int]] = []
        for pos, neg in zip(d["pos_answers"], d["neg_answers"]):
            for ans in (pos, neg):
                seqs.append(self._truncate(p + _encode(self.tokenizer, ans)))
        flat = np.asarray([t for s in seqs for t in s], np.int32)
        return SequenceSample(
            ids=[str(d.get("query_id", i))],
            keys={"packed_input_ids"},
            seqlens={"packed_input_ids": [[len(s) for s in seqs]]},
            data={"packed_input_ids": flat},
            metadata={"n_pairs": [len(d["pos_answers"])]},
        )


class MathCodePromptDataset(PromptDataset):
    """RL prompt dataset with per-task metadata and dynamic difficulty
    filtering (reference math_code_dataset.py:90,175).

    Records: {"query_id", "prompt", "task": "math"|"code",
    "solutions": [str]} and, for code, {"input_output": json-str}.
    ``filter``: drop prompts whose running mean eval score exceeds
    ``filter_threshold`` (too easy), up to ``max_filter_percentage`` per call.
    """

    def __init__(
        self,
        *args,
        filter_threshold: float = 1e4,
        max_filter_percentage: float = 0.0,
        **kw,
    ):
        super().__init__(*args, **kw)
        self.filter_threshold = filter_threshold
        self.max_filter_percentage = max_filter_percentage
        self.id2info = {str(d["query_id"]): d for d in self.records}

    def _validate(self, d):
        if not isinstance(d.get("prompt"), str) or "query_id" not in d:
            return False
        task = d.setdefault("task", "math")
        if task in ("math", "stem"):
            ok = isinstance(d.get("solutions"), list) and all(
                isinstance(s, str) for s in d["solutions"]
            )
        elif task == "code":
            try:
                io = json.loads(d.get("input_output", "null")) or {}
                ok = len(io.get("inputs", [])) == len(io.get("outputs", []))
            except json.JSONDecodeError:
                ok = False
        else:
            ok = False
        if not ok:
            logger.warning(f"invalid record {d.get('query_id')}; omitted")
        return ok

    def __getitem__(self, i: int) -> SequenceSample:
        d = self.records[i]
        ids = self._truncate(_encode(self.tokenizer, d["prompt"]))
        return SequenceSample.from_default(
            ids=[str(d["query_id"])],
            data={
                "packed_prompts": np.asarray(ids, np.int32),
                "task_ids": np.asarray([RL_TASKS.index(d["task"])], np.int32),
            },
            seqlens=[len(ids)],
            metadata={"task": [d["task"]]},
        )

    def filter(self, eval_scores: Dict[Hashable, float]) -> None:
        scores = defaultdict(list)
        for qid, s in eval_scores.items():
            scores[str(qid)].append(float(s))
        means = {q: np.mean(v) for q, v in scores.items()}
        candidates = [
            i
            for i, d in enumerate(self.records)
            if means.get(str(d["query_id"]), -np.inf) > self.filter_threshold
        ]
        cap = int(self.max_filter_percentage * len(self.records))
        drop = set(candidates[:cap])
        if drop:
            logger.info(f"difficulty filter: dropping {len(drop)} records")
            self.records = [d for i, d in enumerate(self.records) if i not in drop]
            self.id2info = {str(d["query_id"]): d for d in self.records}


register_dataset("prompt", PromptDataset)
register_dataset("prompt_answer", PromptAnswerDataset)
register_dataset("rw_paired", RewardModelingPairedDataset)
register_dataset("math_code_prompt", MathCodePromptDataset)
