"""SequenceSample — the packed variable-length batch container.

The port's own copy of ``areal_tpu/api/data.py`` (``MicroBatchSpec:31``,
``SequenceSample:53``), numpy only: the host side of every engine call. A
sample may hold several sequences per key (grouped generation), hence
``seqlens[key]`` is a list (per sample) of lists (per sequence-in-group) of
ints. Scalar-per-sequence keys (e.g. rewards) use seqlen == number of
scalars.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Hashable, List, Optional, Sequence, Set, Tuple

import numpy as np

from areal_tpu_torch.base import datapack

__all__ = ["SequenceSample", "MicroBatchSpec"]


@dataclasses.dataclass
class MicroBatchSpec:
    """Micro-batch splitting spec (reference: realhf/api/cli_args.py:16).

    ``n_mbs`` is the minimum number of micro-batches; ``max_tokens_per_mb``
    additionally caps the token count of each micro-batch (FFD packing).
    """

    n_mbs: int = 1
    max_tokens_per_mb: Optional[int] = None


def _as_nested(seqlens) -> List[List[int]]:
    out = []
    for s in seqlens:
        if isinstance(s, (int, np.integer)):
            out.append([int(s)])
        else:
            out.append([int(x) for x in s])
    return out


@dataclasses.dataclass
class SequenceSample:
    ids: List[Hashable]
    keys: Set[str]
    seqlens: Dict[str, List[List[int]]]
    data: Optional[Dict[str, Optional[np.ndarray]]] = None
    metadata: Dict[str, List[Any]] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.keys = set(self.keys)
        self.ids = list(self.ids)
        bs = len(self.ids)
        if len(set(self.ids)) != bs:
            raise ValueError(f"duplicate sample ids: {self.ids}")
        for k in self.keys:
            if k not in self.seqlens:
                raise ValueError(f"missing seqlens for key {k}")
            self.seqlens[k] = _as_nested(self.seqlens[k])
            if len(self.seqlens[k]) != bs:
                raise ValueError(
                    f"seqlens[{k}] has {len(self.seqlens[k])} entries != bs {bs}"
                )
        if self.data is not None:
            for k in self.keys:
                v = self.data.get(k)
                if v is None:
                    continue
                v = np.asarray(v)
                total = sum(sum(s) for s in self.seqlens[k])
                if v.shape[0] != total:
                    raise ValueError(
                        f"data[{k}] has leading dim {v.shape[0]}, expected {total}"
                    )
                self.data[k] = v
        for k, v in self.metadata.items():
            if not isinstance(v, list) or len(v) != bs:
                raise ValueError(f"metadata[{k}] must be a list of len bs={bs}")

    # ------------ constructors ------------
    @classmethod
    def from_default(
        cls,
        ids: Sequence[Hashable],
        data: Dict[str, np.ndarray],
        seqlens: Sequence[int],
        metadata: Optional[Dict[str, List[Any]]] = None,
    ) -> "SequenceSample":
        """Build a sample where every 'token-shaped' key shares ``seqlens`` and
        every 'scalar-shaped' key (leading dim == batch size) gets seqlen 1.
        """
        ids = list(ids)
        bs = len(ids)
        seqlens = [int(s) for s in seqlens]
        total = sum(seqlens)
        sls: Dict[str, List[List[int]]] = {}
        datad: Dict[str, np.ndarray] = {}
        for k, v in data.items():
            v = np.asarray(v)
            if v.shape[0] == total:
                sls[k] = [[s] for s in seqlens]
            elif v.shape[0] == bs:
                sls[k] = [[1]] * bs
            else:
                raise ValueError(
                    f"cannot infer seqlens for key {k}: leading dim {v.shape[0]} "
                    f"is neither total tokens {total} nor bs {bs}"
                )
            datad[k] = v
        return cls(
            ids=ids,
            keys=set(data.keys()),
            seqlens=sls,
            data=datad,
            metadata=metadata or {},
        )

    # ------------ views ------------
    @property
    def bs(self) -> int:
        return len(self.ids)

    def total_lens(self, key: Optional[str] = None) -> np.ndarray:
        """Per-sample total length for a key (default: the main token key)."""
        key = key or self._main_key()
        return np.array([sum(s) for s in self.seqlens[key]], dtype=np.int64)

    def _main_key(self) -> str:
        for cand in ("packed_input_ids", "packed_prompts", "input_ids"):
            if cand in self.keys:
                return cand
        # fall back to the key with the largest token count
        return max(self.keys, key=lambda k: sum(sum(s) for s in self.seqlens[k]))

    def meta(self) -> "SequenceSample":
        """Metadata-only copy (what the master worker holds; reference
        data_api.py:160-168)."""
        return SequenceSample(
            ids=list(self.ids),
            keys=set(self.keys),
            seqlens={k: [list(s) for s in v] for k, v in self.seqlens.items()},
            data=None,
            metadata={k: list(v) for k, v in self.metadata.items()},
        )

    def offsets(self, key: str) -> np.ndarray:
        """Start offset of each sample's packed span for ``key``."""
        lens = [sum(s) for s in self.seqlens[key]]
        return np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)

    def cu_seqlens(self, key: Optional[str] = None) -> np.ndarray:
        """Cumulative *sequence* boundaries (flattening groups) for a key."""
        key = key or self._main_key()
        flat = [s for group in self.seqlens[key] for s in group]
        return np.concatenate([[0], np.cumsum(flat)]).astype(np.int64)

    # ------------ select / split / gather ------------
    def select_idx(self, idx: Sequence[int]) -> "SequenceSample":
        idx = list(idx)
        data = None
        if self.data is not None:
            data = {}
            for k in self.keys:
                v = self.data.get(k)
                if v is None:
                    data[k] = None
                    continue
                offs = self.offsets(k)
                lens = [sum(s) for s in self.seqlens[k]]
                parts = [v[offs[i] : offs[i] + lens[i]] for i in idx]
                data[k] = (
                    np.concatenate(parts) if parts else v[:0]
                )
        return SequenceSample(
            ids=[self.ids[i] for i in idx],
            keys=set(self.keys),
            seqlens={k: [self.seqlens[k][i] for i in idx] for k in self.keys},
            data=data,
            metadata={k: [v[i] for i in idx] for k, v in self.metadata.items()},
        )

    def select_ids(self, ids: Sequence[Hashable]) -> "SequenceSample":
        pos = {i: n for n, i in enumerate(self.ids)}
        return self.select_idx([pos[i] for i in ids])

    def split_groups(self, groups: List[List[int]]) -> List["SequenceSample"]:
        return [self.select_idx(g) for g in groups]

    def split(
        self, k: Optional[int] = None, mb_spec: Optional[MicroBatchSpec] = None
    ) -> Tuple[List["SequenceSample"], List[List[int]]]:
        """Token-balanced split. With ``k``, a non-contiguous balanced k-way
        partition (DP dispatch; reference model_function_call.py:276). With
        ``mb_spec``, FFD packing under max_tokens_per_mb with at least n_mbs
        groups (micro-batching). Returns (samples, index groups)."""
        sizes = self.total_lens()
        if k is not None:
            # Exactly k groups; empty groups possible when bs < k (DP ranks
            # must all be dispatched to, even with zero sequences).
            groups = datapack.balanced_groups(sizes, k)
        else:
            assert mb_spec is not None
            cap = mb_spec.max_tokens_per_mb or max(int(sizes.sum()), 1)
            groups = datapack.ffd_allocate(sizes, cap, min_groups=mb_spec.n_mbs)
        return self.split_groups(groups), groups

    @classmethod
    def gather(cls, samples: Sequence["SequenceSample"], keys=None) -> "SequenceSample":
        if not samples:
            raise ValueError("cannot gather zero samples")
        keys = set(keys) if keys is not None else set(samples[0].keys)
        ids = [i for s in samples for i in s.ids]
        seqlens = {
            k: [sl for s in samples for sl in s.seqlens[k]] for k in keys
        }
        data = None
        if all(s.data is not None for s in samples):
            data = {}
            for k in keys:
                parts = [s.data[k] for s in samples if s.data.get(k) is not None]
                data[k] = np.concatenate(parts) if parts else None
        md_keys = set().union(*[set(s.metadata) for s in samples])
        metadata = {
            k: [x for s in samples for x in s.metadata.get(k, [None] * s.bs)]
            for k in md_keys
        }
        return cls(ids=ids, keys=keys, seqlens=seqlens, data=data, metadata=metadata)

    # ------------ mutation ------------
    def update_(self, other: "SequenceSample") -> None:
        """Merge keys of ``other`` (same ids, any order) into self (the buffer
        amend operation; reference buffer.py:308)."""
        other = other.select_ids(self.ids)
        self.keys |= other.keys
        self.seqlens.update(other.seqlens)
        if self.data is not None and other.data is not None:
            self.data.update(other.data)
        for k, v in other.metadata.items():
            self.metadata[k] = v

    def remap_keys_(self, remap: Dict[str, str]) -> None:
        for src, dst in remap.items():
            if src not in self.keys:
                continue
            self.keys.discard(src)
            self.keys.add(dst)
            self.seqlens[dst] = self.seqlens.pop(src)
            if self.data is not None and src in self.data:
                self.data[dst] = self.data.pop(src)

    # ------------ codec (rollout → trainer ZMQ JSON) ------------
    def as_json_compatible(self) -> dict:
        assert self.data is not None
        return {
            "ids": list(self.ids),
            "keys": sorted(self.keys),
            "seqlens": {k: self.seqlens[k] for k in self.keys},
            "data": {
                k: (None if self.data.get(k) is None else self.data[k].tolist())
                for k in self.keys
            },
            "dtypes": {
                k: (None if self.data.get(k) is None else str(self.data[k].dtype))
                for k in self.keys
            },
            "metadata": self.metadata,
        }

    @classmethod
    def from_json_compatible(cls, d: dict) -> "SequenceSample":
        data = {
            k: (None if v is None else np.asarray(v, dtype=d["dtypes"][k]))
            for k, v in d["data"].items()
        }
        return cls(
            ids=d["ids"],
            keys=set(d["keys"]),
            seqlens=d["seqlens"],
            data=data,
            metadata=d.get("metadata", {}),
        )

    def __repr__(self):
        return (
            f"SequenceSample(bs={self.bs}, keys={sorted(self.keys)}, "
            f"meta_only={self.data is None})"
        )
