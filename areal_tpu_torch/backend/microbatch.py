"""SequenceSample → fixed-shape ``[R, L]`` micro-batches.

The port's own copy of ``areal_tpu/backend/microbatch.py`` (numpy): the host
side of every train step. Sequences are packed into bucketed ``[B, L]``
grids (models/packing.py), and every micro-batch of a split has the same
shape, so the whole batch uploads to the device once and each step slices
its rows there.

Key-layout contract: every per-token key of a sample has the SAME
per-sample seqlens as the main token key (``packed_input_ids``) —
logprobs/masks/etc are full-length with unused slots zeroed — so one
PackLayout serves all keys. Scalar keys (one value per sample, e.g. rewards)
ride along as [n_seqs] vectors plus (row, last_col) index arrays into the
grid.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.base import datapack
from areal_tpu_torch.models import packing


@dataclasses.dataclass
class MicroBatch:
    layout: packing.PackLayout
    # [B, L] grids: always "tokens", "segment_ids", "positions"; plus one per
    # extra token-aligned key.
    grids: Dict[str, np.ndarray]
    # [S] per-sequence vectors (scalar keys), padded to the seqs bucket.
    scalars: Dict[str, np.ndarray]
    # [S] grid coordinates per sequence (padded entries point at (0, 0)).
    seq_rows: np.ndarray
    seq_first_cols: np.ndarray
    seq_last_cols: np.ndarray
    # [S] 1.0 for real sequences, 0.0 for bucket padding.
    seq_mask: np.ndarray
    # indices into the parent sample for scatter-back (real sequences only)
    sample_indices: List[int]

    @property
    def n_seqs(self) -> int:
        return len(self.sample_indices)

    @property
    def n_tokens(self) -> int:
        return int(sum(self.layout.seqlens))


# The fill sweep below bounds its candidate row lengths to
# ``min(cap, max(2*base, 64*fill_bucket))`` stepped by ``fill_bucket`` —
# at most this many distinct L values regardless of the token budget.
FILL_SWEEP_MAX_CANDIDATES = 64


def worst_case_row_candidates(
    length_bucket: int = 128,
    fill_bucket: Optional[int] = None,
    max_tokens_per_mb: Optional[int] = None,
) -> int:
    """Upper bound on distinct candidate row lengths the fill sweep in
    :func:`split_into_microbatches` can ever emit — the number of distinct
    ``[R, L]`` grid shapes a trainer can see. Pure arithmetic."""
    if fill_bucket is None:
        fill_bucket = min(length_bucket, 128)
    fill_bucket = max(int(fill_bucket), 1)
    n = FILL_SWEEP_MAX_CANDIDATES
    if max_tokens_per_mb:
        # cap also bounds hi: at most ceil(cap / fill_bucket) multiples fit.
        n = min(n, -(-int(max_tokens_per_mb) // fill_bucket))
    return max(n, 1)


def split_into_microbatches(
    sample: SequenceSample,
    mb_spec: MicroBatchSpec,
    token_key: str = "packed_input_ids",
    length_bucket: int = 128,
    rows_bucket: int = 8,
    seqs_bucket: int = 8,
    row_len: Optional[int] = None,
    fill_bucket: Optional[int] = None,
) -> List[MicroBatch]:
    """Pack ``sample`` into micro-batches of IDENTICAL ``[R, L]`` grid shape.

    Pack-then-split: sequences are FFD-packed into rows of a single row
    length L, and rows are grouped R-per-micro-batch. L is chosen from the
    multiples of ``fill_bucket`` (default ``min(length_bucket, 128)``) that
    fit the longest sequence by minimizing total padded cells, and the rows
    per micro-batch are swept too (a fixed ``cap // L`` wastes up to R-1
    padding rows in the last micro-batch). ``rows_bucket`` is kept for API
    compatibility; uniform grouping already pins the shape.
    """
    if sample.bs == 0:
        return []
    if fill_bucket is None:
        fill_bucket = min(length_bucket, 128)
    seqlens = [int(x) for x in sample.total_lens(token_key)]
    total = sum(seqlens)
    cap = int(mb_spec.max_tokens_per_mb or total)
    base = packing.round_up(max(seqlens), fill_bucket)
    cap = max(cap, base)
    if row_len is not None:
        L0 = packing.round_up(row_len, length_bucket)
        if max(seqlens) > L0:
            raise ValueError(
                f"sequence of length {max(seqlens)} exceeds row_len {L0}"
            )
        cands = [L0]
    else:
        # Bound the sweep: rows much longer than a few multiples of the
        # longest sequence stop improving fill, and an uncapped token
        # budget must not turn into an O(total/fill_bucket) FFD sweep.
        hi = min(cap, max(2 * base, 64 * fill_bucket))
        cands = list(range(base, hi + 1, fill_bucket))
    min_mbs = mb_spec.n_mbs or 1
    best = None
    for L in cands:
        rows = datapack.ffd_allocate(seqlens, L)
        # Rows per micro-batch: bounded by the token cap AND small enough
        # that >= mb_spec.n_mbs groups come out (the documented minimum).
        max_R = max(min(cap // L, len(rows) // min_mbs), 1)
        for R in range(max_R, 0, -1):
            n_mbs = -(-len(rows) // R)
            cells = n_mbs * R * L
            # Strict < keeps the FIRST optimum: the smaller row length
            # (less per-row causal attention waste) and, within one L, the
            # larger R (fewer launches) for the same padded-cell count.
            if best is None or cells < best[0]:
                best = (cells, L, R, rows)
    _, L, R, rows = best
    out = []
    for m in range(0, len(rows), R):
        grp = rows[m : m + R]
        idxs = [i for r in grp for i in r]
        if not idxs:
            continue
        placements: List[Tuple[int, int]] = [None] * len(idxs)  # type: ignore
        sub_pos = {g: p for p, g in enumerate(idxs)}
        for row, r in enumerate(grp):
            col = 0
            for i in r:
                placements[sub_pos[i]] = (row, col)
                col += seqlens[i]
        layout = packing.PackLayout(
            n_rows=R, row_len=L, placements=placements,
            seqlens=[seqlens[i] for i in idxs],
        )
        out.append(
            make_microbatch(
                sample.select_idx(idxs), token_key=token_key,
                length_bucket=length_bucket, rows_bucket=rows_bucket,
                seqs_bucket=seqs_bucket, layout=layout, sample_indices=idxs,
            )
        )
    return out


def pack_fill(mbs: List[MicroBatch]) -> float:
    """Achieved packing fill of a micro-batch split: real tokens over
    allocated [R, L] cells."""
    ntok = sum(mb.n_tokens for mb in mbs)
    ncells = sum(int(np.prod(mb.layout.shape)) for mb in mbs)
    return (ntok / ncells) if ncells else 0.0


def make_microbatch(
    sample: SequenceSample,
    token_key: str = "packed_input_ids",
    length_bucket: int = 128,
    rows_bucket: int = 8,
    seqs_bucket: int = 8,
    row_len: Optional[int] = None,
    sample_indices: Optional[Sequence[int]] = None,
    layout: Optional[packing.PackLayout] = None,
) -> MicroBatch:
    assert sample.data is not None, "micro-batching needs materialized data"
    seqlens = [int(x) for x in sample.total_lens(token_key)]
    if layout is None:
        layout = packing.plan_packing(
            seqlens, length_bucket=length_bucket, rows_multiple=rows_bucket,
            row_len=row_len,
        )
    grid = packing.make_grid(layout)
    grids: Dict[str, np.ndarray] = {
        "tokens": packing.batch_from_packed(
            sample.data[token_key].astype(np.int32), layout
        ),
        "segment_ids": grid["segment_ids"],
        "positions": grid["positions"],
    }
    scalars: Dict[str, np.ndarray] = {}
    total = sum(seqlens)
    for k in sample.keys:
        if k == token_key or sample.data.get(k) is None:
            continue
        v = sample.data[k]
        if v.shape[0] == total and [sum(s) for s in sample.seqlens[k]] == seqlens:
            grids[k] = packing.batch_from_packed(v, layout)
        elif v.shape[0] == sample.bs:
            scalars[k] = v
        else:
            raise ValueError(
                f"key {k}: leading dim {v.shape[0]} is neither token-aligned "
                f"({total}) nor per-sample ({sample.bs}); pad per-token keys "
                "to full length (see module docstring)"
            )
    # Bucket the sequence count too, so the [S]-shaped arrays below take a
    # small set of shapes.
    n = len(seqlens)
    S = packing.round_up(max(n, 1), seqs_bucket)
    rows = np.zeros(S, np.int32)
    firsts = np.zeros(S, np.int32)
    lasts = np.zeros(S, np.int32)
    seq_mask = np.zeros(S, np.float32)
    rows[:n] = [p[0] for p in layout.placements]
    firsts[:n] = [p[1] for p in layout.placements]
    lasts[:n] = [p[1] + sl - 1 for p, sl in zip(layout.placements, layout.seqlens)]
    seq_mask[:n] = 1.0
    for k, v in scalars.items():
        pad = np.zeros((S,) + v.shape[1:], v.dtype)
        pad[:n] = v
        scalars[k] = pad
    return MicroBatch(
        layout=layout,
        grids=grids,
        scalars=scalars,
        seq_rows=rows,
        seq_first_cols=firsts,
        seq_last_cols=lasts,
        seq_mask=seq_mask,
        sample_indices=list(sample_indices) if sample_indices is not None else
        list(range(sample.bs)),
    )


def scatter_back(
    mbs: List[MicroBatch],
    per_mb_grids: List[np.ndarray],  # [B, L, ...] outputs per micro-batch
    n_samples: int,
) -> List[np.ndarray]:
    """Undo the micro-batch split: per-sample packed arrays in the ORIGINAL
    sample order (inverse of split_into_microbatches)."""
    out: List[Optional[np.ndarray]] = [None] * n_samples
    for mb, g in zip(mbs, per_mb_grids):
        g = np.asarray(g)
        for i, (placement, n) in enumerate(zip(mb.layout.placements, mb.layout.seqlens)):
            row, col = placement
            out[mb.sample_indices[i]] = g[row, col : col + n]
    missing = [i for i, v in enumerate(out) if v is None]
    if missing:
        raise ValueError(f"samples {missing} appear in no micro-batch")
    return out  # type: ignore
