"""Host-side packing: ragged 1-D sequences ⇄ fixed-shape ``[B, L]`` grids.

The port's own copy of ``areal_tpu/models/packing.py`` (numpy). Sequences
are binned into a ``[B, L]`` grid (first-fit-decreasing by length) with:
 - ``tokens [B, L]`` int32, right-padded rows of concatenated sequences,
 - ``segment_ids [B, L]`` — 1-based per-row document ids, 0 = padding,
 - ``positions [B, L]`` — restart at 0 at each document (RoPE positions),
and an index layout to scatter per-token outputs back into the original
packed 1-D host order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from areal_tpu_torch.base import datapack


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class PackLayout:
    """Placement of each input sequence in the [B, L] grid."""

    n_rows: int
    row_len: int
    # per sequence i (in input order): (row, start_col)
    placements: List[Tuple[int, int]]
    seqlens: List[int]

    @property
    def shape(self) -> Tuple[int, int]:
        return self.n_rows, self.row_len


def plan_packing(
    seqlens: Sequence[int],
    length_bucket: int = 128,
    row_len: Optional[int] = None,
    min_rows: int = 1,
    rows_multiple: int = 1,
) -> PackLayout:
    seqlens = [int(s) for s in seqlens]
    if row_len is None:
        row_len = round_up(max(seqlens), length_bucket)
    if max(seqlens) > row_len:
        raise ValueError(f"sequence of length {max(seqlens)} exceeds row_len {row_len}")
    groups = datapack.ffd_allocate(seqlens, row_len, min_groups=min_rows)
    n_rows = round_up(max(len(groups), min_rows), rows_multiple)
    placements: List[Tuple[int, int]] = [None] * len(seqlens)  # type: ignore
    for row, group in enumerate(groups):
        col = 0
        for i in group:
            placements[i] = (row, col)
            col += seqlens[i]
    return PackLayout(
        n_rows=n_rows, row_len=row_len, placements=placements, seqlens=seqlens
    )


def batch_from_packed(
    packed: np.ndarray,  # 1-D concatenation over sequences (input order)
    layout: PackLayout,
    fill=0,
) -> np.ndarray:
    B, L = layout.shape
    out = np.full((B, L) + packed.shape[1:], fill, dtype=packed.dtype)
    off = 0
    for (row, col), n in zip(layout.placements, layout.seqlens):
        out[row, col : col + n] = packed[off : off + n]
        off += n
    return out


def packed_from_batch(batch: np.ndarray, layout: PackLayout) -> np.ndarray:
    parts = []
    for (row, col), n in zip(layout.placements, layout.seqlens):
        parts.append(batch[row, col : col + n])
    return np.concatenate(parts, axis=0)


def make_grid(layout: PackLayout) -> Dict[str, np.ndarray]:
    """segment_ids / positions for a layout."""
    B, L = layout.shape
    seg = np.zeros((B, L), dtype=np.int32)
    pos = np.zeros((B, L), dtype=np.int32)
    row_doc_count = [0] * B
    for (row, col), n in zip(layout.placements, layout.seqlens):
        row_doc_count[row] += 1
        seg[row, col : col + n] = row_doc_count[row]
        pos[row, col : col + n] = np.arange(n)
    return {"segment_ids": seg, "positions": pos}
