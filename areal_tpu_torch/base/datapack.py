"""Balanced partitioning of variable-length sequences.

The port's own copy of ``areal_tpu/base/datapack.py`` (contiguous balanced
partition, first-fit-decreasing allocation, greedy balanced groups), numpy
and Python only. The reference's native first-fit-decreasing path
(``_ffd_native:82`` over its C++ host library) gives the same bins faster
for large inputs; its port is a later item, not a kernel.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = [
    "partition_contiguous_balanced",
    "ffd_allocate",
    "balanced_groups",
]


def _feasible(sizes: np.ndarray, k: int, cap: int) -> bool:
    groups = 1
    cur = 0
    for s in sizes:
        if s > cap:
            return False
        if cur + s > cap:
            groups += 1
            cur = int(s)
            if groups > k:
                return False
        else:
            cur += int(s)
    return True


def partition_contiguous_balanced(sizes: Sequence[int], k: int) -> List[List[int]]:
    """Split ``sizes`` into exactly ``k`` contiguous index groups minimizing the
    maximum group sum. Every group is non-empty (requires ``len(sizes) >= k``).

    Returns a list of k lists of indices (contiguous, in order).
    """
    sizes = np.asarray(sizes, dtype=np.int64)
    n = len(sizes)
    if n < k:
        raise ValueError(f"cannot partition {n} items into {k} non-empty groups")
    if k <= 0:
        raise ValueError("k must be positive")
    lo, hi = int(sizes.max()), int(sizes.sum())
    while lo < hi:
        mid = (lo + hi) // 2
        if _feasible(sizes, k, mid):
            hi = mid
        else:
            lo = mid + 1
    cap = lo
    # Greedy split with the found bottleneck; then fix up to exactly k groups.
    bounds = [0]
    cur = 0
    for i, s in enumerate(sizes):
        if cur + s > cap:
            bounds.append(i)
            cur = int(s)
        else:
            cur += int(s)
    bounds.append(n)
    # We may have fewer than k groups; split the largest groups further.
    while len(bounds) - 1 < k:
        spans = [(bounds[i + 1] - bounds[i], i) for i in range(len(bounds) - 1)]
        spans.sort(reverse=True)
        width, idx = spans[0]
        if width < 2:
            raise RuntimeError("cannot split further")  # unreachable given n >= k
        mid = bounds[idx] + width // 2
        bounds = sorted(set(bounds) | {mid})
    return [list(range(bounds[i], bounds[i + 1])) for i in range(k)]


def ffd_allocate(
    sizes: Sequence[int], capacity: int, min_groups: int = 1,
) -> List[List[int]]:
    """First-fit-decreasing bin packing: group indices so that each group's
    total size is <= capacity (single items larger than capacity get their own
    group), producing at least ``min_groups`` groups when possible."""
    bins: List[List[int]] = []
    loads: List[int] = []
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    for i in order:
        s = int(sizes[i])
        for b in range(len(bins)):
            if loads[b] + s <= capacity:
                bins[b].append(i)
                loads[b] += s
                break
        else:
            bins.append([i])
            loads.append(s)
    while len(bins) < min_groups and any(len(b) > 1 for b in bins):
        # Split the heaviest bin among those that can be split.
        candidates = [j for j in range(len(bins)) if len(bins[j]) > 1]
        b = max(candidates, key=lambda j: loads[j])
        moved = bins[b].pop()
        loads[b] -= int(sizes[moved])
        bins.append([moved])
        loads.append(int(sizes[moved]))
    # Keep deterministic order within groups.
    for b in bins:
        b.sort()
    bins.sort(key=lambda g: g[0])
    return bins


def balanced_groups(sizes: Sequence[int], k: int) -> List[List[int]]:
    """Non-contiguous k-way balanced partition (greedy LPT): assign each item
    (largest first) to the currently lightest group. Groups may be empty only
    when len(sizes) < k.
    """
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    groups: List[List[int]] = [[] for _ in range(k)]
    loads = [0] * k
    for i in order:
        b = int(np.argmin(loads))
        groups[b].append(i)
        loads[b] += int(sizes[i])
    for g in groups:
        g.sort()
    return groups
