"""Exact statistics over every sample: percentiles, rates and the union of
time intervals.  No sketch and no sampling."""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    sample with at least ``q`` % of the samples at or below it.  Always a
    value that was observed."""
    if not values:
        raise ValueError("percentile of no samples")
    if not 0.0 < q <= 100.0:
        raise ValueError(f"percentile {q} outside (0, 100]")
    ordered = sorted(values)
    rank = math.ceil(q / 100.0 * len(ordered))
    return ordered[max(rank, 1) - 1]


def median(values: Sequence[float]) -> float:
    """The middle sample, or the mean of the two middle samples."""
    if not values:
        raise ValueError("median of no samples")
    ordered = sorted(values)
    n = len(ordered)
    mid = n // 2
    return ordered[mid] if n % 2 else 0.5 * (ordered[mid - 1] + ordered[mid])


def rate(count: float, seconds: float) -> float:
    if seconds <= 0.0:
        raise ValueError(f"rate over a window of {seconds} s")
    return count / seconds


def union(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """Merge ``(start, end)`` intervals into disjoint, sorted ones; touching
    intervals merge.  Empty or reversed intervals are dropped."""
    merged: List[Tuple[float, float]] = []
    for start, end in sorted(i for i in intervals if i[1] > i[0]):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
        else:
            merged.append((start, end))
    return merged


def covered(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of the intervals."""
    return sum(end - start for start, end in union(intervals))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The parts of ``[lo, hi]`` that no interval covers."""
    out, at = [], lo
    for start, end in union(intervals):
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if start > at:
            out.append((at, start))
        at = max(at, end)
    if hi > at:
        out.append((at, hi))
    return out
