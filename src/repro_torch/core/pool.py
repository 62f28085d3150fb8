"""Parameter-sharing pool — paper §IV-B-2.

The port's own copy of ``src/repro/core/pool.py``: the same code,
importing from ``repro_torch`` only, held equal to the reference by
``tests/test_torch_control.py``.

All layers of the region containing the optimal segmentation point are kept
resident on BOTH tiers, so the split can move inside the pool without
shipping weights.  The paper sizes the pool at "the block containing the
optimal segmentation point" and reports a 2.55–2.62 % weight overhead
(Fig. 6); we size it the same way: grow symmetrically around the optimal
split until the next layer would exceed ``overhead_target`` of total model
weights (at least one layer on each side when possible).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

from .structure import LayerCost, total_weight_bytes


@dataclasses.dataclass(frozen=True)
class Pool:
    start: int                   # first layer index in the pool
    end: int                     # one-past-last
    bytes: float                 # pooled weight bytes (replicated once extra)
    overhead_frac: float         # bytes / total model bytes

    def splits(self) -> range:
        """Candidate split positions inside the pool (layer boundaries)."""
        return range(self.start, self.end + 1)

    def contains(self, split: int) -> bool:
        return self.start <= split <= self.end

    def clamp(self, split: int) -> int:
        """Nearest in-pool split position: a planned cut outside
        ``[start, end]`` would ship weights, so it snaps to the pool
        edge.  Equivalent to ``np.clip(split, start, end)`` but stays in
        plain Python ints — the fleet hot path calls this per request."""
        return min(max(int(split), self.start), self.end)


def build_pool(graph: Sequence[LayerCost], optimal_split: int,
               overhead_target: float = 0.026) -> Pool:
    """Grow [start, end) around the split, greedily adding the *cheapest*
    neighbouring layer first.  This maximises the number of candidate split
    positions inside the byte budget — letting the pool span structure
    transitions (e.g. LLM→DiT) where transfer volumes actually differ, which
    is what makes the ΔNB adjustment effective (paper Fig. 3).  If no
    neighbour fits the budget, the smaller one is included anyway (the paper
    always pools at least the block containing the split)."""
    n = len(graph)
    total = total_weight_bytes(graph)
    budget = overhead_target * total
    lo = hi = max(0, min(optimal_split, n))
    pooled = 0.0
    while True:
        cand = []
        if lo > 0:
            cand.append(("lo", graph[lo - 1].weight_bytes))
        if hi < n:
            cand.append(("hi", graph[hi].weight_bytes))
        if not cand:
            break
        side, cost = min(cand, key=lambda t: t[1])
        if pooled + cost > budget:
            if pooled > 0.0:
                break
            # force-include the cheaper neighbour (≥1 pooled layer)
        if side == "lo":
            lo -= 1
        else:
            hi += 1
        pooled += cost
        if pooled > budget:
            break
    return Pool(start=lo, end=hi, bytes=pooled,
                overhead_frac=pooled / total if total else 0.0)


def pool_transfer_profile(graph: Sequence[LayerCost], pool: Pool,
                          codec=None) -> List[float]:
    """Wire bytes for each candidate split inside the pool.  ``codec``
    (name or ``core.codec.Codec``) reports the *compressed* on-wire bytes
    a robot pinned to that codec would ship — a reporting/benchmark view;
    the ΔNB adjuster prices its joint split×codec move itself in
    ``core/adjustment.py`` (per-codec, with encode/decode compute)."""
    from .codec import get_codec
    from .segmentation import codec_applies, cut_bytes
    c = get_codec(codec)
    out = []
    for s in pool.splits():
        raw = cut_bytes(graph, s)
        if c is not None and codec_applies(s, len(graph)):
            raw = c.wire_bytes(raw)
        out.append(raw)
    return out
