"""K-segment edge/cloud placement plans — the multi-cut generalization.

The port's own copy of ``src/repro/core/placement.py``: the same code,
importing from ``repro_torch`` only, held equal to the reference by
``tests/test_torch_control.py``.

Every decision layer in this repo historically carried one bare ``int``:
split ``S`` meant layers ``[0, S)`` on the edge and ``[S, n)`` on the
cloud.  That representation cannot express the placement real VLA stacks
often want — *edge → cloud → edge*, where the heavy LLM trunk is offloaded
but the byte-heavy, compute-light action head stays on the robot (RAPID,
arXiv 2603.07949, makes the multi-segment compatibility argument;
ActionFlow, arXiv 2512.20276, shows the action-stage-on-edge pattern).

``PlacementPlan`` is the shared first-class plan object:

* ``cuts`` — ordered layer indices where the model is severed (K cuts make
  K+1 segments over ``[0, n)``; segment ``i`` spans ``[cuts[i-1], cuts[i])``
  with the implicit boundaries 0 and n);
* ``tiers`` — one tier name per segment (``"edge"`` / ``"cloud"``);
* ``cut_codecs`` — one transport codec name per cut (``None`` = raw), the
  per-cut companion of ``core/codec.py``;
* ``cut_chunks`` — one streaming chunk count per cut (``1`` = the
  sequential transfer), the per-cut companion of ``core/pipeline.py``:
  a cut with ``n_chunks > 1`` ships its activation in token-axis chunk
  slices through the 3-stage (encode → uplink → decode+prefill)
  pipeline, so the planner prices a makespan instead of a sum.

The single-split world is the K=1 special case (``PlacementPlan.single``),
and an empty-segment plan normalizes back down to it — so every consumer
(``segmentation.evaluate_placement`` / ``search_multicut``,
``adjustment.adjust_placement``, ``controller.RoboECC(multicut=True)``,
``runtime/fleet.py``) degrades to the paper's Alg. 1 behaviour when no
second cut pays for itself.

Transport direction is derived from the tier pair around a cut: an
edge→cloud cut is an **uplink** (priced on the robot's uplink bandwidth,
encode on the edge device) and a cloud→edge cut is a **downlink** (priced
on the usually-faster downlink direction — ``down_bw_factor`` — encode on
the cloud device, and carrying only the bytes the receiving segment
consumes, see ``LayerCost.in_transfer_bytes``).  Each cut pays its own
rtt.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

EDGE = "edge"
CLOUD = "cloud"
_TIERS = (EDGE, CLOUD)


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """Ordered cut list + per-segment tier + per-cut codec + per-cut
    streaming chunk count.

    Invariants (checked at construction): ``cuts`` non-decreasing and
    non-negative, ``len(tiers) == len(cuts) + 1``, every tier in
    {"edge", "cloud"}, ``len(cut_codecs) == len(cuts)``,
    ``len(cut_chunks) == len(cuts)`` with every count ``>= 1``.
    Zero-width segments are allowed in the raw representation
    (``normalize`` removes them); they make degenerate forms like
    ``single(n)`` (edge-only with an empty cloud segment) representable
    in the repo's historical encoding.
    """
    cuts: Tuple[int, ...]
    tiers: Tuple[str, ...]
    cut_codecs: Tuple[Optional[str], ...] = ()
    cut_chunks: Tuple[int, ...] = ()

    def __post_init__(self):
        cuts = tuple(int(c) for c in self.cuts)
        tiers = tuple(self.tiers)
        codecs = tuple(self.cut_codecs) if self.cut_codecs \
            else (None,) * len(cuts)
        chunks = tuple(int(k) for k in self.cut_chunks) if self.cut_chunks \
            else (1,) * len(cuts)
        object.__setattr__(self, "cuts", cuts)
        object.__setattr__(self, "tiers", tiers)
        object.__setattr__(self, "cut_codecs", codecs)
        object.__setattr__(self, "cut_chunks", chunks)
        if len(tiers) != len(cuts) + 1:
            raise ValueError(f"need {len(cuts) + 1} tiers for "
                             f"{len(cuts)} cuts, got {len(tiers)}")
        if len(codecs) != len(cuts):
            raise ValueError(f"need {len(cuts)} cut_codecs, got {len(codecs)}")
        if len(chunks) != len(cuts):
            raise ValueError(f"need {len(cuts)} cut_chunks, got {len(chunks)}")
        if any(k < 1 for k in chunks):
            raise ValueError(f"cut_chunks must be >= 1, got {chunks}")
        if any(t not in _TIERS for t in tiers):
            raise ValueError(f"tiers must be in {_TIERS}, got {tiers}")
        if any(c < 0 for c in cuts):
            raise ValueError(f"cuts must be non-negative, got {cuts}")
        if any(a > b for a, b in zip(cuts, cuts[1:])):
            raise ValueError(f"cuts must be non-decreasing, got {cuts}")

    # ------------------------------------------------------------ factories
    @classmethod
    def single(cls, split: int, codec: Optional[str] = None,
               n_chunks: int = 1) -> "PlacementPlan":
        """The historical K=1 plan: edge ``[0, split)``, cloud
        ``[split, n)``.  ``split == n`` is edge-only, ``split == 0``
        cloud-only — same semantics as ``SegmentationResult.split``.
        ``n_chunks`` streams the uplink cut (``core/pipeline.py``)."""
        return cls(cuts=(split,), tiers=(EDGE, CLOUD), cut_codecs=(codec,),
                   cut_chunks=(n_chunks,))

    @classmethod
    def edge_cloud_edge(cls, s1: int, s2: int,
                        up_codec: Optional[str] = None,
                        down_codec: Optional[str] = None,
                        up_chunks: int = 1) -> "PlacementPlan":
        """The VLA-shaped K=2 plan: edge ``[0, s1)`` (vision front), cloud
        ``[s1, s2)`` (LLM trunk), edge ``[s2, n)`` (action tail).
        ``up_chunks`` streams the uplink cut; the downlink carries the
        small semantic tail slice and never streams (DESIGN.md §9)."""
        return cls(cuts=(s1, s2), tiers=(EDGE, CLOUD, EDGE),
                   cut_codecs=(up_codec, down_codec),
                   cut_chunks=(up_chunks, 1))

    @classmethod
    def from_window(cls, s1: int, s2: int, n: int,
                    codec: Optional[str] = None,
                    n_chunks: int = 1) -> "PlacementPlan":
        """Canonical plan for the cloud window ``[s1, s2)`` of an
        ``n``-layer graph — the one degenerate-case branch every
        materializer shares: ``s2 >= n`` is the single cut at ``s1``,
        ``s1 >= s2`` (empty window) is edge-only (``single(n)``),
        otherwise the real 2-cut edge→cloud→edge plan (both cuts on
        ``codec``).  ``n_chunks`` rides the uplink cut; degenerate
        no-transfer plans pin it back to 1 (streaming nothing is the
        sequential transfer by definition)."""
        if s2 >= n:
            return cls.single(s1, codec, n_chunks if 0 < s1 < n else 1)
        if s1 >= s2:
            return cls.single(n, codec)
        return cls.edge_cloud_edge(s1, s2, codec, codec, n_chunks)

    # ----------------------------------------------------------- structure
    @property
    def n_cuts(self) -> int:
        return len(self.cuts)

    @property
    def is_single(self) -> bool:
        """True when the plan is expressible as one split index (≤1 cut)."""
        return len(self.cuts) <= 1

    def segments(self, n: int) -> Tuple[Tuple[int, int, str], ...]:
        """``(start, end, tier)`` triples covering ``[0, n)`` in order
        (zero-width segments included; see ``normalize``)."""
        bounds = (0,) + self.cuts + (n,)
        return tuple((bounds[i], bounds[i + 1], self.tiers[i])
                     for i in range(len(self.tiers)))

    def normalize(self, n: int) -> "PlacementPlan":
        """Canonical form for a graph of ``n`` layers: drop zero-width
        segments, merge adjacent same-tier segments (removing the cut and
        its codec between them).  ``edge_cloud_edge(s, n)`` normalizes to
        ``single(s)``; an all-edge plan to ``single(n)``; an all-cloud plan
        to ``single(0)`` — the historical encodings."""
        # each non-first segment carries the codec/chunks of its leading cut
        segs = [(a, b, t, self.cut_codecs[i - 1] if i else None,
                 self.cut_chunks[i - 1] if i else 1)
                for i, (a, b, t) in enumerate(self.segments(n)) if b > a]
        merged: list = []
        for a, b, t, cdc, k in segs:
            if merged and merged[-1][2] == t:
                # same-tier neighbours: the cut between them vanishes
                merged[-1] = (merged[-1][0], b, t, merged[-1][3],
                              merged[-1][4])
            else:
                merged.append((a, b, t, cdc, k))
        if not merged:                       # n == 0 degenerate graph
            return PlacementPlan.single(0)
        if len(merged) == 1:
            return PlacementPlan.single(n if merged[0][2] == EDGE else 0)
        return PlacementPlan(
            cuts=tuple(seg[0] for seg in merged[1:]),
            tiers=tuple(seg[2] for seg in merged),
            cut_codecs=tuple(seg[3] for seg in merged[1:]),
            cut_chunks=tuple(seg[4] for seg in merged[1:]))

    def primary_cut(self, n: int) -> int:
        """The first real edge→cloud boundary — what legacy ``split``
        consumers read.  Edge-only plans report ``n``."""
        norm = self.normalize(n)
        return norm.cuts[0] if norm.tiers[0] == EDGE and norm.n_cuts >= 1 \
            else 0

    def primary_chunks(self, n: int) -> int:
        """Streaming chunk count of the primary edge→cloud cut (1 when the
        plan has no real uplink — edge-only / cloud-first plans)."""
        norm = self.normalize(n)
        return norm.cut_chunks[0] if norm.tiers[0] == EDGE \
            and norm.n_cuts >= 1 else 1

    def tail_cut(self, n: int) -> int:
        """The cloud→edge boundary of an edge→cloud→edge plan, or ``n``
        when the plan is single-cut (no on-edge tail)."""
        norm = self.normalize(n)
        if norm.n_cuts >= 2 and norm.tiers[-1] == EDGE:
            return norm.cuts[-1]
        return n

    def describe(self, n: int) -> str:
        parts = []
        for i, (a, b, t) in enumerate(self.segments(n)):
            if b <= a:
                continue
            cdc = self.cut_codecs[i - 1] if 0 < i <= len(self.cut_codecs) \
                else None
            k = self.cut_chunks[i - 1] if 0 < i <= len(self.cut_chunks) else 1
            stream = f" x{k}" if k > 1 else ""
            arrow = f"--{cdc or 'raw'}{stream}--> " if parts else ""
            parts.append(f"{arrow}{t}[{a},{b})")
        return " ".join(parts) if parts else "empty"
