"""Optimal model segmentation — paper Alg. 1.

The port's own copy of ``src/repro/core/segmentation.py``: the same code,
importing from ``repro_torch`` only, held equal to the reference by
``tests/test_torch_control.py``.

Split semantics: split index ``S`` means layers ``[0, S)`` run on the edge
and ``[S, n)`` on the cloud; the cut activation is the output of layer
``S-1`` (for ``S=0``, the raw model input is shipped — cloud-only; for
``S=n`` nothing is shipped — edge-only).

The search walks from the last layer towards the front (paper: "start from
the last layer and identify the optimal segmentation point within the
allowable cloud-side load range"), i.e. it grows the cloud set until the
cloud load budget ``B_cloud`` is exhausted, tracking the latency-optimal
feasible split.  All inputs come from the analytic structure+hardware
models, so the search itself costs microseconds (paper §IV-A-3: "extremely
low computational load ... negligible overhead").

Codec-aware transport (``core/codec.py``): a ``codec`` prices the cut
activation as encode(edge) + compressed-wire + rtt + decode(cloud) for any
**mid-graph** split (``0 < S < n``); the ``S = 0`` raw-observation upload
and the ``S = n`` no-transfer extremes are codec-free by construction.
``search_joint`` / the ``codecs=`` axis of ``search_vec``/``sweep_search``
search (split × codec) jointly — latency ties break toward the earliest
codec in the list, then the largest split within that codec (so put the
preferred / lossless codec first).

Multi-cut placements (``core/placement.py``): ``evaluate_placement``
prices an arbitrary K-segment ``PlacementPlan``, and ``search_multicut`` /
``sweep_multicut`` scan every edge→cloud→edge plan ``(S1, S2)`` — edge
``[0, S1)``, cloud ``[S1, S2)``, edge ``[S2, n)`` — in one
(codec × S1 × S2 × bandwidth) numpy pass over the triangular ``S1 ≤ S2``
mask.  The uplink cut at ``S1`` is priced exactly like the single-cut
transport; the downlink cut at ``S2`` is priced separately: it carries
only the bytes the tail segment consumes (``LayerCost.in_transfer_bytes``,
small for action heads), rides the usually-faster downlink direction
(``down_bw_factor`` × uplink bandwidth), pays a second rtt, and encodes on
the cloud / decodes on the edge.  ``S2 = n`` collapses to the single-cut
row, ``S1 = S2`` to edge-only — so the single-split world is the K=1
special case, and latency ties prefer it (largest ``S2`` wins ties).
Cloud budget feasibility is the **window** load ``weights[S1:S2)`` — the
knob that makes multi-cut genuinely better: under a tight per-robot cloud
quota the byte-heavy but compute-light action head can stay on the edge,
freeing quota for one more expensive trunk layer on the cloud.

Streamed execution (``core/pipeline.py``): ``search_streamed`` /
``search_streamed_scalar`` add a chunk-count axis ``K`` — the uplink cut
activation ships in token-axis chunks through a 3-stage pipeline (edge
encode → per-chunk wire+rtt → cloud decode + chunked prefill of the
window), so those cells price a *makespan* instead of a sum.  The
``K = 1`` plane is the sequential (C, S1, S2, B) tensor shared with
``search_multicut`` (``_plan_tensors``), which is what makes
``n_chunks = 1`` reproduce the non-streamed results exactly; ties prefer
the smallest chunk count, so chunking only appears where it strictly
pays.  ``sweep_multicut(chunk_grid=...)`` extends the fleet plan table
with the same axis.

Queue-aware planning (``queue_hz=``): every search accepts an expected
per-replica arrival rate and adds an M/G/1 expected-wait term
``queue_delay_s`` for the cloud-side service time of each candidate —
Alg. 1 stops assuming an idle cloud, so under congestion the optimum
retreats toward the edge exactly where the fleet's replicas queue.  The
term is a *planning prior*, not a realized latency: ``total_s`` includes
it but the ``edge_s``/``cloud_s``/``net_s`` decomposition stays
physical, so components no longer sum to ``total_s`` when
``queue_hz > 0``.  ``queue_hz = 0`` (the default) adds nothing and
reproduces the queue-blind plans bit-for-bit (docs/DESIGN.md §10).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from .codec import Codec, get_codec, resolve_codecs, transport_s
from .hardware import DeviceSpec, layer_latency
from .pipeline import (DEFAULT_CHUNK_GRID, stream_applies,
                       stream_bubble_fraction, stream_makespan,
                       stream_makespan_scalar)
from .placement import CLOUD, EDGE, PlacementPlan
from .structure import LayerCost


@dataclasses.dataclass(frozen=True)
class SegmentationResult:
    split: int
    total_s: float
    edge_s: float
    cloud_s: float
    net_s: float
    cloud_load_bytes: float
    edge_load_bytes: float
    feasible: List[int]          # splits satisfying the budget
    latencies: List[float]       # total latency per candidate split index
    codec: Optional[str] = None  # codec the transport was priced with


def cut_bytes(graph: Sequence[LayerCost], split: int,
              input_bytes: float = 0.0) -> float:
    """Wire bytes at split S (output activation of layer S-1)."""
    if split == 0:
        return input_bytes
    if split >= len(graph):
        return 0.0
    return graph[split - 1].out_transfer_bytes


def codec_applies(split: int, n: int) -> bool:
    """Codecs compress mid-graph activations only: the split-0 raw
    observation ships as-is and the split-n extreme ships nothing."""
    return 0 < split < n


def downlink_bytes(graph: Sequence[LayerCost], cut: int) -> float:
    """Wire bytes of a cloud→edge cut at ``cut``: what the tail segment
    starting at layer ``cut`` actually consumes.  Defaults to the full
    upstream activation (``cut_bytes``); action heads override it with
    their small conditioning slice (``LayerCost.in_transfer_bytes``)."""
    if cut >= len(graph):
        return 0.0
    need = graph[cut].in_transfer_bytes
    if need is not None:
        return need
    return cut_bytes(graph, cut)


def net_time(wire_raw: float, bandwidth_bps: float, *, rtt_s: float = 0.0,
             codec: Optional[Codec] = None, applicable: bool = True,
             edge: Optional[DeviceSpec] = None,
             cloud: Optional[DeviceSpec] = None) -> float:
    """Transport seconds for one cut activation of ``wire_raw`` raw bytes.
    With a codec (and ``applicable``): encode on ``edge`` + compressed wire
    + rtt + decode on ``cloud``; otherwise raw wire + rtt.  Zero raw bytes
    cost zero (bandwidth in BYTES/s throughout the repo)."""
    if not wire_raw:
        return 0.0
    if codec is None or not applicable:
        return wire_raw / bandwidth_bps + rtt_s
    return transport_s(wire_raw, bandwidth_bps, codec, edge, cloud,
                       rtt_s=rtt_s)


def queue_delay_s(service_s, arrival_hz: float, *, cv2: float = 1.0,
                  service_scale: float = 1.0):
    """Expected M/G/1 queueing wait (Pollaczek–Khinchine) for a cloud
    window whose solo service time is ``service_s`` seconds:

        W = λ·S²·(1 + cv²) / (2·(1 − ρ)),   ρ = λ·S

    with ``λ = arrival_hz`` (requests/s reaching ONE replica), ``cv²``
    the squared coefficient of variation of service times (1 ≡ M/M/1;
    the fleet's lognormal straggler noise puts it slightly above), and
    ``S = service_s · service_scale`` (``service_scale`` folds in the
    mean batching efficiency ``eff(k)/k`` of the continuous batcher).
    ``ρ ≥ 1`` → ``inf`` (saturated: the planner retreats toward the
    edge, whose wait is 0 by construction); ``S ≤ 0`` → 0.  Elementwise
    over numpy arrays; scalar in → float out."""
    S = np.asarray(service_s, dtype=np.float64) * service_scale
    if arrival_hz <= 0:
        w = np.zeros_like(S)
    else:
        rho = arrival_hz * S
        with np.errstate(divide="ignore", invalid="ignore"):
            w = arrival_hz * S * S * (1.0 + cv2) / (2.0 * (1.0 - rho))
        w = np.where(S <= 0, 0.0, np.where(rho >= 1.0, np.inf, w))
    return float(w) if np.ndim(service_s) == 0 else w


def evaluate_split(graph: Sequence[LayerCost], split: int,
                   edge: DeviceSpec, cloud: DeviceSpec,
                   bandwidth_bps: float, *, rtt_s: float = 0.0,
                   input_bytes: float = 0.0,
                   codec: Optional[Codec] = None):
    edge_s = sum(layer_latency(c, edge) for c in graph[:split])
    cloud_s = sum(layer_latency(c, cloud) for c in graph[split:])
    wire = cut_bytes(graph, split, input_bytes)
    net_s = net_time(wire, bandwidth_bps, rtt_s=rtt_s, codec=codec,
                     applicable=codec_applies(split, len(graph)),
                     edge=edge, cloud=cloud)
    return edge_s, cloud_s, net_s


def search(graph: Sequence[LayerCost], edge: DeviceSpec, cloud: DeviceSpec,
           bandwidth_bps: float, cloud_budget_bytes: Optional[float] = None,
           *, rtt_s: float = 0.0, input_bytes: float = 0.0,
           codec: Optional[Codec] = None, queue_hz: float = 0.0,
           queue_cv2: float = 1.0,
           queue_service_scale: float = 1.0) -> SegmentationResult:
    """Alg. 1: scan S from n (edge-only) towards 0 while the cloud-side load
    fits the budget; keep the latency-optimal feasible split.  ``codec``
    prices mid-graph transport through ``core/codec.py`` (encode + wire +
    decode), so compression participates in WHERE the cut lands.
    ``queue_hz > 0`` adds the M/G/1 expected wait ``queue_delay_s`` of
    each candidate's cloud service time to its total (module docstring:
    the wait is in ``total_s``/``latencies`` but not in the physical
    component decomposition)."""
    codec = get_codec(codec)
    n = len(graph)
    budget = cloud_budget_bytes if cloud_budget_bytes is not None else float("inf")
    feasible: List[int] = []
    latencies: List[float] = []
    best = None
    cloud_load = 0.0
    for s in range(n, -1, -1):          # S = n, n-1, ..., 0
        if s < n:
            cloud_load += graph[s].weight_bytes
        if cloud_load > budget:
            break                        # paper line 4: budget exhausted
        e, c, t = evaluate_split(graph, s, edge, cloud, bandwidth_bps,
                                 rtt_s=rtt_s, input_bytes=input_bytes,
                                 codec=codec)
        total = e + c + t
        if queue_hz > 0:
            total += queue_delay_s(c, queue_hz, cv2=queue_cv2,
                                   service_scale=queue_service_scale)
        feasible.append(s)
        latencies.append(total)
        if best is None or total < best[1]:
            best = (s, total, e, c, t, cloud_load)
    assert best is not None, "no feasible split (budget < 0?)"
    s, total, e, c, t, load = best
    edge_load = sum(g.weight_bytes for g in graph[:s])
    return SegmentationResult(split=s, total_s=total, edge_s=e, cloud_s=c,
                              net_s=t, cloud_load_bytes=load,
                              edge_load_bytes=edge_load,
                              feasible=feasible, latencies=latencies,
                              codec=codec.name if codec else None)


def search_joint(graph: Sequence[LayerCost], edge: DeviceSpec,
                 cloud: DeviceSpec, bandwidth_bps: float,
                 codecs: Sequence, cloud_budget_bytes: Optional[float] = None,
                 *, rtt_s: float = 0.0, input_bytes: float = 0.0,
                 max_err: Optional[float] = None, queue_hz: float = 0.0,
                 queue_cv2: float = 1.0,
                 queue_service_scale: float = 1.0) -> SegmentationResult:
    """Scalar joint (split × codec) oracle: run Alg. 1 once per codec (in
    list order) and keep the first strict latency winner — the tie-break
    the vectorized codec axis reproduces (earliest codec in the list,
    then the largest split within that codec).  The property-test oracle
    for ``search_vec(codecs=...)``."""
    cs = resolve_codecs(codecs, max_err)
    best: Optional[SegmentationResult] = None
    for c in cs:
        seg = search(graph, edge, cloud, bandwidth_bps, cloud_budget_bytes,
                     rtt_s=rtt_s, input_bytes=input_bytes, codec=c,
                     queue_hz=queue_hz, queue_cv2=queue_cv2,
                     queue_service_scale=queue_service_scale)
        if best is None or seg.total_s < best.total_s:
            best = seg
    return best


def exhaustive_best(graph: Sequence[LayerCost], edge: DeviceSpec,
                    cloud: DeviceSpec, bandwidth_bps: float,
                    cloud_budget_bytes: Optional[float] = None,
                    **kw) -> int:
    """Brute-force argmin over feasible splits (property-test oracle)."""
    n = len(graph)
    budget = cloud_budget_bytes if cloud_budget_bytes is not None else float("inf")
    best_s, best_t = None, None
    for s in range(n + 1):
        load = sum(c.weight_bytes for c in graph[s:])
        if load > budget:
            continue
        e, c, t = evaluate_split(graph, s, edge, cloud, bandwidth_bps, **kw)
        if best_t is None or e + c + t < best_t:
            best_s, best_t = s, e + c + t
    return best_s


# --------------------------------------------------------------- vectorized
@dataclasses.dataclass(frozen=True)
class GraphArrays:
    """Per-split cost arrays for one layer graph, all of shape ``(n+1,)``
    indexed by split ``S`` (same semantics as the module docstring).

    Units: latencies in seconds, loads and wire volumes in bytes.  Computed
    once per (graph, edge, cloud) triple, these arrays turn every downstream
    latency query into O(1) indexing and every Alg. 1 search into one numpy
    pass — the fleet simulator's per-tick hot path.
    """
    edge_s: np.ndarray          # prefix edge latency of layers [0, S)
    cloud_s: np.ndarray         # suffix cloud latency of layers [S, n)
    wire_bytes: np.ndarray      # RAW cut activation bytes at split S
    cloud_load_bytes: np.ndarray  # weight bytes the cloud must host at S
    n: int
    # devices the arrays were priced on — lets ``latency`` price codec
    # encode/decode without re-threading DeviceSpecs through every caller
    edge_dev: Optional[DeviceSpec] = None
    cloud_dev: Optional[DeviceSpec] = None
    # RAW cloud→edge downlink bytes if the tail starts at S (semantic
    # in_transfer of layer S; 0 at S = n) — the multi-cut second cut
    down_wire_bytes: Optional[np.ndarray] = None

    def latency(self, split: int, bandwidth_bps: float, rtt_s: float = 0.0,
                codec: Optional[Codec] = None):
        """(edge_s, cloud_s, net_s) at one split — O(1) equivalent of
        ``evaluate_split`` (bandwidth in bytes/s, result in seconds).
        ``codec`` prices mid-graph transport through the codec (encode on
        ``edge_dev``, decode on ``cloud_dev``)."""
        wire = self.wire_bytes[split]
        net = net_time(wire, bandwidth_bps, rtt_s=rtt_s, codec=codec,
                       applicable=codec_applies(split, self.n),
                       edge=self.edge_dev, cloud=self.cloud_dev)
        return float(self.edge_s[split]), float(self.cloud_s[split]), net

    def placement_latency(self, s1: int, s2: int, bandwidth_bps: float,
                          rtt_s: float = 0.0,
                          codec: Optional[Codec] = None,
                          down_bw_factor: float = 1.0):
        """(edge_s, cloud_s, up_s, down_s) of the edge→cloud→edge placement
        edge ``[0, s1)`` / cloud ``[s1, s2)`` / edge ``[s2, n)`` — the O(1)
        equivalent of ``evaluate_placement``.  ``s2 == n`` is the single
        cut (down_s = 0), ``s1 == s2`` edge-only (no transfer at all).
        The downlink leg rides ``down_bw_factor × bandwidth`` and is
        encoded on the cloud device / decoded on the edge device."""
        n = self.n
        e = float(self.edge_s[s1] + self.edge_s[n] - self.edge_s[s2])
        if s1 >= s2:
            return e, 0.0, 0.0, 0.0
        c = float(self.cloud_s[s1] - self.cloud_s[s2])
        up = net_time(self.wire_bytes[s1], bandwidth_bps, rtt_s=rtt_s,
                      codec=codec, applicable=codec_applies(s1, n),
                      edge=self.edge_dev, cloud=self.cloud_dev)
        down = 0.0
        if s2 < n and self.down_wire_bytes is not None:
            down = net_time(self.down_wire_bytes[s2],
                            bandwidth_bps * down_bw_factor, rtt_s=rtt_s,
                            codec=codec, applicable=codec_applies(s2, n),
                            edge=self.cloud_dev, cloud=self.edge_dev)
        return e, c, up, down

    def window_load_bytes(self, s1: int, s2: int) -> float:
        """Cloud-hosted weight bytes of the window ``[s1, s2)``."""
        if s1 >= s2:
            return 0.0
        return float(self.cloud_load_bytes[s1] - self.cloud_load_bytes[s2])


def graph_arrays(graph: Sequence[LayerCost], edge: DeviceSpec,
                 cloud: DeviceSpec, *, input_bytes: float = 0.0
                 ) -> GraphArrays:
    """Precompute prefix/suffix cost arrays for ``search_vec``.

    ``edge_s`` uses a forward cumsum (identical accumulation order to the
    scalar ``evaluate_split``); ``cloud_s``/``cloud_load_bytes`` are suffix
    sums.  ``wire_bytes[0]`` is ``input_bytes`` (cloud-only ships the raw
    observation) and ``wire_bytes[n]`` is 0 (edge-only ships nothing).
    """
    n = len(graph)
    e_lat = np.array([layer_latency(c, edge) for c in graph], dtype=np.float64)
    c_lat = np.array([layer_latency(c, cloud) for c in graph], dtype=np.float64)
    w = np.array([c.weight_bytes for c in graph], dtype=np.float64)
    edge_s = np.concatenate([[0.0], np.cumsum(e_lat)])
    cloud_s = np.concatenate([np.cumsum(c_lat[::-1])[::-1], [0.0]])
    load = np.concatenate([np.cumsum(w[::-1])[::-1], [0.0]])
    wire = np.array([cut_bytes(graph, s, input_bytes) for s in range(n + 1)],
                    dtype=np.float64)
    down = np.array([downlink_bytes(graph, s) for s in range(n + 1)],
                    dtype=np.float64)
    return GraphArrays(edge_s=edge_s, cloud_s=cloud_s, wire_bytes=wire,
                       cloud_load_bytes=load, n=n,
                       edge_dev=edge, cloud_dev=cloud,
                       down_wire_bytes=down)


@dataclasses.dataclass(frozen=True)
class VecSearchResult:
    """Alg. 1 results for a whole bandwidth sweep (arrays of shape ``(B,)``;
    bandwidths in bytes/s, latencies in seconds).  When the search ran with
    a codec axis, ``codec_idx[b]`` indexes ``codec_names`` — the codec the
    joint (split × codec) optimum chose at bandwidth ``b``."""
    bandwidths_bps: np.ndarray
    splits: np.ndarray           # optimal split per bandwidth (int)
    total_s: np.ndarray
    edge_s: np.ndarray
    cloud_s: np.ndarray
    net_s: np.ndarray
    codec_idx: Optional[np.ndarray] = None
    codec_names: Optional[Tuple[str, ...]] = None


def _codec_wire_split(wire: np.ndarray, n: int, cs: Sequence[Codec],
                      enc_dev: DeviceSpec, dec_dev: DeviceSpec
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-(codec, split) compressed wire bytes and the two codec-compute
    sides SEPARATELY (encode on ``enc_dev``, decode on ``dec_dev``) —
    the streamed pipeline places them in different stages.

    ``wire``: (n+1,) raw cut bytes.  Mid-graph splits (0 < S < n) with
    traffic get the codec's wire factor and encode/decode overhead (both
    linear in raw bytes); the extremes pass through raw.  Shapes (C, n+1).
    """
    app = np.zeros(n + 1, dtype=bool)
    app[1:n] = True
    app &= wire > 0
    factors = np.array([c.wire_factor for c in cs], dtype=np.float64)
    enc_r = np.array([c.encode_s_per_byte(enc_dev) for c in cs],
                     dtype=np.float64)
    dec_r = np.array([c.decode_s_per_byte(dec_dev) for c in cs],
                     dtype=np.float64)
    wire_c = np.where(app[None, :], wire[None, :] * factors[:, None],
                      wire[None, :])
    enc_o = np.where(app[None, :], wire[None, :] * enc_r[:, None], 0.0)
    dec_o = np.where(app[None, :], wire[None, :] * dec_r[:, None], 0.0)
    return wire_c, enc_o, dec_o


def _codec_wire_overhead(wire: np.ndarray, n: int, cs: Sequence[Codec],
                         edge: DeviceSpec, cloud: DeviceSpec
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-(codec, split) compressed wire bytes and COMBINED encode+decode
    seconds — the sequential-transport view (``_codec_wire_split`` summed;
    the sum order matches the historical rate-sum formula)."""
    app = np.zeros(n + 1, dtype=bool)
    app[1:n] = True
    app &= wire > 0
    factors = np.array([c.wire_factor for c in cs], dtype=np.float64)
    rates = np.array([c.encode_s_per_byte(edge) + c.decode_s_per_byte(cloud)
                      for c in cs], dtype=np.float64)
    wire_c = np.where(app[None, :], wire[None, :] * factors[:, None],
                      wire[None, :])
    ovh = np.where(app[None, :], wire[None, :] * rates[:, None], 0.0)
    return wire_c, ovh


def search_vec(graph: Sequence[LayerCost], edge: DeviceSpec,
               cloud: DeviceSpec, bandwidths_bps,
               cloud_budget_bytes: Optional[float] = None, *,
               rtt_s: float = 0.0, input_bytes: float = 0.0,
               arrays: Optional[GraphArrays] = None,
               codecs: Optional[Sequence] = None,
               max_err: Optional[float] = None, queue_hz: float = 0.0,
               queue_cv2: float = 1.0,
               queue_service_scale: float = 1.0) -> VecSearchResult:
    """Vectorized Alg. 1: optimal split for every bandwidth in one pass.

    Equivalent to calling ``search`` once per bandwidth (the scalar path is
    kept as the property-test oracle) but evaluates the whole
    (split × bandwidth) latency matrix with numpy.  The feasible set under
    ``cloud_budget_bytes`` is identical to the scalar scan's because the
    cloud load is a monotone suffix sum — the scan's early break and a mask
    admit exactly the same splits.  Ties break towards the largest split,
    matching the scalar scan (it walks from S=n down and keeps strict
    improvements only).  Bandwidths in BYTES/s, latencies in seconds.

    ``codecs`` adds a codec axis: the (codec × split × bandwidth) tensor is
    evaluated in the same pass and the joint optimum per bandwidth is
    returned (``codec_idx``/``codec_names``).  Equivalent to
    ``search_joint`` per bandwidth: latency ties break toward the earliest
    codec in the list, then the largest split within that codec.
    ``max_err`` drops codecs whose ``err_bound`` exceeds it before the
    search.  ``queue_hz > 0`` adds ``queue_delay_s`` of each split's
    cloud service time to the totals (equivalent to the scalar
    ``search``/``search_joint`` with the same rate).
    """
    ga = arrays if arrays is not None else graph_arrays(
        graph, edge, cloud, input_bytes=input_bytes)
    bw = np.atleast_1d(np.asarray(bandwidths_bps, dtype=np.float64))
    budget = cloud_budget_bytes if cloud_budget_bytes is not None \
        else float("inf")
    cs = resolve_codecs(codecs, max_err)
    cols = np.arange(len(bw))
    qd = queue_delay_s(ga.cloud_s, queue_hz, cv2=queue_cv2,
                       service_scale=queue_service_scale) \
        if queue_hz > 0 else None                    # (n+1,)
    if cs is None:
        net = np.where(ga.wire_bytes[:, None] > 0,
                       ga.wire_bytes[:, None] / bw[None, :] + rtt_s, 0.0)
        totals = ga.edge_s[:, None] + ga.cloud_s[:, None] + net   # (n+1, B)
        if qd is not None:
            totals = totals + qd[:, None]
        totals = np.where((ga.cloud_load_bytes > budget)[:, None],
                          np.inf, totals)
        # argmin over flipped split axis -> largest split wins ties
        splits = ga.n - np.argmin(totals[::-1], axis=0)
        return VecSearchResult(
            bandwidths_bps=bw, splits=splits, total_s=totals[splits, cols],
            edge_s=ga.edge_s[splits], cloud_s=ga.cloud_s[splits],
            net_s=net[splits, cols])

    wire_c, ovh = _codec_wire_overhead(ga.wire_bytes, ga.n, cs, edge, cloud)
    net = np.where(wire_c[:, :, None] > 0,
                   wire_c[:, :, None] / bw[None, None, :] + rtt_s, 0.0) \
        + ovh[:, :, None]                                      # (C, n+1, B)
    totals = ga.edge_s[None, :, None] + ga.cloud_s[None, :, None] + net
    if qd is not None:
        totals = totals + qd[None, :, None]
    totals = np.where((ga.cloud_load_bytes > budget)[None, :, None],
                      np.inf, totals)
    # flatten (codec, flipped-split): first occurrence of the min is the
    # earliest codec at the largest split — the search_joint tie-break
    S = ga.n + 1
    flat = totals[:, ::-1, :].reshape(len(cs) * S, len(bw))
    idx = np.argmin(flat, axis=0)
    codec_idx = idx // S
    splits = ga.n - idx % S
    return VecSearchResult(
        bandwidths_bps=bw, splits=splits,
        total_s=totals[codec_idx, splits, cols],
        edge_s=ga.edge_s[splits], cloud_s=ga.cloud_s[splits],
        net_s=net[codec_idx, splits, cols],
        codec_idx=codec_idx, codec_names=tuple(c.name for c in cs))


def sweep_search(graphs: Mapping[str, Sequence[LayerCost]], edge: DeviceSpec,
                 cloud: DeviceSpec, bandwidths_bps,
                 cloud_budget_bytes: Union[None, float,
                                           Mapping[str, Optional[float]]] = None,
                 *, rtt_s: float = 0.0,
                 input_bytes: Union[float, Mapping[str, float]] = 0.0,
                 codecs: Optional[Sequence] = None,
                 max_err: Optional[float] = None, queue_hz: float = 0.0,
                 queue_cv2: float = 1.0, queue_service_scale: float = 1.0
                 ) -> Dict[str, VecSearchResult]:
    """Fleet-scale plan: Alg. 1 over (model × split × bandwidth × codec) in
    ONE padded numpy pass.

    Graphs of different depths are padded to the deepest model with +inf
    edge latency (those split indices can never win), so a full
    bandwidth-sweep plan for every registered config costs a single
    ``(M, C, S_max+1, B)`` array evaluation instead of ``M × C × B`` Python
    scans (``C = 1`` codec-free when ``codecs`` is None).
    ``cloud_budget_bytes`` and ``input_bytes`` may be scalars or per-model
    mappings.  Bandwidths in BYTES/s, latencies in seconds.  With
    ``codecs``, each model's result carries the joint-optimal
    ``codec_idx``/``codec_names`` per bandwidth (ties: earliest codec,
    then largest split — identical to ``search_joint``).
    """
    names = list(graphs)
    if not names:
        raise ValueError("sweep_search needs at least one graph")
    bw = np.atleast_1d(np.asarray(bandwidths_bps, dtype=np.float64))
    cs = resolve_codecs(codecs, max_err)

    def per_model(val, name, default):
        if isinstance(val, Mapping):
            v = val.get(name, default)
        else:
            v = val if val is not None else default
        return default if v is None else v

    gas = [graph_arrays(graphs[k], edge, cloud,
                        input_bytes=per_model(input_bytes, k, 0.0))
           for k in names]
    S = max(ga.n for ga in gas) + 1
    M = len(names)

    def pad(vals, fill):
        out = np.full((M, S), fill, dtype=np.float64)
        for i, v in enumerate(vals):
            out[i, :len(v)] = v
        return out

    E = pad([ga.edge_s for ga in gas], np.inf)
    C = pad([ga.cloud_s for ga in gas], 0.0)
    W = pad([ga.wire_bytes for ga in gas], 0.0)
    L = pad([ga.cloud_load_bytes for ga in gas], 0.0)
    budgets = np.array([per_model(cloud_budget_bytes, k, float("inf"))
                        for k in names], dtype=np.float64)
    infeasible = (L > budgets[:, None])                        # (M, S)
    cols = np.arange(len(bw))
    # queue prior on the padded cloud-service matrix: padded cells carry
    # cloud_s = 0 so their wait is 0 (and their edge_s = inf anyway)
    qd = queue_delay_s(C, queue_hz, cv2=queue_cv2,
                       service_scale=queue_service_scale) \
        if queue_hz > 0 else None                              # (M, S)

    if cs is None:
        net = np.where(W[:, :, None] > 0, W[:, :, None] / bw[None, None, :]
                       + rtt_s, 0.0)
        totals = E[:, :, None] + C[:, :, None] + net           # (M, S, B)
        if qd is not None:
            totals = totals + qd[:, :, None]
        totals = np.where(infeasible[:, :, None], np.inf, totals)
        splits = (S - 1) - np.argmin(totals[:, ::-1, :], axis=1)  # (M, B)
        out: Dict[str, VecSearchResult] = {}
        for i, k in enumerate(names):
            s = splits[i]
            out[k] = VecSearchResult(
                bandwidths_bps=bw, splits=s, total_s=totals[i][s, cols],
                edge_s=E[i][s], cloud_s=C[i][s], net_s=net[i][s, cols])
        return out

    # codec axis: (M, C, S) wire/overhead via the shared per-model helper
    wire_c = np.empty((M, len(cs), S), dtype=np.float64)
    ovh = np.empty((M, len(cs), S), dtype=np.float64)
    for i, ga in enumerate(gas):
        wc, ov = _codec_wire_overhead(W[i, :ga.n + 1], ga.n, cs, edge, cloud)
        wire_c[i, :, :ga.n + 1], ovh[i, :, :ga.n + 1] = wc, ov
        wire_c[i, :, ga.n + 1:], ovh[i, :, ga.n + 1:] = 0.0, 0.0
    net = np.where(wire_c[..., None] > 0,
                   wire_c[..., None] / bw[None, None, None, :] + rtt_s, 0.0) \
        + ovh[..., None]                                    # (M, C, S, B)
    totals = E[:, None, :, None] + C[:, None, :, None] + net
    if qd is not None:
        totals = totals + qd[:, None, :, None]
    totals = np.where(infeasible[:, None, :, None], np.inf, totals)
    flat = totals[:, :, ::-1, :].reshape(M, len(cs) * S, len(bw))
    idx = np.argmin(flat, axis=1)                           # (M, B)
    codec_idx = idx // S
    splits = (S - 1) - idx % S
    codec_names = tuple(c.name for c in cs)
    out = {}
    for i, k in enumerate(names):
        s, ci = splits[i], codec_idx[i]
        out[k] = VecSearchResult(
            bandwidths_bps=bw, splits=s, total_s=totals[i][ci, s, cols],
            edge_s=E[i][s], cloud_s=C[i][s], net_s=net[i][ci, s, cols],
            codec_idx=ci, codec_names=codec_names)
    return out


# ------------------------------------------------------------ multi-cut
@dataclasses.dataclass(frozen=True)
class PlacementEval:
    """One priced ``PlacementPlan``: latency decomposition in seconds plus
    the cloud-hosted weight load.  ``up_s``/``down_s`` are the edge→cloud /
    cloud→edge transport legs (each includes its own rtt and codec
    encode/decode compute); ``net_s = up_s + down_s``.  For a streamed
    evaluation (``n_chunks > 1``) the uplink leg is the pipeline's
    *transport-exposed* time ``makespan − cloud_s`` — the cloud window
    prefills arrived chunks concurrently, so ``total_s`` still equals
    ``edge_s + cloud_s + up_s + down_s`` — and ``bubble_frac`` reports the
    modeled fill/drain dead time (``core/pipeline.py``)."""
    plan: PlacementPlan
    total_s: float
    edge_s: float
    cloud_s: float
    up_s: float
    down_s: float
    cloud_load_bytes: float
    codec: Optional[str] = None
    n_chunks: int = 1
    bubble_frac: float = 0.0

    @property
    def net_s(self) -> float:
        return self.up_s + self.down_s


def evaluate_placement(graph: Sequence[LayerCost], plan: PlacementPlan,
                       edge: DeviceSpec, cloud: DeviceSpec,
                       bandwidth_bps: float, *, rtt_s: float = 0.0,
                       input_bytes: float = 0.0,
                       down_bw_factor: float = 1.0,
                       streamed: bool = False) -> PlacementEval:
    """Price an arbitrary K-segment placement: per-segment compute on its
    tier plus one transport leg per tier-changing cut.  Edge→cloud cuts
    (uplinks) ship the cut activation (``cut_bytes``; the raw observation
    at cut 0) on the uplink bandwidth with encode-on-edge /
    decode-on-cloud; cloud→edge cuts (downlinks) ship only what the
    receiving segment consumes (``downlink_bytes``) on
    ``down_bw_factor × bandwidth`` with encode-on-cloud / decode-on-edge.
    Every real cut pays ``rtt_s``.  The K=1 plan reproduces
    ``evaluate_split`` exactly.

    ``streamed=True`` honours the plan's per-cut ``cut_chunks``: an
    uplink cut with ``n_chunks > 1`` is priced as the 3-stage chunk
    pipeline (``core/pipeline.py`` — encode → wire+rtt per chunk →
    decode + chunked prefill of the cloud window), replacing that leg's
    sequential ``up_s`` with the transport-exposed ``makespan − cloud_s``.
    Streaming applies only where a codec would (mid-graph cuts with
    traffic, ``pipeline.stream_applies``); plans whose chunks are all 1
    — and any plan under ``streamed=False`` — price exactly as before."""
    n = len(graph)
    norm = plan.normalize(n)
    dev = {EDGE: edge, CLOUD: cloud}
    edge_s = cloud_s = up_s = down_s = 0.0
    cloud_load = 0.0
    segs = [s for s in norm.segments(n) if s[1] > s[0]]
    seg_times = []
    for a, b, tier in segs:
        t = sum(layer_latency(c, dev[tier]) for c in graph[a:b])
        seg_times.append(t)
        if tier == EDGE:
            edge_s += t
        else:
            cloud_s += t
            cloud_load += sum(c.weight_bytes for c in graph[a:b])
    if segs and segs[0][2] == CLOUD:
        # cloud-first placement: the raw observation still has to reach
        # the cloud — the same codec-free split-0 upload evaluate_split
        # prices (the leading empty edge segment normalizes away, but the
        # wire bytes don't)
        up_s += net_time(cut_bytes(graph, 0, input_bytes), bandwidth_bps,
                         rtt_s=rtt_s, applicable=False)
    stream_leg = None            # (wire_raw, codec, n_chunks) of 1st uplink
    for i in range(1, len(segs)):
        cut, _, dst_tier = segs[i]
        codec = get_codec(norm.cut_codecs[i - 1])
        if dst_tier == CLOUD:               # uplink
            wire = cut_bytes(graph, cut, input_bytes)
            leg = net_time(wire, bandwidth_bps, rtt_s=rtt_s, codec=codec,
                           applicable=codec_applies(cut, n),
                           edge=edge, cloud=cloud)
            up_s += leg
            chunks = norm.cut_chunks[i - 1]
            if streamed and stream_leg is None and chunks > 1 \
                    and stream_applies(cut, n, wire):
                # seg_times[i] is the cloud window THIS uplink feeds —
                # only its prefill overlaps the arriving chunks (later
                # cloud segments, if any, stay sequential)
                stream_leg = (wire, codec, chunks, leg, seg_times[i])
        else:                               # downlink
            wire = downlink_bytes(graph, cut)
            down_s += net_time(wire, bandwidth_bps * down_bw_factor,
                               rtt_s=rtt_s, codec=codec,
                               applicable=codec_applies(cut, n),
                               edge=cloud, cloud=edge)
    n_chunks, bubble = 1, 0.0
    if stream_leg is not None:
        # re-price the streamed uplink leg as the chunk pipeline: its
        # stage-3 work is the cloud decode PLUS the fed window's prefill,
        # so the leg's exposed cost becomes makespan − window_s
        wire, codec, n_chunks, seq_leg, window_s = stream_leg
        enc = codec.encode_s(wire, edge) if codec is not None else 0.0
        dec = codec.decode_s(wire, cloud) if codec is not None else 0.0
        wire_c = codec.wire_bytes(wire) if codec is not None else wire
        m = stream_makespan_scalar(enc, wire_c / bandwidth_bps,
                                   dec + window_s, n_chunks, rtt_s)
        up_s = (up_s - seq_leg) + (m - window_s)
        bubble = float(stream_bubble_fraction(enc, wire_c / bandwidth_bps,
                                              dec + window_s, n_chunks,
                                              rtt_s))
    codec_names = [c for c in norm.cut_codecs if c is not None]
    return PlacementEval(plan=norm, total_s=edge_s + cloud_s + up_s + down_s,
                         edge_s=edge_s, cloud_s=cloud_s, up_s=up_s,
                         down_s=down_s, cloud_load_bytes=cloud_load,
                         codec=codec_names[0] if codec_names else None,
                         n_chunks=n_chunks, bubble_frac=bubble)


@dataclasses.dataclass(frozen=True)
class MulticutResult:
    """Joint (S1 × S2 × codec [× chunks]) optimum for a whole bandwidth
    sweep (arrays of shape ``(B,)``).  ``s2[b] == n`` means the optimum
    collapsed to the single-cut plan at ``s1[b]`` (no on-edge tail);
    ``s1 == s2`` is edge-only.  ``codec_idx`` indexes ``codec_names``
    (both cuts of a plan share the chosen codec).  When the search ran
    with a chunk axis (``search_streamed``), ``n_chunks[b]`` is the
    jointly-optimal streaming chunk count for the uplink cut and
    ``bubble_frac[b]`` the modeled fill/drain fraction of its pipeline
    (``core/pipeline.py``); both are ``None`` for non-streamed
    searches."""
    bandwidths_bps: np.ndarray
    s1: np.ndarray
    s2: np.ndarray
    total_s: np.ndarray
    edge_s: np.ndarray
    cloud_s: np.ndarray
    up_s: np.ndarray
    down_s: np.ndarray
    n: int
    codec_idx: Optional[np.ndarray] = None
    codec_names: Optional[Tuple[str, ...]] = None
    n_chunks: Optional[np.ndarray] = None
    bubble_frac: Optional[np.ndarray] = None

    def codec_at(self, b: int) -> Optional[str]:
        if self.codec_idx is None:
            return None
        return self.codec_names[int(self.codec_idx[b])]

    def chunks_at(self, b: int) -> int:
        return int(self.n_chunks[b]) if self.n_chunks is not None else 1

    def plan_at(self, b: int) -> PlacementPlan:
        """Materialize bandwidth bin ``b`` as a ``PlacementPlan``."""
        return PlacementPlan.from_window(int(self.s1[b]), int(self.s2[b]),
                                         self.n, self.codec_at(b),
                                         self.chunks_at(b))


@dataclasses.dataclass(frozen=True)
class _PlanTensors:
    """Shared intermediates of the vectorized placement searches: the
    sequential (non-streamed) totals plus everything the streamed chunk
    axis needs on top (split encode/decode overheads, compressed wire).
    Built once per (GraphArrays, bandwidth grid) by ``_plan_tensors`` and
    consumed by both ``search_multicut`` and ``search_streamed`` — the
    refactor that keeps the two searches priced by ONE set of
    expressions."""
    n_c: int                    # codec-axis length (1 when codec-free)
    edge_t: np.ndarray          # (S1, S2) edge head+tail seconds
    cloud_t: np.ndarray         # (S1, S2) cloud window seconds
    tri: np.ndarray             # (S1, S2) real-window mask (s1 < s2)
    infeasible: np.ndarray      # (S1, S2) budget / ordering mask
    up_w: np.ndarray            # (C, S) compressed uplink wire bytes
    up_enc: np.ndarray          # (C, S) uplink encode seconds (edge side)
    up_dec: np.ndarray          # (C, S) uplink decode seconds (cloud side)
    net_up: np.ndarray          # (C, S, B) sequential uplink leg seconds
    net_dn: np.ndarray          # (C, S, B) sequential downlink leg seconds
    totals: np.ndarray          # (C, S1, S2, B) sequential plan totals
    queue_t: Optional[np.ndarray] = None  # (S1, S2) M/G/1 wait, or None


def _plan_tensors(ga: GraphArrays, bw: np.ndarray,
                  cloud_budget_bytes: Optional[float],
                  cs: Optional[Sequence[Codec]], rtt_s: float,
                  down_bw_factor: float, single_cut_only: bool,
                  edge: DeviceSpec, cloud: DeviceSpec,
                  queue_hz: float = 0.0, queue_cv2: float = 1.0,
                  queue_service_scale: float = 1.0) -> _PlanTensors:
    """Build the (C, S1, S2, B) sequential-pricing tensors — the exact
    expressions ``search_multicut`` has always evaluated, factored out so
    ``search_streamed`` prices its K = 1 plane with bit-identical
    arithmetic (the ``n_chunks = 1 ≡ non-streamed`` acceptance gate)."""
    n = ga.n
    S = n + 1
    budget = cloud_budget_bytes if cloud_budget_bytes is not None \
        else float("inf")
    s1 = np.arange(S)[:, None]
    s2 = np.arange(S)[None, :]
    tri = s1 < s2                                   # real cloud window
    E, C_, L = ga.edge_s, ga.cloud_s, ga.cloud_load_bytes
    edge_t = E[:, None] + (E[n] - E[None, :])       # (S1, S2)
    cloud_t = np.where(tri, C_[:, None] - C_[None, :], 0.0)
    load = np.where(tri, L[:, None] - L[None, :], 0.0)
    infeasible = (s1 > s2) | (load > budget)
    if single_cut_only:
        infeasible = infeasible | (s2 != n)

    # per-(codec, cut) compressed wire + codec compute (C, S); raw when no
    # codec axis.  Uplink encodes on the edge, downlink on the cloud.
    # The sequential totals use the COMBINED overhead (rate-sum, the
    # historical formula); the split enc/dec sides feed the streamed
    # pipeline stages only.
    if cs is None:
        up_w, up_o = ga.wire_bytes[None, :], np.zeros((1, S))
        up_enc = up_dec = np.zeros((1, S))
        dn_w, dn_o = ga.down_wire_bytes[None, :], np.zeros((1, S))
        n_c = 1
    else:
        up_w, up_o = _codec_wire_overhead(ga.wire_bytes, n, cs, edge, cloud)
        _, up_enc, up_dec = _codec_wire_split(ga.wire_bytes, n, cs,
                                              edge, cloud)
        dn_w, dn_o = _codec_wire_overhead(ga.down_wire_bytes, n, cs,
                                          cloud, edge)
        n_c = len(cs)
    net_up = np.where(up_w[:, :, None] > 0,
                      up_w[:, :, None] / bw[None, None, :] + rtt_s, 0.0) \
        + up_o[:, :, None]                          # (C, S, B)
    net_dn = np.where(dn_w[:, :, None] > 0,
                      dn_w[:, :, None] / (bw[None, None, :]
                                          * down_bw_factor) + rtt_s, 0.0) \
        + dn_o[:, :, None]

    totals = edge_t[None, :, :, None] + cloud_t[None, :, :, None] \
        + np.where(tri[None, :, :, None],
                   net_up[:, :, None, :] + net_dn[:, None, :, :], 0.0)
    queue_t = None
    if queue_hz > 0:
        # M/G/1 wait on the window's cloud service time (0 outside the
        # triangular region since cloud_t is 0 there)
        queue_t = queue_delay_s(cloud_t, queue_hz, cv2=queue_cv2,
                                service_scale=queue_service_scale)
        totals = totals + queue_t[None, :, :, None]
    totals = np.where(infeasible[None, :, :, None], np.inf, totals)
    return _PlanTensors(n_c=n_c, edge_t=edge_t, cloud_t=cloud_t, tri=tri,
                        infeasible=infeasible, up_w=up_w, up_enc=up_enc,
                        up_dec=up_dec, net_up=net_up, net_dn=net_dn,
                        totals=totals, queue_t=queue_t)


def search_multicut_scalar(graph: Sequence[LayerCost], edge: DeviceSpec,
                           cloud: DeviceSpec, bandwidth_bps: float,
                           cloud_budget_bytes: Optional[float] = None, *,
                           codecs: Optional[Sequence] = None,
                           rtt_s: float = 0.0, input_bytes: float = 0.0,
                           down_bw_factor: float = 1.0,
                           arrays: Optional[GraphArrays] = None,
                           max_err: Optional[float] = None,
                           queue_hz: float = 0.0, queue_cv2: float = 1.0,
                           queue_service_scale: float = 1.0
                           ) -> PlacementEval:
    """Scalar (S1, S2, codec) oracle: exhaustive triangular scan in the
    exact tie-break order the vectorized pass reproduces — earliest codec
    in the list, then largest ``S1``, then largest ``S2`` (so single-cut
    ``S2 = n`` wins ties over a pointless second cut).  The property-test
    oracle for ``search_multicut``.  ``queue_hz > 0`` adds the window's
    M/G/1 wait to each candidate total (the wait rides ``total_s`` only,
    not the physical decomposition)."""
    ga = arrays if arrays is not None else graph_arrays(
        graph, edge, cloud, input_bytes=input_bytes)
    n = ga.n
    budget = cloud_budget_bytes if cloud_budget_bytes is not None \
        else float("inf")
    cs = resolve_codecs(codecs, max_err)
    axis: Sequence[Optional[Codec]] = cs if cs is not None else (None,)
    best = None
    for ci, c in enumerate(axis):
        for s1 in range(n, -1, -1):
            for s2 in range(n, s1 - 1, -1):
                if ga.window_load_bytes(s1, s2) > budget:
                    continue
                e, cl, up, dn = ga.placement_latency(
                    s1, s2, bandwidth_bps, rtt_s, codec=c,
                    down_bw_factor=down_bw_factor)
                total = e + cl + up + dn
                if queue_hz > 0:
                    total += queue_delay_s(cl, queue_hz, cv2=queue_cv2,
                                           service_scale=queue_service_scale)
                if best is None or total < best[0]:
                    best = (total, ci, s1, s2, e, cl, up, dn)
    assert best is not None, "no feasible placement (budget < 0?)"
    total, ci, s1, s2, e, cl, up, dn = best
    name = axis[ci].name if axis[ci] is not None else None
    plan = PlacementPlan.from_window(s1, s2, n, name)
    return PlacementEval(plan=plan, total_s=total, edge_s=e, cloud_s=cl,
                         up_s=up, down_s=dn,
                         cloud_load_bytes=ga.window_load_bytes(s1, s2),
                         codec=name)


def search_multicut(graph: Sequence[LayerCost], edge: DeviceSpec,
                    cloud: DeviceSpec, bandwidths_bps,
                    cloud_budget_bytes: Optional[float] = None, *,
                    codecs: Optional[Sequence] = None,
                    rtt_s: float = 0.0, input_bytes: float = 0.0,
                    down_bw_factor: float = 1.0,
                    arrays: Optional[GraphArrays] = None,
                    max_err: Optional[float] = None,
                    single_cut_only: bool = False, queue_hz: float = 0.0,
                    queue_cv2: float = 1.0,
                    queue_service_scale: float = 1.0) -> MulticutResult:
    """Vectorized multi-cut Alg. 1: the joint optimum over every
    edge→cloud→edge plan ``(S1 ≤ S2)``, every codec and every bandwidth in
    one (C, S1, S2, B) numpy pass.

    Equivalent to ``search_multicut_scalar`` per bandwidth (ties: earliest
    codec, largest S1, largest S2 — single-cut preferred on ties).  The
    cloud budget gates the **window** load ``weights[S1:S2)``; restricted
    to ``single_cut_only`` (mask ``S2 = n``) the pass reproduces
    ``search``/``search_vec`` exactly — the K=1 property the tests pin.
    Bandwidths in BYTES/s, latencies in seconds; the downlink leg rides
    ``down_bw_factor × bandwidth``.
    """
    ga = arrays if arrays is not None else graph_arrays(
        graph, edge, cloud, input_bytes=input_bytes)
    bw = np.atleast_1d(np.asarray(bandwidths_bps, dtype=np.float64))
    cs = resolve_codecs(codecs, max_err)
    pt = _plan_tensors(ga, bw, cloud_budget_bytes, cs, rtt_s,
                       down_bw_factor, single_cut_only, edge, cloud,
                       queue_hz, queue_cv2, queue_service_scale)
    n, S = ga.n, ga.n + 1

    # flatten (codec, flipped-S1, flipped-S2): first occurrence of the min
    # is the earliest codec at the largest (S1, S2) — the scalar tie-break
    flat = pt.totals[:, ::-1, ::-1, :].reshape(pt.n_c * S * S, len(bw))
    idx = np.argmin(flat, axis=0)
    ci = idx // (S * S)
    rem = idx % (S * S)
    s1v = n - rem // S
    s2v = n - rem % S
    cols = np.arange(len(bw))
    real = s1v < s2v
    return MulticutResult(
        bandwidths_bps=bw, s1=s1v, s2=s2v,
        total_s=pt.totals[ci, s1v, s2v, cols],
        edge_s=pt.edge_t[s1v, s2v], cloud_s=pt.cloud_t[s1v, s2v],
        up_s=np.where(real, pt.net_up[ci, s1v, cols], 0.0),
        down_s=np.where(real, pt.net_dn[ci, s2v, cols], 0.0),
        n=n,
        codec_idx=ci if cs is not None else None,
        codec_names=tuple(c.name for c in cs) if cs is not None else None)


# ------------------------------------------------------------- streamed
def _chunk_axis(chunk_grid) -> Tuple[int, ...]:
    """Normalize a chunk grid: ints, sorted ascending, deduplicated, and
    ALWAYS containing 1 — the sequential option must stay searchable (it
    is the only legal choice wherever streaming does not apply)."""
    ks = sorted({int(k) for k in chunk_grid} | {1})
    if ks[0] < 1:
        raise ValueError(f"chunk counts must be >= 1, got {chunk_grid}")
    return tuple(ks)


def search_streamed_scalar(graph: Sequence[LayerCost], edge: DeviceSpec,
                           cloud: DeviceSpec, bandwidth_bps: float,
                           cloud_budget_bytes: Optional[float] = None, *,
                           codecs: Optional[Sequence] = None,
                           chunk_grid=DEFAULT_CHUNK_GRID,
                           rtt_s: float = 0.0, input_bytes: float = 0.0,
                           down_bw_factor: float = 1.0,
                           arrays: Optional[GraphArrays] = None,
                           max_err: Optional[float] = None,
                           single_cut_only: bool = False,
                           queue_hz: float = 0.0, queue_cv2: float = 1.0,
                           queue_service_scale: float = 1.0
                           ) -> PlacementEval:
    """Scalar (S1, S2, codec, n_chunks) oracle: exhaustive scan in the
    exact tie-break order the vectorized pass reproduces — earliest codec,
    largest ``S1``, largest ``S2``, then SMALLEST chunk count (so the
    sequential transfer wins ties over pointless chunking).  ``K = 1``
    cells are priced by the identical sequential expressions as
    ``search_multicut_scalar``; ``K > 1`` cells by the chunk-pipeline
    makespan recurrence (``pipeline.stream_makespan_scalar``).  The
    property-test oracle for ``search_streamed``."""
    ga = arrays if arrays is not None else graph_arrays(
        graph, edge, cloud, input_bytes=input_bytes)
    n = ga.n
    budget = cloud_budget_bytes if cloud_budget_bytes is not None \
        else float("inf")
    cs = resolve_codecs(codecs, max_err)
    axis: Sequence[Optional[Codec]] = cs if cs is not None else (None,)
    ks = _chunk_axis(chunk_grid)
    best = None
    for ci, c in enumerate(axis):
        for s1 in range(n, -1, -1):
            for s2 in range(n, s1 - 1, -1):
                if single_cut_only and s2 != n:
                    continue
                if ga.window_load_bytes(s1, s2) > budget:
                    continue
                e, cl, up, dn = ga.placement_latency(
                    s1, s2, bandwidth_bps, rtt_s, codec=c,
                    down_bw_factor=down_bw_factor)
                wire = float(ga.wire_bytes[s1])
                # chunking overlaps transport, not the queue: every K
                # cell of a window pays the same M/G/1 wait
                wq = queue_delay_s(cl, queue_hz, cv2=queue_cv2,
                                   service_scale=queue_service_scale) \
                    if queue_hz > 0 else 0.0
                for k in ks:
                    if k == 1:
                        total, up_k, bub = e + cl + up + dn + wq, up, 0.0
                    elif s1 < s2 and stream_applies(s1, n, wire):
                        enc = c.encode_s(wire, edge) if c is not None else 0.0
                        dec = c.decode_s(wire, cloud) if c is not None \
                            else 0.0
                        wire_c = c.wire_bytes(wire) if c is not None else wire
                        m = stream_makespan_scalar(
                            enc, wire_c / bandwidth_bps, dec + cl, k, rtt_s)
                        total = (e + m) + dn + wq
                        up_k = m - cl
                        bub = float(stream_bubble_fraction(
                            enc, wire_c / bandwidth_bps, dec + cl, k, rtt_s))
                    else:
                        continue            # streaming not applicable
                    if best is None or total < best[0]:
                        best = (total, ci, s1, s2, k, e, cl, up_k, dn, bub)
    assert best is not None, "no feasible placement (budget < 0?)"
    total, ci, s1, s2, k, e, cl, up, dn, bub = best
    name = axis[ci].name if axis[ci] is not None else None
    plan = PlacementPlan.from_window(s1, s2, n, name, k)
    return PlacementEval(plan=plan, total_s=total, edge_s=e, cloud_s=cl,
                         up_s=up, down_s=dn,
                         cloud_load_bytes=ga.window_load_bytes(s1, s2),
                         codec=name, n_chunks=k, bubble_frac=bub)


def search_streamed(graph: Sequence[LayerCost], edge: DeviceSpec,
                    cloud: DeviceSpec, bandwidths_bps,
                    cloud_budget_bytes: Optional[float] = None, *,
                    codecs: Optional[Sequence] = None,
                    chunk_grid=DEFAULT_CHUNK_GRID,
                    rtt_s: float = 0.0, input_bytes: float = 0.0,
                    down_bw_factor: float = 1.0,
                    arrays: Optional[GraphArrays] = None,
                    max_err: Optional[float] = None,
                    single_cut_only: bool = False, queue_hz: float = 0.0,
                    queue_cv2: float = 1.0,
                    queue_service_scale: float = 1.0) -> MulticutResult:
    """Vectorized streamed Alg. 1: the joint optimum over every placement
    window, codec, streaming chunk count and bandwidth in one
    (C, S1, S2, K, B) numpy pass.

    The ``K = 1`` plane IS the sequential (C, S1, S2, B) tensor
    ``search_multicut`` evaluates — built by the shared
    ``_plan_tensors`` helper, so restricting ``chunk_grid=(1,)``
    reproduces the non-streamed sweep bit-for-bit.  ``K > 1`` planes
    price the uplink leg as the 3-stage chunk pipeline
    (``pipeline.stream_makespan`` closed form): the cloud window's
    prefill overlaps the transfer, each chunk pays its own rtt, and
    streaming is masked off wherever a codec would not apply
    (``pipeline.stream_applies``).  Equivalent to
    ``search_streamed_scalar`` per bandwidth (ties: earliest codec,
    largest S1, largest S2, smallest chunk count).  Bandwidths in
    BYTES/s, latencies in seconds."""
    ga = arrays if arrays is not None else graph_arrays(
        graph, edge, cloud, input_bytes=input_bytes)
    n = ga.n
    S = n + 1
    bw = np.atleast_1d(np.asarray(bandwidths_bps, dtype=np.float64))
    cs = resolve_codecs(codecs, max_err)
    ks = _chunk_axis(chunk_grid)
    pt = _plan_tensors(ga, bw, cloud_budget_bytes, cs, rtt_s,
                       down_bw_factor, single_cut_only, edge, cloud,
                       queue_hz, queue_cv2, queue_service_scale)

    # streaming gate: mid-graph uplink cuts with traffic, inside a real
    # cloud window (mirrors codec_applies + non-empty payload)
    app = np.zeros(S, dtype=bool)
    app[1:n] = ga.wire_bytes[1:n] > 0
    s1i = np.arange(S)[:, None]
    s2i = np.arange(S)[None, :]
    stream_ok = (s1i < s2i) & app[:, None] & ~pt.infeasible

    planes = []
    bub_planes = []
    for k in ks:
        if k == 1:
            planes.append(pt.totals)
            bub_planes.append(np.zeros_like(pt.totals))
            continue
        # per-chunk stages (C, S1, S2, B): a = encode, b = wire + rtt,
        # c = decode + chunked prefill of the cloud window
        enc = pt.up_enc[:, :, None, None]
        wire_t = pt.up_w[:, :, None, None] / bw[None, None, None, :]
        comp = pt.up_dec[:, :, None, None] + pt.cloud_t[None, :, :, None]
        m = stream_makespan(enc, wire_t, comp, k, rtt_s)
        plane = (pt.edge_t[None, :, :, None] + m) + pt.net_dn[:, None, :, :]
        if pt.queue_t is not None:
            plane = plane + pt.queue_t[None, :, :, None]
        planes.append(np.where(stream_ok[None, :, :, None], plane, np.inf))
        bub_planes.append(stream_bubble_fraction(enc, wire_t, comp, k,
                                                 rtt_s))
    totals = np.stack(planes, axis=3)               # (C, S1, S2, K, B)
    bubbles = np.stack(bub_planes, axis=3)

    # flatten (codec, flipped-S1, flipped-S2, K): first occurrence of the
    # min is the earliest codec at the largest (S1, S2) with the smallest
    # chunk count — the scalar oracle's tie-break
    nK = len(ks)
    n_c = pt.n_c
    flat = totals[:, ::-1, ::-1, :, :].reshape(n_c * S * S * nK, len(bw))
    idx = np.argmin(flat, axis=0)
    ci = idx // (S * S * nK)
    rem = idx % (S * S * nK)
    s1v = n - rem // (S * nK)
    rem2 = rem % (S * nK)
    s2v = n - rem2 // nK
    ki = rem2 % nK
    cols = np.arange(len(bw))
    kv = np.asarray(ks, dtype=int)[ki]
    real = s1v < s2v
    cloud_chosen = pt.cloud_t[s1v, s2v]
    total_chosen = totals[ci, s1v, s2v, ki, cols]
    down_chosen = np.where(real, pt.net_dn[ci, s2v, cols], 0.0)
    # uplink-exposed seconds: sequential leg for K = 1 bins, makespan −
    # cloud window for streamed bins (back out of the chosen total so the
    # edge/cloud/up/down decomposition stays additive — minus the queue
    # wait, which rides total_s only)
    up_seq = np.where(real, pt.net_up[ci, s1v, cols], 0.0)
    queue_chosen = pt.queue_t[s1v, s2v] if pt.queue_t is not None else 0.0
    up_chosen = np.where(kv == 1, up_seq,
                         total_chosen - pt.edge_t[s1v, s2v]
                         - cloud_chosen - down_chosen - queue_chosen)
    return MulticutResult(
        bandwidths_bps=bw, s1=s1v, s2=s2v,
        total_s=total_chosen,
        edge_s=pt.edge_t[s1v, s2v], cloud_s=cloud_chosen,
        up_s=up_chosen, down_s=down_chosen,
        n=n,
        codec_idx=ci if cs is not None else None,
        codec_names=tuple(c.name for c in cs) if cs is not None else None,
        n_chunks=kv,
        bubble_frac=bubbles[ci, s1v, s2v, ki, cols])


def sweep_multicut(graphs: Mapping[str, Sequence[LayerCost]],
                   edge: DeviceSpec, cloud: DeviceSpec, bandwidths_bps,
                   cloud_budget_bytes: Union[None, float,
                                             Mapping[str,
                                                     Optional[float]]] = None,
                   *, codecs: Optional[Sequence] = None,
                   rtt_s: float = 0.0,
                   input_bytes: Union[float, Mapping[str, float]] = 0.0,
                   down_bw_factor: float = 1.0,
                   max_err: Optional[float] = None,
                   single_cut_only: bool = False,
                   chunk_grid=None, queue_hz: float = 0.0,
                   queue_cv2: float = 1.0, queue_service_scale: float = 1.0
                   ) -> Dict[str, MulticutResult]:
    """Fleet-scale multi-cut plan: one padded (M, C, S1, S2, B) pass over
    every registered model — the multi-cut sibling of ``sweep_search``.
    Shallower models are masked (not padded with sentinel costs) so the
    triangular window algebra stays finite.  Per-model budgets /
    input_bytes accept the same scalar-or-mapping forms as
    ``sweep_search``.

    ``chunk_grid`` adds the streamed chunk axis: each model runs its own
    (C, S1, S2, K, B) ``search_streamed`` pass (per-model rather than one
    padded all-model tensor — the extra K axis makes the padded tensor
    memory-heavy for no planner-rate win; the per-model passes are still
    one numpy evaluation each) and every bin carries the joint
    (S1, S2, codec, n_chunks) optimum.  ``chunk_grid=(1,)`` reproduces
    the non-streamed sweep bit-for-bit."""
    names = list(graphs)
    if not names:
        raise ValueError("sweep_multicut needs at least one graph")
    bw = np.atleast_1d(np.asarray(bandwidths_bps, dtype=np.float64))
    cs = resolve_codecs(codecs, max_err)
    n_c = len(cs) if cs is not None else 1

    def per_model(val, name, default):
        if isinstance(val, Mapping):
            v = val.get(name, default)
        else:
            v = val if val is not None else default
        return default if v is None else v

    if chunk_grid is not None:
        return {
            k: search_streamed(
                g, edge, cloud, bw,
                per_model(cloud_budget_bytes, k, None),
                codecs=codecs, chunk_grid=chunk_grid, rtt_s=rtt_s,
                input_bytes=per_model(input_bytes, k, 0.0),
                down_bw_factor=down_bw_factor, max_err=max_err,
                single_cut_only=single_cut_only, queue_hz=queue_hz,
                queue_cv2=queue_cv2,
                queue_service_scale=queue_service_scale)
            for k, g in graphs.items()}

    gas = [graph_arrays(graphs[k], edge, cloud,
                        input_bytes=per_model(input_bytes, k, 0.0))
           for k in names]
    S = max(ga.n for ga in gas) + 1
    M = len(names)
    ns = np.array([ga.n for ga in gas])

    def pad(vals):
        out = np.zeros((M, S), dtype=np.float64)
        for i, v in enumerate(vals):
            out[i, :len(v)] = v
        return out

    E = pad([ga.edge_s for ga in gas])
    C = pad([ga.cloud_s for ga in gas])
    L = pad([ga.cloud_load_bytes for ga in gas])
    Wu = pad([ga.wire_bytes for ga in gas])
    Wd = pad([ga.down_wire_bytes for ga in gas])
    En = E[np.arange(M), ns]                        # total edge latency
    budgets = np.array([per_model(cloud_budget_bytes, k, float("inf"))
                        for k in names], dtype=np.float64)

    s1 = np.arange(S)[:, None]
    s2 = np.arange(S)[None, :]
    tri = (s1 < s2)[None, :, :]
    in_range = (s1[None, :, :] <= ns[:, None, None]) \
        & (s2[None, :, :] <= ns[:, None, None])
    edge_t = E[:, :, None] + (En[:, None, None] - E[:, None, :])  # (M,S1,S2)
    cloud_t = np.where(tri, C[:, :, None] - C[:, None, :], 0.0)
    load = np.where(tri, L[:, :, None] - L[:, None, :], 0.0)
    infeasible = ~in_range | (s1 > s2)[None, :, :] \
        | (load > budgets[:, None, None])
    if single_cut_only:
        infeasible = infeasible | (s2[None, :, :] != ns[:, None, None])

    # per-model codec wire/overhead (M, C, S) — mid-graph gate uses each
    # model's own depth, so the shared helper runs on the unpadded prefix
    up_w = np.zeros((M, n_c, S))
    up_o = np.zeros((M, n_c, S))
    dn_w = np.zeros((M, n_c, S))
    dn_o = np.zeros((M, n_c, S))
    for i, ga in enumerate(gas):
        k = ga.n + 1
        if cs is None:
            up_w[i, 0, :k] = ga.wire_bytes
            dn_w[i, 0, :k] = ga.down_wire_bytes
        else:
            up_w[i, :, :k], up_o[i, :, :k] = _codec_wire_overhead(
                ga.wire_bytes, ga.n, cs, edge, cloud)
            dn_w[i, :, :k], dn_o[i, :, :k] = _codec_wire_overhead(
                ga.down_wire_bytes, ga.n, cs, cloud, edge)
    net_up = np.where(up_w[..., None] > 0,
                      up_w[..., None] / bw[None, None, None, :] + rtt_s,
                      0.0) + up_o[..., None]        # (M, C, S, B)
    net_dn = np.where(dn_w[..., None] > 0,
                      dn_w[..., None] / (bw[None, None, None, :]
                                         * down_bw_factor) + rtt_s,
                      0.0) + dn_o[..., None]

    totals = edge_t[:, None, :, :, None] + cloud_t[:, None, :, :, None] \
        + np.where(tri[:, None, :, :, None],
                   net_up[:, :, :, None, :] + net_dn[:, :, None, :, :], 0.0)
    if queue_hz > 0:
        # (M, S1, S2) M/G/1 wait on the window's cloud service time
        qd = queue_delay_s(cloud_t, queue_hz, cv2=queue_cv2,
                           service_scale=queue_service_scale)
        totals = totals + qd[:, None, :, :, None]
    totals = np.where(infeasible[:, None, :, :, None], np.inf, totals)

    flat = totals[:, :, ::-1, ::-1, :].reshape(M, n_c * S * S, len(bw))
    idx = np.argmin(flat, axis=1)                   # (M, B)
    cols = np.arange(len(bw))
    out: Dict[str, MulticutResult] = {}
    codec_names = tuple(c.name for c in cs) if cs is not None else None
    for i, k in enumerate(names):
        n_i = gas[i].n
        ci = idx[i] // (S * S)
        rem = idx[i] % (S * S)
        # un-flip the padded axes; out-of-range cells are inf-masked, so
        # the first-occurrence argmin still lands on the largest VALID
        # (S1, S2) — the scalar tie-break — for every model depth
        s1v = (S - 1) - rem // S
        s2v = (S - 1) - rem % S
        real = s1v < s2v
        out[k] = MulticutResult(
            bandwidths_bps=bw, s1=s1v, s2=s2v,
            total_s=totals[i, ci, s1v, s2v, cols],
            edge_s=edge_t[i, s1v, s2v], cloud_s=cloud_t[i, s1v, s2v],
            up_s=np.where(real, net_up[i, ci, s1v, cols], 0.0),
            down_s=np.where(real, net_dn[i, ci, s2v, cols], 0.0),
            n=n_i,
            codec_idx=ci if cs is not None else None,
            codec_names=codec_names)
    return out


def fixed_split(graph: Sequence[LayerCost]) -> int:
    """Baseline: ~50/50 weight split (paper's "Fixed Seg")."""
    total = sum(c.weight_bytes for c in graph)
    acc = 0.0
    for i, c in enumerate(graph):
        acc += c.weight_bytes
        if acc >= total / 2:
            return i + 1
    return len(graph) // 2
