"""Network-aware fine-grained segmentation adjustment — paper §IV-B-3.

The port's own copy of ``src/repro/core/adjustment.py``: the same code,
importing from ``repro_torch`` only, held equal to the reference by
``tests/test_torch_control.py``.

``ΔNB = NB_pred(t+1) − NB_real(t)``.  If ``ΔNB > T_high`` (bandwidth will
rise) move the split to the pool layer with the **maximum** transfer volume
(exploit the link); if ``ΔNB < T_low`` (bandwidth will drop) move to the
**minimum**-transfer layer (hide the bad link); otherwise keep the current
split.  Compute-load deltas inside the pool are ignored (paper: "impacts on
both sides are negligible").

Codec-aware extension (``core/codec.py``): given a ``codecs`` axis the move
is **joint over (split × codec)**.  On "down" the pair minimising predicted
transport seconds at ``NB_pred`` wins — compressing harder is an
alternative (or complement) to retreating to the minimum-volume layer.  On
"up" the split goes to the maximum-volume layer and the codec snaps to the
lowest-error one — both are the same *greedy exploit* as the paper's up
move, which jumps to the transfer-heaviest cut on a predicted rise without
checking absolute transport cost.  The guard against flip-flapping under
an oscillating link is the hold band ``[T_low, T_high]`` (sized by
``calibrate_thresholds``), not the move itself.  Pass ``edge``/``cloud``
DeviceSpecs to include encode/decode compute in the transport price
(without them the move is wire-only).

Streamed extension (``core/pipeline.py``): ``adjust_placement`` with a
``chunk_grid`` adds streaming chunk-count moves to the same ΔNB policy —
the uplink leg of every candidate is priced as the chunk-pipeline
makespan minus the overlapped cloud-window compute, so a predicted
bandwidth drop can answer with *more chunks* (hide the slow link behind
prefill) as an alternative to retreating the cut or compressing harder,
and a predicted rise can shed per-chunk rtt overhead.  Like a codec
switch, a chunk-count change ships no weights.

Threshold calibration follows the paper §V-C-2: ``T_high`` starts at the
maximum historical ``ΔNB``; ``T_low`` is then grid-searched on a validation
trace; ``T_high`` is re-searched afterwards (Fig. 7).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from .codec import get_codec, resolve_codecs
from .hardware import DeviceSpec, layer_latency
from .pipeline import stream_applies, stream_makespan_scalar
from .placement import PlacementPlan
from .pool import Pool
from .segmentation import (codec_applies, cut_bytes, downlink_bytes,
                           net_time, queue_delay_s)
from .structure import LayerCost


@dataclasses.dataclass
class Thresholds:
    high: float                  # bytes/s
    low: float


@dataclasses.dataclass
class AdjustmentDecision:
    split: int
    moved: bool
    reason: str                  # "up" | "down" | "hold"
    delta_nb: float
    codec: Optional[str] = None  # set when the move was joint (codecs given)


def adjust(graph: Sequence[LayerCost], pool: Pool, current_split: int,
           nb_pred_bps: float, nb_real_bps: float, thr: Thresholds,
           *, codecs: Optional[Sequence] = None,
           current_codec: Optional[str] = None,
           edge: Optional[DeviceSpec] = None,
           cloud: Optional[DeviceSpec] = None,
           max_err: Optional[float] = None) -> AdjustmentDecision:
    delta = nb_pred_bps - nb_real_bps
    splits = list(pool.splits())
    volumes = [cut_bytes(graph, s) for s in splits]
    cs = resolve_codecs(codecs, max_err)
    if delta > thr.high:
        s = splits[int(np.argmax(volumes))]
        codec = None
        if cs is not None:
            # greedy exploit, mirroring the paper's max-volume jump: the
            # improving link ships the most faithful codec (anti-flap is
            # the [T_low, T_high] hold band, see module docstring)
            codec = min(cs, key=lambda c: c.err_bound).name
        moved = s != current_split or (codec is not None
                                       and codec != current_codec)
        return AdjustmentDecision(s, moved, "up", delta, codec=codec)
    if delta < thr.low:
        if cs is None:
            s = splits[int(np.argmin(volumes))]
            return AdjustmentDecision(s, s != current_split, "down", delta)
        # joint move: minimise predicted transport seconds at NB_pred;
        # ties break toward the earliest codec in the list, then the
        # largest split — the planner's tie-break direction.  net_time
        # applies the shared codec_applies gate, so the S=0 / S=n pool
        # extremes are priced raw exactly as evaluate_split prices them
        best = None
        n = len(graph)
        for ci, c in enumerate(cs):
            for s, vol in sorted(zip(splits, volumes), reverse=True):
                t = net_time(vol, nb_pred_bps, codec=c,
                             applicable=codec_applies(s, n),
                             edge=edge, cloud=cloud)
                if best is None or t < best[0]:
                    best = (t, ci, s)
        _, ci, s = best
        codec = cs[ci].name
        moved = s != current_split or codec != current_codec
        return AdjustmentDecision(s, moved, "down", delta, codec=codec)
    return AdjustmentDecision(current_split, False, "hold", delta,
                              codec=current_codec if cs is not None else None)


@dataclasses.dataclass
class PlacementDecision:
    """``adjust_placement`` outcome: the (possibly multi-cut) placement to
    run the next inference with."""
    placement: PlacementPlan
    moved: bool
    reason: str                  # "up" | "down" | "hold"
    delta_nb: float
    codec: Optional[str] = None


def adjust_placement(graph: Sequence[LayerCost], pool: Pool,
                     current: PlacementPlan, nb_pred_bps: float,
                     nb_real_bps: float, thr: Thresholds, *,
                     pool2: Optional[Pool] = None,
                     codecs: Optional[Sequence] = None,
                     edge: Optional[DeviceSpec] = None,
                     cloud: Optional[DeviceSpec] = None,
                     down_bw_factor: float = 1.0,
                     max_err: Optional[float] = None,
                     chunk_grid: Optional[Sequence[int]] = None,
                     rtt_s: float = 0.0, queue_hz: float = 0.0,
                     queue_cv2: float = 1.0,
                     queue_service_scale: float = 1.0) -> PlacementDecision:
    """Multi-cut ΔNB adjustment: the same up/down/hold policy as
    ``adjust``, generalized to move **either cut** of an edge→cloud→edge
    placement (uplink cut inside ``pool``, downlink cut inside ``pool2``).

    * ``up`` (link will rise): greedy exploit — both cuts jump to their
      maximum-transfer pool layer and the codec snaps to the lowest-error
      one, mirroring the paper's max-volume move.
    * ``down`` (link will drop): joint argmin of predicted transport
      seconds (uplink at ``NB_pred`` + downlink at
      ``down_bw_factor × NB_pred``) over (S1 × S2 × codec).  Ties break
      toward the earliest codec, then the largest S1, then the largest S2
      — so when ``pool2`` reaches the graph end, choosing ``S2 = n`` (no
      downlink leg at all) **collapses the plan back to K=1** for free.
    * otherwise hold.

    ``chunk_grid`` adds streaming chunk-count moves (``core/pipeline.py``)
    to the move set: every candidate's uplink leg is priced as the
    3-stage chunk-pipeline makespan at ``NB_pred`` *minus the overlapped
    cloud-window compute* (the transport-exposed seconds — for
    ``n_chunks = 1`` exactly the sequential transport the codec-free move
    prices), and both the "up" and "down" moves pick the chunk count
    jointly.  A chunk count is a pure software reconfiguration — like a
    codec switch it ships no weights — so it rides the same hold band.
    Chunk pricing needs ``cloud`` (the window compute that overlaps);
    without a device the chunk axis degenerates to wire-only pipelines
    where ``n_chunks = 1`` always wins (per-chunk rtt with nothing to
    overlap).

    ``queue_hz > 0`` makes the "down" move queue-aware: every candidate
    pays the M/G/1 expected wait of its cloud window
    (``segmentation.queue_delay_s`` — same parameters the planner uses),
    so a congested cloud biases the retreat toward shallower windows.
    The "up" move stays the paper's greedy max-volume exploit (it never
    priced absolute cost, so it gains no queue term).  ``queue_hz = 0``
    (default) reproduces the queue-blind move set bit-for-bit.

    With ``pool2=None``, ``chunk_grid=None`` and a single-cut ``current``
    this reduces exactly to ``adjust`` (the K=1 special case); the
    ``AdjustmentDecision`` split is ``placement.primary_cut(n)``."""
    n = len(graph)
    cur = current.normalize(n)
    cur_s1 = cur.primary_cut(n)
    cur_s2 = cur.tail_cut(n)
    cs = resolve_codecs(codecs, max_err)
    cur_codec = next((c for c in cur.cut_codecs if c is not None), None)
    delta = nb_pred_bps - nb_real_bps
    s2_opts = list(pool2.splits()) if pool2 is not None else [cur_s2]
    ks = sorted({int(k) for k in chunk_grid} | {1}) \
        if chunk_grid is not None else [1]
    # suffix cloud-latency cumsum: O(1) window compute for chunk pricing
    # and for the queue-aware down move's M/G/1 wait
    csum = None
    if cloud is not None and (len(ks) > 1 or queue_hz > 0):
        lat = np.array([layer_latency(c, cloud) for c in graph])
        csum = np.concatenate([np.cumsum(lat[::-1])[::-1], [0.0]])

    def window_cloud_s(s1: int, s2: int) -> float:
        if csum is None or s1 >= s2:
            return 0.0
        return float(csum[s1] - csum[s2])

    def up_leg(s1: int, s2: int, c, k: int, bw: float) -> Optional[float]:
        """Transport-exposed uplink seconds at bandwidth ``bw`` for chunk
        count ``k`` (None = streaming not applicable at this cut)."""
        vol = cut_bytes(graph, s1)
        seq = net_time(vol, bw, rtt_s=rtt_s, codec=c,
                       applicable=codec_applies(s1, n),
                       edge=edge, cloud=cloud) if s1 < s2 else 0.0
        if k == 1:
            return seq
        if not (s1 < s2 and stream_applies(s1, n, vol)):
            return None
        app = codec_applies(s1, n)
        enc = c.encode_s(vol, edge) if c is not None and app \
            and edge is not None else 0.0
        dec = c.decode_s(vol, cloud) if c is not None and app \
            and cloud is not None else 0.0
        wire_c = c.wire_bytes(vol) if c is not None and app else vol
        g = window_cloud_s(s1, s2)
        m = stream_makespan_scalar(enc, wire_c / bw, dec + g, k, rtt_s)
        return m - g

    def mk(s1: int, s2: int, codec: Optional[str],
           k: int = 1) -> PlacementPlan:
        return PlacementPlan.from_window(s1, s2, n, codec, k)

    def window_ok(s1: int, s2: int) -> bool:
        # an adjuster move must keep a REAL cloud window (or be the
        # explicit edge-only retreat s1 == s2 == n, reachable only when
        # both pools extend to the graph end — mirroring single-cut
        # ``adjust``, whose edge-only retreat needs n inside the pool).
        # Without this, overlapping pools would let the zero-transport
        # empty mid-graph window (s1 == s2 < n) win every "down" move and
        # silently collapse the whole model onto the edge.
        return s1 < s2 or s1 == s2 == n

    if delta > thr.high:
        s1 = max(pool.splits(), key=lambda s: cut_bytes(graph, s))
        wide = [s for s in s2_opts if s > s1] or [n]
        s2 = max(wide, key=lambda s: downlink_bytes(graph, s))
        cbest = min(cs, key=lambda c: c.err_bound) if cs is not None \
            else None
        codec = cbest.name if cbest is not None else cur_codec
        k = 1
        if len(ks) > 1:
            # chunking is not part of the paper's greedy max-volume jump;
            # re-pick it for the exploited cuts at NB_pred (smallest
            # count on ties — less machinery when the link is good).
            # Resolve through the adjuster's own axis first: it may hold
            # custom Codec instances a registry lookup would miss.
            try:
                cobj = cbest if cbest is not None else get_codec(codec)
            except KeyError:
                cobj = None
            legs = [(up_leg(s1, s2, cobj, kk, nb_pred_bps), kk)
                    for kk in ks]
            k = min((t, kk) for t, kk in legs if t is not None)[1]
        plan = mk(s1, s2, codec, k)
        moved = plan != cur
        return PlacementDecision(plan, moved, "up", delta, codec=codec)
    if delta < thr.low:
        axis = cs if cs is not None else (None,)
        best = None
        # tie-break order mirrors ``adjust`` exactly: its codec-free down
        # move is argmin over volumes (FIRST minimum -> smallest split),
        # its joint move scans splits descending (largest tied split) —
        # uniform trunks tie constantly, so the order is observable.  The
        # chunk loop is innermost-ascending: sequential wins ties.
        for ci, c in enumerate(axis):
            for s1 in sorted(pool.splits(), reverse=cs is not None):
                for s2 in sorted(s2_opts, reverse=True):
                    if not window_ok(s1, s2):
                        continue
                    # the downlink pays the same per-message rtt the
                    # uplink candidates price (rtt_s = 0 keeps the
                    # historical rtt-free objective exactly)
                    dn = net_time(downlink_bytes(graph, s2),
                                  nb_pred_bps * down_bw_factor, codec=c,
                                  rtt_s=rtt_s,
                                  applicable=codec_applies(s2, n),
                                  edge=cloud, cloud=edge) \
                        if s1 < s2 < n else 0.0
                    # queue-aware retreat: transport-equivalent seconds
                    # also pay the window's expected M/G/1 wait (0 when
                    # queue_hz == 0 — the historical objective exactly)
                    wq = queue_delay_s(window_cloud_s(s1, s2), queue_hz,
                                       cv2=queue_cv2,
                                       service_scale=queue_service_scale) \
                        if queue_hz > 0 else 0.0
                    for k in ks:
                        up = up_leg(s1, s2, c, k, nb_pred_bps)
                        if up is None:
                            continue
                        t = up + dn + wq
                        if best is None or t < best[0]:
                            best = (t, ci, s1, s2, k)
        if best is None:
            return PlacementDecision(cur, False, "down", delta,
                                     codec=cur_codec)
        _, ci, s1, s2, k = best
        codec = axis[ci].name if axis[ci] is not None else cur_codec
        plan = mk(s1, s2, codec, k)
        moved = plan != cur
        return PlacementDecision(plan, moved, "down", delta, codec=codec)
    return PlacementDecision(cur, False, "hold", delta,
                             codec=cur_codec if cs is not None else None)


def calibrate_thresholds(
        deltas: np.ndarray,
        eval_fn: Callable[[Thresholds], float],
        n_grid: int = 9) -> Thresholds:
    """Paper §V-C-2 procedure. ``eval_fn`` returns avg latency for a
    candidate threshold pair on a validation trace (lower is better)."""
    t_high = float(np.max(deltas))
    lows = np.quantile(deltas[deltas < 0], np.linspace(0.05, 0.95, n_grid)) \
        if np.any(deltas < 0) else np.array([-1.0])
    best_low, best = None, None
    for tl in lows:
        lat = eval_fn(Thresholds(t_high, float(tl)))
        if best is None or lat < best:
            best, best_low = lat, float(tl)
    highs = np.quantile(deltas[deltas > 0], np.linspace(0.05, 0.95, n_grid)) \
        if np.any(deltas > 0) else np.array([t_high])
    best_high = t_high
    for th in highs:
        lat = eval_fn(Thresholds(float(th), best_low))
        if lat < best:
            best, best_high = lat, float(th)
    return Thresholds(best_high, best_low)
