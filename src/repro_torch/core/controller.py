"""RoboECC end-to-end controller (paper Fig. 1c / Fig. 4).

The port's own copy of ``src/repro/core/controller.py``: the same code,
importing from ``repro_torch`` only, held equal to the reference by
``tests/test_torch_control.py``.  One difference: the LSTM predictor is a
PyTorch module here, so ``fit_predictor`` takes the ``device`` it trains
and predicts on (the card by default).

Pipeline:
  1. structure model (Eq. 1)  ->  flattened layer graph
  2. hardware model (Eq. 2)   ->  per-layer edge/cloud latencies
  3. Alg. 1                   ->  optimal split under the cloud budget
  4. parameter-sharing pool   ->  movable region around the split
  5. LSTM predictor + ΔNB thresholds -> per-tick fine-grained adjustment

``tick()`` advances one control step against a NetworkSim and returns the
latency decomposition for that inference — this drives the paper-table
benchmarks and the serving examples.  ``adjust_overhead_s`` is the *measured
wall time* of the adjustment decision on this host (paper §V-C-1 reports
10.7 ms on their hosts).  While ``torch.profiler`` records, a tick is the
range ``roboecc.tick`` around ``roboecc.predict`` (the LSTM's forecast)
and ``roboecc.adjust`` (the move); otherwise each costs one check.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Union

import numpy as np

from ..configs.base import ModelConfig
from .adjustment import (AdjustmentDecision, PlacementDecision, Thresholds,
                         adjust, adjust_placement)
from .codec import (Codec, CodecLike, DeltaCodec, get_codec,
                    make_delta_codec, resolve_codecs)
from .hardware import DeviceSpec, layer_latency
from .network import NetworkSim
from .placement import PlacementPlan
from .pool import Pool, build_pool
from .predictor import Predictor, PredictorConfig, train_predictor
from .pipeline import DEFAULT_CHUNK_GRID
from .segmentation import (SegmentationResult, evaluate_placement,
                           evaluate_split, search, search_multicut,
                           search_streamed)
from .graph import build_graph
from .structure import LayerCost, Workload
from .telemetry import stage


@dataclasses.dataclass
class TickResult:
    split: int
    edge_s: float
    cloud_s: float
    net_s: float
    total_s: float
    decision: Optional[Union[AdjustmentDecision, PlacementDecision]]
    adjust_overhead_s: float
    bw_real_bps: float
    bw_pred_bps: float
    codec: Optional[str] = None  # codec the transfer was priced with
    # the full multi-cut placement this tick ran with (multicut mode);
    # ``split`` stays the primary edge→cloud cut for legacy consumers
    placement: Optional[PlacementPlan] = None
    # streaming chunk count of the uplink cut this tick ran with
    # (1 = sequential transfer; streamed mode only)
    n_chunks: int = 1


class RoboECC:
    """End-to-end controller.  ``codec`` (name or ``Codec``) prices the cut
    transfer through ``core/codec.py`` — inside Alg. 1, so compression
    participates in the planned split, not just the transfer time.
    ``adjust_codecs`` additionally lets the per-tick ΔNB move pick a codec
    jointly with the split (the first list entry is the preferred /
    lowest-error format).  ``use_codec=True`` is the backwards-compatible
    alias for ``codec="int8"``.

    ``multicut=True`` plans over K-segment placements
    (``core/placement.py``): Alg. 1 becomes the (S1, S2, codec) multi-cut
    scan, the per-tick ΔNB move may shift **either** cut (a second
    parameter-sharing pool ``pool2`` wraps the downlink cut), and every
    latency is priced through ``evaluate_placement`` — the downlink leg
    rides ``down_bw_factor × bandwidth``.  ``split`` remains the primary
    edge→cloud cut for legacy consumers; single-cut behaviour is the exact
    K=1 special case (a multicut controller whose planner collapses the
    tail keeps ``placement.is_single``).  Multicut codec state must come
    from the ``core/codec.py`` registry (plans carry codec *names*).

    ``streamed=True`` plans over the streaming chunk axis too
    (``core/pipeline.py``): Alg. 1 becomes ``search_streamed`` (restricted
    to single cuts unless ``multicut``), every tick is priced through the
    chunk-pipeline makespan (``evaluate_placement(streamed=True)``), and
    the per-tick ΔNB move may change ``n_chunks`` jointly with the cuts
    and codec — so the LSTM bandwidth forecast drives chunk replanning: a
    chunk count picked for 10 MB/s is wrong at 0.2 MB/s, the paper's
    performance-drift story replayed on a new axis.  ``plan_rtt_s`` is
    the per-chunk rtt the streamed planner and adjuster price (chunking
    is free at rtt 0, so it must be the deployment's real rtt);
    ``chunk_grid`` the chunk counts searched.

    ``queue_hz > 0`` makes planning queue-aware: Alg. 1 (and the
    multi-cut / streamed scans, and the ΔNB down move) add the M/G/1
    expected wait ``segmentation.queue_delay_s`` for each candidate's
    cloud service time, so the controller retreats toward the edge when
    the shared cloud replica is congested.  The fleet simulator
    estimates the per-replica rate from its own closed loop
    (``FleetConfig(queue_aware=True)``)."""

    def __init__(self, cfg: ModelConfig, edge: DeviceSpec, cloud: DeviceSpec,
                 *, workload: Workload = Workload(),
                 cloud_budget_bytes: Optional[float] = None,
                 pool_overhead_target: float = 0.026,
                 nominal_bw_bps: float = 10e6,
                 thresholds: Optional[Thresholds] = None,
                 use_codec: bool = False,
                 codec: CodecLike = None,
                 adjust_codecs: Optional[List] = None,
                 graph: Optional[List[LayerCost]] = None,
                 multicut: bool = False,
                 down_bw_factor: float = 1.0,
                 streamed: bool = False,
                 chunk_grid=DEFAULT_CHUNK_GRID,
                 plan_rtt_s: float = 0.005,
                 queue_hz: float = 0.0,
                 queue_cv2: float = 1.0,
                 queue_service_scale: float = 1.0):
        self.cfg = cfg
        self.edge_dev, self.cloud_dev = edge, cloud
        self.workload = workload
        if codec is None and use_codec:
            codec = "int8"
        self.codec: Optional[Codec] = get_codec(codec)
        self.adjust_codecs = resolve_codecs(adjust_codecs)
        # `graph` lets a fleet of same-arch robots share one prebuilt graph
        self.graph: List[LayerCost] = list(graph) if graph is not None \
            else build_graph(cfg, workload)
        self.cloud_budget_bytes = cloud_budget_bytes
        self.pool_overhead_target = pool_overhead_target
        self.multicut = multicut
        self.down_bw_factor = down_bw_factor
        self.streamed = streamed
        self.chunk_grid = tuple(chunk_grid)
        self.plan_rtt_s = plan_rtt_s
        # expected per-replica arrival rate (+ M/G/1 shape parameters)
        # the planner and adjuster price cloud congestion with —
        # queue_hz = 0 keeps every decision queue-blind (bit-for-bit)
        self.queue_hz = queue_hz
        self.queue_cv2 = queue_cv2
        self.queue_service_scale = queue_service_scale
        self.seg: SegmentationResult = search(
            self.graph, edge, cloud, nominal_bw_bps,
            cloud_budget_bytes=cloud_budget_bytes,
            input_bytes=workload.input_bytes, codec=self.codec,
            queue_hz=queue_hz, queue_cv2=queue_cv2,
            queue_service_scale=queue_service_scale)
        self.placement: PlacementPlan = self._plan_placement(nominal_bw_bps,
                                                             cloud_budget_bytes)
        self._rebuild_pools()
        self.thresholds = thresholds or Thresholds(high=2e6, low=-2e6)
        self.predictor: Optional[Predictor] = None

    # ------------------------------------------------------------- planning
    def _plan_placement(self, nominal_bw_bps: float,
                        cloud_budget_bytes: Optional[float]
                        ) -> PlacementPlan:
        """Alg. 1 (single-cut), the multi-cut (S1, S2) scan, or — with
        ``streamed`` — the (S1, S2, n_chunks) streamed scan, as a
        ``PlacementPlan``.  All paths share the codec the controller was
        built with."""
        if self.streamed:
            st = search_streamed(
                self.graph, self.edge_dev, self.cloud_dev, [nominal_bw_bps],
                cloud_budget_bytes,
                codecs=[self.codec] if self.codec is not None else None,
                chunk_grid=self.chunk_grid, rtt_s=self.plan_rtt_s,
                input_bytes=self.workload.input_bytes,
                down_bw_factor=self.down_bw_factor,
                single_cut_only=not self.multicut,
                queue_hz=self.queue_hz, queue_cv2=self.queue_cv2,
                queue_service_scale=self.queue_service_scale)
            return st.plan_at(0)
        if not self.multicut:
            return PlacementPlan.single(
                self.seg.split, self.codec.name if self.codec else None)
        mc = search_multicut(
            self.graph, self.edge_dev, self.cloud_dev, [nominal_bw_bps],
            cloud_budget_bytes,
            codecs=[self.codec] if self.codec is not None else None,
            rtt_s=0.0, input_bytes=self.workload.input_bytes,
            down_bw_factor=self.down_bw_factor,
            queue_hz=self.queue_hz, queue_cv2=self.queue_cv2,
            queue_service_scale=self.queue_service_scale)
        return mc.plan_at(0)

    def _rebuild_pools(self) -> None:
        """One parameter-sharing pool per real cut: ``pool`` wraps the
        primary edge→cloud cut, ``pool2`` the cloud→edge tail cut (absent
        for single-cut placements)."""
        n = len(self.graph)
        self.split = self.placement.primary_cut(n)
        self.pool: Pool = build_pool(self.graph, self.split,
                                     self.pool_overhead_target)
        s2 = self.placement.tail_cut(n)
        self.pool2: Optional[Pool] = build_pool(
            self.graph, s2, self.pool_overhead_target) if s2 < n else None

    @property
    def use_codec(self) -> bool:
        return self.codec is not None and self.codec.name != "identity"

    # ------------------------------------------------------------- predictor
    def fit_predictor(self, historical_bps: np.ndarray,
                      pcfg: PredictorConfig = PredictorConfig(),
                      seed: int = 0, device="cuda") -> None:
        self.predictor, _ = train_predictor(historical_bps, pcfg, seed,
                                            device)

    # ------------------------------------------------------------- latencies
    def latency_at(self, split: int, bw_bps: float, rtt_s: float = 0.0):
        """(edge_s, cloud_s, net_s) in seconds at ``split`` for a link of
        ``bw_bps`` BYTES/s — the modeled latency decomposition of one
        inference without advancing any state.  Transport is priced through
        ``self.codec`` (exact wire format bytes + encode/decode compute on
        the two tiers), replacing the former hard-coded bf16→int8 halving
        that ignored scale layout and codec compute entirely."""
        return evaluate_split(self.graph, split, self.edge_dev,
                              self.cloud_dev, bw_bps, rtt_s=rtt_s,
                              input_bytes=self.workload.input_bytes,
                              codec=self.codec)

    def placement_latency_at(self, bw_bps: float, rtt_s: float = 0.0):
        """(edge_s, cloud_s, net_s) of the current (possibly multi-cut /
        streamed) placement — the generalization of ``latency_at``.
        ``net_s`` is uplink + downlink; each leg carries its own rtt.  In
        streamed mode the uplink component is the chunk-pipeline's
        transport-exposed time (makespan − overlapped cloud compute), so
        the three components still sum to the tick latency."""
        ev = evaluate_placement(self.graph, self.placement, self.edge_dev,
                                self.cloud_dev, bw_bps, rtt_s=rtt_s,
                                input_bytes=self.workload.input_bytes,
                                down_bw_factor=self.down_bw_factor,
                                streamed=self.streamed)
        return ev.edge_s, ev.cloud_s, ev.net_s

    # ------------------------------------------------------------------ tick
    def tick(self, net: NetworkSim, adjust_enabled: bool = True) -> TickResult:
        with stage("tick"):
            return self._tick(net, adjust_enabled)

    def _tick(self, net: NetworkSim, adjust_enabled: bool) -> TickResult:
        bw_real = net.now_bps
        decision = None
        bw_pred = bw_real
        t0 = time.perf_counter()
        if adjust_enabled and self.predictor is not None:
            with stage("predict"):
                window = net.window(self.predictor.cfg.window)
                bw_pred = self.predictor.predict(window)
            with stage("adjust"):
                if self.multicut or self.streamed:
                    # the streamed single-cut controller also routes
                    # through the placement adjuster: its move set carries
                    # the chunk axis (pool2=None pins S2 = n, so cuts stay
                    # single)
                    decision = adjust_placement(
                        self.graph, self.pool, self.placement, bw_pred,
                        bw_real, self.thresholds, pool2=self.pool2,
                        codecs=self.adjust_codecs,
                        edge=self.edge_dev, cloud=self.cloud_dev,
                        down_bw_factor=self.down_bw_factor,
                        chunk_grid=self.chunk_grid if self.streamed else None,
                        rtt_s=self.plan_rtt_s if self.streamed else 0.0,
                        queue_hz=self.queue_hz, queue_cv2=self.queue_cv2,
                        queue_service_scale=self.queue_service_scale)
                    self.placement = decision.placement
                    self.split = self.placement.primary_cut(len(self.graph))
                else:
                    decision = adjust(self.graph, self.pool, self.split,
                                      bw_pred, bw_real, self.thresholds,
                                      codecs=self.adjust_codecs,
                                      current_codec=self.codec.name
                                      if self.codec else None,
                                      edge=self.edge_dev,
                                      cloud=self.cloud_dev)
                    self.split = decision.split
                if decision.codec is not None and (
                        self.codec is None
                        or decision.codec != self.codec.name):
                    # resolve within the adjuster's own axis, NOT the global
                    # registry — adjust_codecs may hold custom Codec instances
                    # (e.g. f32-raw variants) that a name lookup in CODECS
                    # would miss or silently swap for the bf16 defaults
                    self.codec = next(c for c in self.adjust_codecs
                                      if c.name == decision.codec)
                if not (self.multicut or self.streamed):
                    self.placement = PlacementPlan.single(
                        self.split, self.codec.name if self.codec else None)
        overhead = time.perf_counter() - t0
        # the *next* tick's bandwidth is what the transfer actually sees
        net.step()
        bw_serve = net.now_bps
        if self.multicut or self.streamed:
            e, c, t = self.placement_latency_at(bw_serve, net.rtt_s)
        else:
            e, c, t = self.latency_at(self.split, bw_serve, net.rtt_s)
        return TickResult(split=self.split, edge_s=e, cloud_s=c, net_s=t,
                          total_s=e + c + t + (overhead if adjust_enabled else 0.0),
                          decision=decision, adjust_overhead_s=overhead,
                          bw_real_bps=bw_real, bw_pred_bps=bw_pred,
                          codec=self.codec.name if self.codec else None,
                          placement=self.placement,
                          n_chunks=self.placement.primary_chunks(
                              len(self.graph)))

    # --------------------------------------------------------- scene drift
    def observe_change_frac(self, measured_frac: float, *,
                            tol: float = 0.25,
                            nominal_bw_bps: float = 10e6,
                            cloud_budget_bytes: Optional[float] = None
                            ) -> bool:
        """Re-plan when the *measured* token change fraction drifts from
        the one the delta codec was priced with.

        A ``DeltaCodec``'s wire bytes are a bet on scene content: plans
        priced for a static tabletop (``change_frac`` ≈ 0.02) are badly
        wrong once the robot starts driving.  When the relative drift
        ``|measured - planned| / planned`` exceeds ``tol``, rebuild the
        delta codec around the measured fraction (same base, cadence,
        threshold) and re-run the full planner with it.  Returns whether
        a re-plan happened; a no-op (non-delta codec, or drift within
        tolerance) costs one comparison.

        ``nominal_bw_bps`` / ``cloud_budget_bytes`` follow ``replan``'s
        convention: they describe the deployment conditions to re-plan
        under and do not default to construction values."""
        if not isinstance(self.codec, DeltaCodec):
            return False
        planned = self.codec.change_frac
        measured = min(max(float(measured_frac), 0.0), 1.0)
        if planned > 0.0 and abs(measured - planned) / planned <= tol:
            return False
        old_name = self.codec.name
        self.codec = make_delta_codec(
            base=self.codec.base, change_frac=measured,
            resync_every=self.codec.resync_every,
            threshold=self.codec.threshold,
            row_elems=self.codec.row_elems,
            raw_bytes_per_elem=self.codec.raw_bytes_per_elem,
            name=old_name)
        if self.adjust_codecs is not None:
            self.adjust_codecs = [
                self.codec if c.name == old_name else c
                for c in self.adjust_codecs]
        self.replan(cloud_budget_bytes=cloud_budget_bytes,
                    nominal_bw_bps=nominal_bw_bps)
        return True

    # ------------------------------------------------------------ elasticity
    def replan(self, *, edge: Optional[DeviceSpec] = None,
               cloud: Optional[DeviceSpec] = None,
               cloud_budget_bytes: Optional[float] = None,
               nominal_bw_bps: float = 10e6) -> SegmentationResult:
        """Elastic re-planning after a tier change (device loss/join):
        re-run Alg. 1 with the surviving device set.  Losing the edge tier
        degenerates to cloud-only (split=0) — the paper's baseline.

        Note: ``cloud_budget_bytes`` and ``nominal_bw_bps`` describe the NEW
        deployment conditions and intentionally do NOT default to the values
        passed at construction — a tier change usually changes the budget
        too (e.g. cloud-only fallback must host the whole model).  Re-pass
        the original budget explicitly to keep it (as the fleet simulator
        does on replica re-join)."""
        if edge is not None:
            self.edge_dev = edge
        if cloud is not None:
            self.cloud_dev = cloud
        self.seg = search(self.graph, self.edge_dev, self.cloud_dev,
                          nominal_bw_bps, cloud_budget_bytes=cloud_budget_bytes,
                          input_bytes=self.workload.input_bytes,
                          codec=self.codec, queue_hz=self.queue_hz,
                          queue_cv2=self.queue_cv2,
                          queue_service_scale=self.queue_service_scale)
        self.placement = self._plan_placement(nominal_bw_bps,
                                              cloud_budget_bytes)
        self._rebuild_pools()
        return self.seg
