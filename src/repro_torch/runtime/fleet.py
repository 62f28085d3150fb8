"""Fleet-scale edge-cloud collaborative serving simulator.

The port's own copy of ``src/repro/runtime/fleet.py``: the same code
(numpy only), importing from ``repro_torch`` only, held equal to the
reference by ``tests/test_torch_fleet.py`` and
``tests/test_torch_fleet_engines.py``.

Composes the pieces that exist elsewhere in the repo but never meet:

* per-robot ``RoboECC`` controllers (``core/controller.py``) planned by the
  **vectorized** Alg. 1 sweep (``core/segmentation.search_vec`` /
  ``sweep_search``) — one array pass plans every
  (model × bandwidth × codec) cell;
* per-robot **codec state** (``core/codec.py``): the plan table carries the
  jointly-optimal split-boundary codec per bandwidth bin, robots switch
  codecs as their link moves between bins (counted in
  ``n_codec_switches``), and wire-byte pricing, hedged cloud work and
  post-outage ``replan()`` all see the compressed traffic;
* per-robot **placements** (``core/placement.py``, ``multicut=True``): the
  plan table becomes the joint (S1, S2, codec) multi-cut optimum per bin
  (``sweep_multicut``), each cut clamps into its own parameter-sharing
  pool, placement changes across requests are counted in ``n_cut_moves``,
  and 2-cut requests pay their downlink leg + edge-tail compute after the
  cloud batch returns (the downlink rides ``down_bw_factor`` × the uplink
  bandwidth);
* per-robot **streamed chunk transport** (``core/pipeline.py``,
  ``streamed=True``): the plan table gains the chunk-count axis
  (``sweep_multicut(chunk_grid=...)``), each robot carries in-flight
  chunk state (``n_chunk_reconfigs`` counts reconfigurations), chunked
  uplinks draw the **per-tick** trace bandwidth chunk-by-chunk
  (``NetworkSim.wire_trace_s``) while the cloud window's prefill runs
  concurrently, and ``FleetReport`` reports the residual pipeline
  ``mean_bubble_frac``;
* per-robot ``NetworkSim`` bandwidth traces (``core/network.py``), each
  robot on its own seeded link;
* ``MicroBatcher`` / ``StragglerMitigator`` / ``ElasticPool`` primitives
  (``runtime/scheduler.py``) — cloud-side work is batched per replica,
  hedged across replicas on tail events, and replica loss/join is detected
  via heartbeats;
* a **continuous-batching** cloud tier (``runtime/scheduler.
  ContinuousBatcher``, ``continuous=True``): replicas admit arriving
  prefills straight into the in-flight batch, track per-slot KV
  occupancy (``runtime/kvcache.graph_kv_cumsum`` prices each placement
  window's cache analytically) and preempt/requeue the youngest slot
  when occupancy would cross ``kv_budget_bytes``; ``FleetReport`` gains
  ``n_preemptions`` / ``mean_queue_delay_s`` / ``kv_high_watermark_bytes``
  and ``continuous=False`` keeps the fixed-batch path bit-for-bit;
* **queue-aware planning** (``queue_aware=True``): the plan tables and
  per-robot controllers fold an M/G/1 expected-wait term
  (``core/segmentation.queue_delay_s`` — per-replica arrival rate ×
  roofline service time) into Alg. 1's objective, so congested fleets
  retreat toward the edge *before* the queues build; the arrival rate is
  auto-estimated from the queue-blind plan at the nominal bandwidth
  (override with ``queue_hz``), and a zero rate reproduces the
  queue-blind tables bit-for-bit;
* shared cloud replicas with **finite capacity**: each replica serializes
  its batches (a ``busy_until`` clock), so queueing delay emerges when the
  fleet outruns cloud capacity;
* elasticity: a full cloud outage triggers every controller's ``replan()``
  (degrading to edge-only, split = n); the first replica re-join replans
  again and restores collaborative splits.

Everything is deterministic under ``FleetConfig.seed`` — the simulator
keeps its own ``numpy`` RNG and never reads wall-clock time.  Units follow
the repo conventions: bandwidth in BYTES/s, latency in seconds.

Simulation loop (one control tick = ``tick_s`` seconds):

1. live replicas heartbeat into the ``ElasticPool``; scheduled loss/join
   events silence/revive replicas, and pool transitions fire ``replan()``;
2. every idle robot takes one control step (closed loop: a robot has at
   most one outstanding request and issues the next observation once the
   previous action returns): look up the planned split for its current
   bandwidth in the precomputed plan table, clamp it into the
   parameter-sharing pool (moves outside the pool would ship weights), and
   price the edge/net components with O(1) ``GraphArrays`` indexing;
3. robots with cloud-side work enqueue it on the least-loaded replica's
   ``MicroBatcher``; formed batches execute with partial overlap (the
   batching win), a lognormal straggler multiplier, and p95 hedging;
4. completions are folded into per-robot latency series, reported as
   per-robot p50/p95 plus fleet-aggregate latency and throughput.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..configs import get_config
from ..core.codec import (Codec, DeltaCodec, make_codecs, make_delta_codec,
                          resolve_codecs)
from ..core.controller import RoboECC
from ..core.hardware import A100, ORIN, DeviceSpec
from ..core.network import NetworkSim, TraceConfig, generate_trace_matrix
from ..core.scene import SceneConfig, generate_scene_matrix, scene_config
from ..core.pipeline import (DEFAULT_CHUNK_GRID, stream_applies,
                             stream_makespan_scalar)
from ..core.segmentation import (GraphArrays, graph_arrays, queue_delay_s,
                                 sweep_multicut, sweep_search)
from ..core.structure import LayerCost, Workload, build_graph
from ..core.telemetry import _HASH_KNUTH, ContObserver, FlightRecorder
from .scheduler import (ContinuousBatcher, ElasticPool, MicroBatcher,
                        Request, StragglerMitigator)


# ------------------------------------------------------------------ config
@dataclasses.dataclass(frozen=True)
class ReplicaEvent:
    """Scheduled availability change: replica leaves or joins at ``tick``.

    Carries a TOTAL order ``(tick, kind, replica)`` so that schedules
    containing a leave and a join on the same tick sort deterministically
    regardless of the input list's construction order (``sorted`` is
    stable, so a key on ``tick`` alone preserves whatever order the
    caller happened to build — two logically identical schedules could
    replay differently).  At equal ticks ``"join" < "leave"``, i.e. the
    leave is applied last and wins the tick."""
    tick: int
    replica: str
    kind: str                    # "leave" | "join"

    def _key(self):
        return (self.tick, self.kind, self.replica)

    def __lt__(self, other: "ReplicaEvent") -> bool:
        if not isinstance(other, ReplicaEvent):
            return NotImplemented
        return self._key() < other._key()


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Open-loop request traffic alongside the closed-loop robots
    (``engine="events"`` only): stateless one-shot requests of ``arch``
    arriving as a Poisson stream (``kind="poisson"``) or a sinusoidally
    modulated Poisson stream (``kind="diurnal"``, thinned against the
    peak rate ``rate_hz * (1 + diurnal_amp)``).  Each process rides its
    own seeded bandwidth trace (or a fixed ``bw_bps``) and its own RNG
    stream, so adding processes never perturbs the closed-loop robots'
    draw order.  Arrivals look up the shared plan table at their
    process link bandwidth, pay the same edge/uplink/cloud/downlink legs
    as robots, and are batched on the same replicas — but hold no
    controller state (no pool clamps, no sticky codec) and never
    re-issue: they model external users, not robots."""
    name: str
    arch: str = "openvla-7b"
    kind: str = "poisson"          # "poisson" | "diurnal"
    rate_hz: float = 5.0           # mean arrival rate over the run
    diurnal_amp: float = 0.5       # relative amplitude, kind="diurnal"
    diurnal_period_s: float = 30.0
    bw_bps: Optional[float] = None  # fixed link; None -> own seeded trace
    # per-process bandwidth regime: a cohort of users behind a different
    # network (e.g. metro fiber vs rural LTE) rides its own TraceConfig;
    # None inherits the fleet-wide one.  Ignored when bw_bps is fixed.
    trace: Optional[TraceConfig] = None


@dataclasses.dataclass
class FleetConfig:
    """Fleet run description.  ``archs`` are cycled across ``n_robots``
    (robot i runs ``archs[i % len(archs)]``), so ≥3 entries gives a
    heterogeneous fleet.  Bandwidths in bytes/s, times in seconds."""
    n_robots: int = 16
    archs: Sequence[str] = ("openvla-7b", "cogact-7b", "llama3.2-3b")
    n_ticks: int = 200
    tick_s: float = 0.05
    rtt_s: float = 0.005
    n_replicas: int = 2
    batch_size: int = 8
    batch_wait_s: float = 0.02
    nominal_bw_bps: float = 10e6
    bw_grid_points: int = 32          # plan-table resolution (log-spaced)
    bw_grid_lo_bps: float = 0.05e6
    bw_grid_hi_bps: float = 40e6
    # per-robot cloud-side weight budget (bytes).  Finite by default — a
    # shared cloud serving many robots cannot host every full model, which
    # is what makes the splits collaborative (paper Tab. II uses 12.1 GB)
    cloud_budget_bytes: Optional[float] = 12.1e9
    # split-boundary transport codec axis (core/codec.py names).  The plan
    # table searches (model × split × bandwidth × codec) jointly and each
    # robot carries its planned codec as per-request state; the default
    # single-identity axis reproduces codec-free behaviour exactly.
    codecs: Sequence[str] = ("identity",)
    max_codec_err: Optional[float] = None   # drop codecs above this bound
    # multi-cut placements (core/placement.py): plan (S1, S2) edge→cloud→
    # edge windows instead of single splits.  The downlink leg rides
    # ``down_bw_factor`` × the uplink bandwidth (robot WANs are asymmetric
    # — the uplink is the constrained direction); 1.0 keeps it symmetric.
    multicut: bool = False
    down_bw_factor: float = 1.0
    # streamed chunk transport (core/pipeline.py): the plan table gains a
    # chunk-count axis, robots carry per-request chunk state
    # (``n_chunk_reconfigs``), and streamed uplinks draw the PER-TICK
    # trace bandwidth chunk-by-chunk (``NetworkSim.wire_trace_s``) while
    # the cloud window's prefill overlaps the transfer — the fleet-level
    # realization of the 3-stage pipeline makespan.  ``chunk_grid`` is
    # the chunk counts the planner searches; bins where chunking does not
    # pay plan K = 1, which prices exactly like ``streamed=False``.
    streamed: bool = False
    chunk_grid: Sequence[int] = DEFAULT_CHUNK_GRID
    # continuous-batching cloud tier (runtime/scheduler.ContinuousBatcher):
    # replicas admit arriving prefills into the in-flight batch as slots
    # free up (``batch_size`` caps the slot count), each slot's KV
    # occupancy ramps to the placement window's analytic footprint
    # (runtime/kvcache.py), and the youngest slot is preempted/requeued
    # with a full recompute when aggregate occupancy would cross
    # ``kv_budget_bytes``.  False keeps the fixed-batch MicroBatcher path
    # bit-for-bit as the degenerate/control case.
    continuous: bool = False
    kv_budget_bytes: float = 1.0e9     # per-replica KV memory budget
    kv_admit_frac: float = 0.25        # KV fraction pinned at admission
    # queue-aware planning: fold the M/G/1 expected-wait term
    # (core/segmentation.queue_delay_s, Pollaczek–Khinchine) into the
    # plan-table sweeps and every controller's Alg. 1 / ΔNB decisions.
    # ``queue_hz=None`` auto-estimates the per-replica arrival rate from
    # the queue-blind plan at the nominal bandwidth (robots with planned
    # cloud work re-issue at their closed-loop rate, spread over the
    # replicas); queue_aware=False — or an estimated rate of 0 —
    # reproduces the queue-blind tables bit-for-bit.
    queue_aware: bool = False
    queue_hz: Optional[float] = None
    queue_cv2: float = 1.0             # service-time coefficient-of-var²
    queue_service_scale: float = 1.0   # planned→served service inflation
    pool_overhead_target: float = 0.026
    batch_overlap: float = 0.8        # fraction of non-max work overlapped
    straggler_sigma: float = 0.2      # lognormal sigma on replica exec time
    tail_prob: float = 0.01           # chance of a tail event per execution
    tail_scale: float = 5.0           # tail slowdown multiplier
    heartbeat_timeout_s: float = 0.12
    trace: TraceConfig = dataclasses.field(default_factory=TraceConfig)
    workload: Workload = dataclasses.field(default_factory=Workload)
    edge: DeviceSpec = ORIN
    cloud: DeviceSpec = A100
    replica_events: Sequence[ReplicaEvent] = ()
    seed: int = 0
    # simulation engine: "ticks" replays the historical per-tick loop;
    # "events" runs the sparse event-driven core (runtime/events.py) —
    # proven FleetReport-dataclass-equal to the tick loop on every
    # parity-matrix config (tests/test_engine_parity.py) and the only
    # engine that scales to 10k+ robots (busy robots cost nothing).
    engine: str = "ticks"
    # vectorized ROBOT phase (events engine only): same-tick control
    # steps run as ONE numpy pass over the struct-of-arrays robot state
    # (``FleetSimulator._robot_step_batch``) instead of n per-robot
    # Python calls.  The batch replays the scalar arithmetic in the
    # scalar evaluation order, so reports are dataclass-equal either way
    # (tests/test_engine_parity.py pins it); ``vectorized=False`` keeps
    # the per-robot ``_robot_step`` as the parity oracle.
    vectorized: bool = True
    # open-loop arrival traffic (events engine only; the tick loop
    # refuses it — it has no sub-tick arrival machinery)
    arrival_processes: Sequence[ArrivalProcess] = ()
    # SLO-based admission control for open-loop arrivals: reject (serve
    # edge-only, counted in n_slo_rejections) when the estimated cloud
    # wait exceeds slo_s.  None disables.  Closed-loop robots are never
    # rejected — their backpressure is the closed loop itself.
    slo_s: Optional[float] = None
    # ElasticPool-driven replica autoscaling (events engine only): every
    # autoscale_every ticks an AutoScaler (runtime/scheduler.py) compares
    # mean backlog per routable replica against the high/low watermarks
    # and joins/leaves one replica inside [autoscale_min, autoscale_max].
    # Replicas beyond the initial live set are provisioned as cold spares
    # via tick-0 leave events in replica_events.
    autoscale: bool = False
    autoscale_every: int = 20
    autoscale_min: int = 1
    autoscale_max: Optional[int] = None    # None -> n_replicas
    autoscale_high_s: float = 0.25
    autoscale_low_s: float = 0.02
    # flight-recorder telemetry (core/telemetry.py): "off" keeps the
    # recorder out of every hot path (a single ``is None`` check per
    # request — runs are bit-identical to a build without telemetry,
    # pinned by tests/test_engine_parity.py); "sampled" records a
    # deterministic ~1/telemetry_sample_every subset of requests chosen
    # by hashing (robot, issue tick) — never the simulation RNG — and
    # "full" records every request.  Span groups are reservoir-bounded
    # at telemetry_cap (runtime/trace_export.py renders them as Chrome
    # trace-event JSON); metrics/drift sketches are O(1) memory always.
    # Sampled cost is ~full/sample_every (the keep/drop hash itself is
    # negligible): 1/64 keeps the 10k-robot fleet inside the <3 %
    # overhead budget benchmarks/fleet_bench.py bench_overhead gates.
    telemetry: str = "off"
    telemetry_cap: int = 65536
    telemetry_sample_every: int = 64
    # scene-dynamics axis for the temporal-delta codec (core/scene.py):
    # a scene name ("static"/"slow"/"dynamic") or a SceneConfig gives
    # every robot a seeded per-tick token change-fraction trace (its own
    # stream, disjoint from the bandwidth traces).  With a "delta" codec
    # in ``codecs``, each uplink is then priced at its MEASURED frame
    # cost — key frames at the base codec's bytes, delta frames at
    # ``frac x base + mask`` — instead of the plan table's cycle
    # average, per-robot wire bytes are accounted
    # (``FleetReport.total_wire_bytes``), and the resync cadence /
    # reference-cache state is tracked per robot.  Delta state applies
    # to closed-loop uplinks only: open-loop arrivals are stateless
    # one-shots with no reference to delta against, and the downlink
    # leg keeps cycle-average pricing (the reference cache is
    # cloud-side).  ``None`` (default) skips every delta branch — runs
    # are bit-identical to builds without the axis.
    scene: Optional[object] = None          # str | core.scene.SceneConfig
    # cloud-side reference-cache byte budget shared across the fleet's
    # delta references (accounted by runtime/kvcache.ReferenceLedger,
    # the same memory pool the KV budget draws from).  Overflow evicts
    # the stalest robots' references (FIFO-by-refresh), forcing their
    # next frame back to a key frame (``n_ref_evictions``).  None =
    # unbounded (and keeps the batched robot phase fully vectorized —
    # a budget makes eviction order-sensitive, so budgeted runs walk
    # delta state per-robot in ascending index).
    delta_ref_budget_bytes: Optional[float] = None
    # measured-vs-planned change-fraction drift replans: every
    # ``delta_drift_every`` ticks the fleet-mean measured change
    # fraction over the window is compared against the delta codec's
    # planned ``change_frac``; relative drift beyond
    # ``delta_drift_tol`` rebuilds the delta codec around the measured
    # fraction and re-runs the plan tables (``n_delta_replans``).  The
    # schedule is precomputed from the scene matrix at construction —
    # a pure function of the tick, never of robot processing order —
    # which is what keeps the tick/event/vectorized engines
    # bit-identical.  0 disables.
    delta_drift_tol: float = 0.25
    delta_drift_every: int = 0


def outage_schedule(cfg: FleetConfig) -> List[ReplicaEvent]:
    """Default chaos schedule: one replica leaves and re-joins mid-run
    (capacity crunch), then ALL replicas drop for a window (full outage →
    every controller replans to edge-only) and come back."""
    T = cfg.n_ticks
    ev = []
    if cfg.n_replicas > 1:
        ev += [ReplicaEvent(T // 5, "cloud1", "leave"),
               ReplicaEvent(2 * T // 5, "cloud1", "join")]
    for i in range(cfg.n_replicas):
        ev.append(ReplicaEvent(3 * T // 5, f"cloud{i}", "leave"))
        ev.append(ReplicaEvent(7 * T // 10, f"cloud{i}", "join"))
    return sorted(ev)          # ReplicaEvent total order: (tick, kind, name)


# ------------------------------------------------------------------ report
@dataclasses.dataclass(frozen=True)
class RobotStats:
    name: str
    arch: str
    n_requests: int
    mean_s: float
    p50_s: float
    p95_s: float
    codec: str = "identity"      # codec the robot ended the run on
    n_chunks: int = 1            # chunk count the robot ended the run on


@dataclasses.dataclass(frozen=True)
class ProcessStats:
    """Per-arrival-process latency breakdown (open-loop traffic only)."""
    name: str
    kind: str
    n_arrivals: int
    n_completed: int
    n_rejected: int              # SLO admission rejections (served edge-only)
    mean_s: float
    p50_s: float
    p95_s: float
    p99_s: float
    p999_s: float


@dataclasses.dataclass(frozen=True)
class FleetReport:
    robots: List[RobotStats]
    n_requests: int
    fleet_p50_s: float
    fleet_p95_s: float
    throughput_rps: float        # completed requests / simulated second
    n_hedged: int
    n_replans: int
    n_outage_completions: int    # requests served edge-only during outages
    n_codec_switches: int = 0    # per-robot codec changes across requests
    n_cut_moves: int = 0         # per-robot (S1, S2) changes across requests
    n_multicut_requests: int = 0  # requests served on a real 2-cut placement
    n_chunk_reconfigs: int = 0   # per-robot chunk-count changes
    n_streamed_requests: int = 0  # requests served on a chunked (K>1) uplink
    # mean fill/drain bubble fraction over streamed requests (0 when none):
    # how much pipeline dead time the chosen chunking left unrecovered
    mean_bubble_frac: float = 0.0
    # continuous-batching tier (continuous=True; all zero under the
    # MicroBatcher control path)
    n_preemptions: int = 0            # KV-budget evictions (recomputed)
    mean_queue_delay_s: float = 0.0   # cloud admission wait per completion
    kv_high_watermark_bytes: float = 0.0   # peak per-replica KV occupancy
    # tail percentiles over the fleet latency series — the scale story:
    # p99/p99.9 only mean anything with thousands of robots' worth of
    # samples, which is what the event engine exists to provide
    fleet_p99_s: float = 0.0
    fleet_p999_s: float = 0.0
    # open-loop arrival traffic (events engine; empty/zero otherwise)
    processes: tuple = ()             # tuple[ProcessStats, ...]
    n_open_arrivals: int = 0          # arrivals generated across processes
    n_slo_rejections: int = 0         # arrivals rejected by SLO admission
    n_autoscale_events: int = 0       # replicas joined/left by the scaler
    # flight-recorder snapshot (core/telemetry.py) when the run had
    # telemetry on: counters/gauges/quantile sketches + drift summary.
    # None when telemetry="off", so historical reports compare equal.
    metrics: Optional[dict] = None
    # temporal-delta transport (FleetConfig.scene; all zero when the
    # scene axis is off, so historical reports compare equal).
    # ``total_wire_bytes`` sums every applicable closed-loop uplink's
    # MEASURED wire bytes (any codec, not just delta — the comparison
    # baseline needs the same accounting); the frame counters and
    # eviction/replan counts are delta-codec specific.
    total_wire_bytes: float = 0.0
    n_keyframes: int = 0
    n_delta_frames: int = 0
    n_ref_evictions: int = 0
    n_delta_replans: int = 0

    def summary(self) -> str:
        lines = [
            f"{len(self.robots)} robots, {self.n_requests} requests: "
            f"fleet p50 {self.fleet_p50_s * 1e3:.1f} ms, "
            f"p95 {self.fleet_p95_s * 1e3:.1f} ms, "
            f"p99 {self.fleet_p99_s * 1e3:.1f} ms, "
            f"p99.9 {self.fleet_p999_s * 1e3:.1f} ms, "
            f"{self.throughput_rps:.1f} req/s",
            f"  {self.n_hedged} hedges, {self.n_replans} replans, "
            f"{self.n_codec_switches} codec switches, "
            f"{self.n_cut_moves} cut moves, "
            f"{self.n_chunk_reconfigs} chunk reconfigs",
            f"  queue: mean delay {self.mean_queue_delay_s * 1e3:.1f} ms, "
            f"{self.n_preemptions} preemptions, "
            f"KV high-water {self.kv_high_watermark_bytes / 1e6:.1f} MB",
        ]
        if self.n_open_arrivals or self.processes:
            lines.append(
                f"  open loop: {self.n_open_arrivals} arrivals, "
                f"{self.n_slo_rejections} SLO rejections, "
                f"{self.n_autoscale_events} autoscale events")
        if self.total_wire_bytes or self.n_keyframes or self.n_delta_frames:
            lines.append(
                f"  delta: {self.total_wire_bytes / 1e6:.1f} MB wire, "
                f"{self.n_keyframes} key / {self.n_delta_frames} delta "
                f"frames, {self.n_ref_evictions} evictions, "
                f"{self.n_delta_replans} drift replans")
        return "\n".join(lines)


@dataclasses.dataclass
class _CloudWork:
    robot: int
    issued_s: float              # control step that produced this request
    ready_s: float               # edge compute + uplink done at this time
    edge_s: float
    net_s: float                 # uplink leg (edge → cloud)
    cloud_s: float
    down_s: float = 0.0          # downlink leg + edge tail (multi-cut only)
    two_cut: bool = False        # issued on a real (S2 < n) placement
    proc: int = -1               # arrival-process index; -1 = robot traffic
    # issue-time telemetry payload (recorder-on sampled requests only):
    # the planner's predicted stage decomposition plus span context,
    # joined against the measured stages at completion.  None when the
    # recorder is off or the request was not sampled.
    pred: Optional[dict] = None


# --------------------------------------------------------------- simulator
class FleetSimulator:
    """Event-driven fleet run; see module docstring for the loop."""

    def __init__(self, cfg: FleetConfig):
        if cfg.n_robots < 1 or cfg.n_replicas < 1 or not cfg.archs:
            raise ValueError("fleet needs >=1 robot, >=1 replica and >=1 arch")
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self._dead_cloud = cfg.cloud.with_eta(1e-12, 1e-12)
        _t_init = time.perf_counter()

        # one graph + cost-array set per arch, shared by all its robots
        self.arch_of: List[str] = [cfg.archs[i % len(cfg.archs)]
                                   for i in range(cfg.n_robots)]
        archs = list(dict.fromkeys(self.arch_of))
        self.graphs: Dict[str, List[LayerCost]] = {
            a: build_graph(get_config(a), cfg.workload) for a in archs}
        self.arrays: Dict[str, GraphArrays] = {
            a: graph_arrays(g, cfg.edge, cfg.cloud,
                            input_bytes=cfg.workload.input_bytes)
            for a, g in self.graphs.items()}

        # vectorized Alg. 1 plan table: (model × bandwidth-bin) ->
        # (split, codec) — one (M, C, S, B) pass covers the whole fleet
        self.codecs: List[Codec] = list(
            resolve_codecs(cfg.codecs, cfg.max_codec_err))
        self.bw_grid = np.geomspace(cfg.bw_grid_lo_bps, cfg.bw_grid_hi_bps,
                                    cfg.bw_grid_points)
        # geometric midpoints: searchsorted on these snaps a bandwidth to
        # the NEAREST grid bin in log space (plain searchsorted on the grid
        # would always round up to the plan of a faster link)
        self._bw_mid = np.sqrt(self.bw_grid[:-1] * self.bw_grid[1:])
        # plain-float copy for the per-request lookup: bisect_left on a
        # list is ~10x a scalar np.searchsorted and bit-identical to
        # side="left" (same total order on finite floats)
        self._bw_mid_list = [float(x) for x in self._bw_mid]
        (self.plan, self.plan_s2, self.plan_codec,
         self.plan_chunks) = self._build_plans(0.0)
        # queue-aware planning: estimate the per-replica arrival rate the
        # queue-blind plan induces at the nominal bandwidth, then rebuild
        # the tables with the M/G/1 wait term in the objective.  λ = 0
        # skips the rebuild, so the degenerate case keeps the queue-blind
        # tables bit-for-bit.
        self.plan_queue_hz = 0.0
        if cfg.queue_aware:
            lam = (float(cfg.queue_hz) if cfg.queue_hz is not None
                   else self._estimate_arrival_hz())
            if lam > 0.0:
                self.plan_queue_hz = lam
                (self.plan, self.plan_s2, self.plan_codec,
                 self.plan_chunks) = self._build_plans(lam)

        # robots start on the codec planned at the nominal bandwidth; the
        # same codec prices the controller's Alg. 1 (so replan() after an
        # outage restores a codec-consistent split)
        k0 = int(np.searchsorted(self._bw_mid, cfg.nominal_bw_bps))
        # robot state is struct-of-arrays: at 10k+ robots, per-robot
        # Python objects dominate memory and attribute access dominates
        # time; int64/float64 arrays keep the hot path flat
        self.codec_of = np.asarray(
            [int(self.plan_codec[a][k0]) for a in self.arch_of],
            dtype=np.int64)
        _t_plan = time.perf_counter()
        # ONE controller per distinct arch, shared by every robot of that
        # arch: construction and replan() are deterministic functions of
        # (arch, devices, budget, codec, queue prior) — identical for all
        # robots of an arch — so n_robots controller objects were
        # n_robots recomputations of the same Alg. 1 sweep (the dominant
        # setup cost at 10k+).  ``self.controllers`` stays a length-n
        # list (robot i -> its arch's shared controller); controller
        # state only changes inside ``_on_replicas`` replan waves, which
        # replan each DISTINCT controller once.
        uniq: Dict[str, RoboECC] = {
            a: RoboECC(get_config(a), cfg.edge, cfg.cloud,
                       workload=cfg.workload,
                       cloud_budget_bytes=cfg.cloud_budget_bytes,
                       pool_overhead_target=cfg.pool_overhead_target,
                       nominal_bw_bps=cfg.nominal_bw_bps,
                       codec=self.codecs[int(self.plan_codec[a][k0])],
                       graph=self.graphs[a],
                       multicut=cfg.multicut,
                       down_bw_factor=cfg.down_bw_factor,
                       streamed=cfg.streamed,
                       chunk_grid=cfg.chunk_grid,
                       plan_rtt_s=cfg.rtt_s,
                       queue_hz=self.plan_queue_hz,
                       queue_cv2=cfg.queue_cv2,
                       queue_service_scale=cfg.queue_service_scale)
            for a in archs}
        self.controllers: List[RoboECC] = [uniq[a] for a in self.arch_of]
        # replan memo: a chaos schedule replays the same two cloud
        # conditions ("dead"/"alive") every wave, and replan() under a
        # fixed condition is deterministic — so snapshot the post-replan
        # controller state per (controller, condition) and restore it on
        # repeat waves.  The "alive" snapshot is the construction state
        # (replan with the original cloud + budget reproduces it
        # bit-for-bit), so a full outage/rejoin cycle costs at most one
        # dead-condition search per arch for the whole run.
        self._replan_memo: Dict[tuple, dict] = {
            (id(c), "alive"): self._ctl_snapshot(c) for c in uniq.values()}
        self.replan_wall_s = 0.0
        _t_ctl = time.perf_counter()
        # per-robot effective placement state (for n_cut_moves)
        self.place_s1 = np.asarray([int(self.plan[a][k0])
                                    for a in self.arch_of], dtype=np.int64)
        self.place_s2 = np.asarray([int(self.plan_s2[a][k0])
                                    for a in self.arch_of], dtype=np.int64)
        # per-robot streaming chunk state (for n_chunk_reconfigs)
        self.chunks_of = np.asarray([int(self.plan_chunks[a][k0])
                                     for a in self.arch_of], dtype=np.int64)
        # per-robot pool bounds, cached as Pool objects: pools only move
        # on replan(), so _on_replicas refreshes the cache and the
        # per-request path clamps against plain ints (Pool.clamp) instead
        # of chasing controller attributes + np.clip
        self._pools1: List = [None] * cfg.n_robots
        self._pools2: List = [None] * cfg.n_robots
        # struct-of-arrays mirror of the pool bounds, refreshed alongside
        # the Pool cache: the vectorized ROBOT phase clamps with numpy
        # min/max (bit-identical to Pool.clamp) instead of method calls
        self._pool_lo1 = np.zeros(cfg.n_robots, dtype=np.int64)
        self._pool_hi1 = np.zeros(cfg.n_robots, dtype=np.int64)
        self._pool_lo2 = np.zeros(cfg.n_robots, dtype=np.int64)
        self._pool_hi2 = np.zeros(cfg.n_robots, dtype=np.int64)
        self._has_pool2 = np.zeros(cfg.n_robots, dtype=bool)
        self._refresh_pool_cache()
        # one bulk (n_robots, n_ticks+1) bandwidth matrix — row i is
        # bit-identical to the historical per-robot
        # ``generate_trace(..., seed=seed*100_003 + i)`` — and the
        # NetworkSim objects wrap the rows as views (no copies): the
        # vectorized ROBOT phase reads ``trace_mat[idx, tick]`` directly,
        # the scalar/streamed paths keep their per-robot cursor API
        self.trace_mat = generate_trace_matrix(
            cfg.n_ticks + 1, cfg.trace,
            [cfg.seed * 100_003 + i for i in range(cfg.n_robots)])
        self.nets: List[NetworkSim] = [
            NetworkSim(row, tick_s=cfg.tick_s, rtt_s=cfg.rtt_s)
            for row in self.trace_mat]
        _t_trace = time.perf_counter()
        # setup wall breakdown (``benchmarks/fleet_bench.py --profile``):
        # plan tables (+ graphs), controller construction, trace matrix
        self.profile = {"plan_s": _t_plan - _t_init,
                        "controller_s": _t_ctl - _t_plan,
                        "trace_s": _t_trace - _t_ctl}
        # lazily-built stacked plan/cost tables for _robot_step_batch
        self._bst: Optional[dict] = None

        # ---- temporal-delta scene axis (None = every branch below is
        # skipped; the run is bit-identical to a scene-free build)
        self.scene_cfg: Optional[SceneConfig] = None
        self.scene_mat: Optional[np.ndarray] = None
        self._delta_ledger = None
        self.wire_bytes_of = np.zeros(cfg.n_robots, dtype=np.float64)
        self.n_keyframes = 0
        self.n_delta_frames = 0
        self.n_ref_evictions = 0
        self.n_delta_replans = 0
        self._delta_replan_at: Dict[int, float] = {}
        self._delta_replan_ticks: List[int] = []
        self._delta_replan_ptr = 0
        if cfg.scene is not None:
            self.scene_cfg = scene_config(cfg.scene)
            # per-robot change-fraction traces on a seed stream disjoint
            # from the bandwidth traces (rows i use seed*100_003 + i; the
            # +59_999_999 offset keeps the streams apart for any fleet
            # under ~59M robots)
            self.scene_mat = generate_scene_matrix(
                cfg.n_ticks + 1, self.scene_cfg,
                [cfg.seed * 100_003 + i + 59_999_999
                 for i in range(cfg.n_robots)])
            self.delta_ssk = np.zeros(cfg.n_robots, dtype=np.int64)
            self.delta_has_ref = np.zeros(cfg.n_robots, dtype=bool)
            if cfg.delta_ref_budget_bytes is not None:
                # lazy: kvcache pulls in torch for its buffer helpers; the
                # ledger itself is pure Python
                from .kvcache import ReferenceLedger
                self._delta_ledger = ReferenceLedger(
                    cfg.delta_ref_budget_bytes)
            self._refresh_delta_tables()
            if cfg.delta_drift_every > 0 and bool(self._delta_is.any()):
                self._schedule_delta_replans()

        self.replica_names = [f"cloud{i}" for i in range(cfg.n_replicas)]
        self.pool = ElasticPool(on_change=self._on_replicas,
                                timeout_s=cfg.heartbeat_timeout_s)
        self.batchers: Dict[str, MicroBatcher] = {
            r: MicroBatcher(cfg.batch_size, cfg.batch_wait_s)
            for r in self.replica_names}
        self.cbatchers: Dict[str, ContinuousBatcher] = {}
        self.kv_cumsum: Dict[str, np.ndarray] = {}
        if cfg.continuous:
            # lazy: kvcache pulls in torch for its buffer helpers; the
            # analytic cumsums used here are numpy-only
            from .kvcache import graph_kv_cumsum
            self.kv_cumsum = {
                a: graph_kv_cumsum(self.graphs[a], get_config(a),
                                   cfg.workload) for a in archs}
            self.cbatchers = {
                r: ContinuousBatcher(cfg.batch_size, cfg.kv_budget_bytes,
                                     batch_overlap=cfg.batch_overlap,
                                     kv_admit_frac=cfg.kv_admit_frac)
                for r in self.replica_names}
        self.mitigator = StragglerMitigator()
        self.busy_until: Dict[str, float] = {r: 0.0
                                             for r in self.replica_names}

        self._down: set = set()
        self._cloud_up = True
        self._pending: Dict[int, _CloudWork] = {}
        self._next_wid = 0
        self.next_free = np.zeros(cfg.n_robots, dtype=np.float64)
        self.latencies: List[List[float]] = [[] for _ in range(cfg.n_robots)]
        # engine hooks (events engine only; None = tick loop, no-ops):
        # _wake(robot) fires after _complete releases a robot's closed
        # loop, _wake_batch(idx_array) is its vectorized counterpart
        # (one call per completion batch), _enq(replica) after cloud
        # work lands on a replica
        self._wake = None
        self._wake_batch = None
        self._enq = None
        # open-loop arrival traffic state (events engine fills these)
        self.proc_latencies: List[List[float]] = [
            [] for _ in cfg.arrival_processes]
        self.proc_arrivals = [0] * len(cfg.arrival_processes)
        self.proc_rejections = [0] * len(cfg.arrival_processes)
        self.n_autoscale = 0
        self.n_hedged = 0
        self.n_replans = 0
        self.n_outage_completions = 0
        self.n_codec_switches = 0
        self.n_cut_moves = 0
        self.n_multicut_requests = 0
        self.n_chunk_reconfigs = 0
        self.n_streamed_requests = 0
        self._bubble_sum = 0.0
        # flight recorder (core/telemetry.py): None = off.  Every hot-path
        # hook below guards on ``self.recorder is not None``, so the off
        # path costs one attribute check per request.
        self.recorder: Optional[FlightRecorder] = None
        if cfg.telemetry != "off":
            self.recorder = FlightRecorder(
                mode=cfg.telemetry, cap=cfg.telemetry_cap,
                sample_every=cfg.telemetry_sample_every, seed=cfg.seed)
            for r, cb in self.cbatchers.items():
                cb.observer = ContObserver(self.recorder, r)

    # ---------------------------------------------------------- plan tables
    def _build_plans(self, queue_hz: float):
        """One vectorized plan-table pass at the given per-replica arrival
        rate.  Returns ``(plan, plan_s2, plan_codec, plan_chunks)`` dicts
        keyed by arch; ``queue_hz = 0`` is the queue-blind table."""
        cfg = self.cfg
        archs = list(self.graphs)
        qkw = dict(queue_hz=queue_hz, queue_cv2=cfg.queue_cv2,
                   queue_service_scale=cfg.queue_service_scale)
        if cfg.streamed:
            # streamed plan table: per-model (C, S1, S2, K, B) passes —
            # each bin stores the joint (S1, S2, codec, n_chunks) optimum
            # (single-cut masked when not multicut); K = 1 bins price
            # exactly like the non-streamed tables
            st = sweep_multicut(self.graphs, cfg.edge, cfg.cloud,
                                self.bw_grid, cfg.cloud_budget_bytes,
                                rtt_s=cfg.rtt_s,
                                input_bytes=cfg.workload.input_bytes,
                                codecs=self.codecs,
                                down_bw_factor=cfg.down_bw_factor,
                                single_cut_only=not cfg.multicut,
                                chunk_grid=cfg.chunk_grid, **qkw)
            return ({a: st[a].s1 for a in archs},
                    {a: st[a].s2 for a in archs},
                    {a: st[a].codec_idx for a in archs},
                    {a: st[a].n_chunks for a in archs})
        if cfg.multicut:
            # multi-cut plan table: one (M, C, S1, S2, B) pass — each bin
            # stores the joint (S1, S2, codec) optimum; S2 == n collapses
            # the bin to the single-cut plan
            mc = sweep_multicut(self.graphs, cfg.edge, cfg.cloud,
                                self.bw_grid, cfg.cloud_budget_bytes,
                                rtt_s=cfg.rtt_s,
                                input_bytes=cfg.workload.input_bytes,
                                codecs=self.codecs,
                                down_bw_factor=cfg.down_bw_factor, **qkw)
            return ({a: mc[a].s1 for a in archs},
                    {a: mc[a].s2 for a in archs},
                    {a: mc[a].codec_idx for a in archs},
                    {a: np.ones(len(self.bw_grid), dtype=int)
                     for a in archs})
        plans = sweep_search(self.graphs, cfg.edge, cfg.cloud,
                             self.bw_grid, cfg.cloud_budget_bytes,
                             rtt_s=cfg.rtt_s,
                             input_bytes=cfg.workload.input_bytes,
                             codecs=self.codecs, **qkw)
        return ({a: plans[a].splits for a in archs},
                {a: np.full(len(self.bw_grid), self.arrays[a].n, dtype=int)
                 for a in archs},
                {a: plans[a].codec_idx for a in archs},
                {a: np.ones(len(self.bw_grid), dtype=int) for a in archs})

    def _estimate_arrival_hz(self) -> float:
        """Per-replica cloud arrival rate for the queue-aware plan tables:
        the open-loop estimate (``_open_arrival_hz``) capped by the
        closed-network population bound (``_closed_loop_cap_hz``).  The
        open estimate alone treats every robot as re-issuing at its
        zero-wait cycle rate — on a fast cloud that over-counts badly
        (the closed loop slows itself down as queues build), drives the
        M/G/1 term to ρ ≥ 1 and makes the planner retreat to plan-harmful
        edge-heavy splits (docs/EXPERIMENTS.md §Queue-aware)."""
        lam = self._open_arrival_hz()
        cap = self._closed_loop_cap_hz()
        return min(lam, cap) if cap > 0.0 else lam

    def _open_arrival_hz(self) -> float:
        """Per-replica cloud arrival rate implied by the queue-blind plan
        at the nominal bandwidth: every robot whose nominal-bin plan has a
        non-empty cloud window re-issues as fast as its planned closed
        loop allows (rate ``1 / T_i``, with ``T_i`` the plan's end-to-end
        latency), spread uniformly over the replicas."""
        cfg = self.cfg
        k0 = int(np.searchsorted(self._bw_mid, cfg.nominal_bw_bps))
        lam = 0.0
        for a in self.arch_of:
            arrays = self.arrays[a]
            s1 = int(self.plan[a][k0])
            s2 = int(self.plan_s2[a][k0])
            if s1 >= s2:
                continue                       # no cloud work planned
            cdc = self.codecs[int(self.plan_codec[a][k0])]
            if s2 < arrays.n:
                eh, c, t, dn = arrays.placement_latency(
                    s1, s2, cfg.nominal_bw_bps, cfg.rtt_s, codec=cdc,
                    down_bw_factor=cfg.down_bw_factor)
                total = eh + c + t + dn
            else:
                e, c, t = arrays.latency(s1, cfg.nominal_bw_bps,
                                         cfg.rtt_s, codec=cdc)
                total = e + c + t
            if total > 0:
                lam += 1.0 / total
        return lam / max(1, cfg.n_replicas)

    def _closed_loop_cap_hz(self) -> float:
        """Closed-network population bound on the per-replica arrival
        rate.  The fleet is a CLOSED queueing network — each robot has at
        most one request in flight — and a single server cycled by ``N_r``
        customers can never be driven past utilization
        ``ρ = N_r / (N_r + 1)`` (the asymptotic mean-value-analysis bound;
        at ρ above it the customers would all have to be queued *and* in
        service at once).  With ``S̄`` the mean planned cloud service time
        of the robots that use the cloud, that bounds the sustainable
        per-replica rate at ``λ ≤ ρ_max / S̄`` — equivalently
        ``λ ≤ N_r / E[cycle time]`` with the cycle floored at its service
        content.  The full M/M/1/K / exact-MVA prior (wait-aware cycle
        times, per-class populations) stays on the roadmap; this cap is
        the honest slice that stops the open estimator's ρ ≥ 1 retreat.
        Returns 0.0 when no robot plans cloud work (no cap needed)."""
        cfg = self.cfg
        k0 = int(np.searchsorted(self._bw_mid, cfg.nominal_bw_bps))
        services = []
        for a in self.arch_of:
            arrays = self.arrays[a]
            s1 = int(self.plan[a][k0])
            s2 = int(self.plan_s2[a][k0])
            if s1 >= s2:
                continue                       # no cloud work planned
            services.append(float(arrays.cloud_s[s1] - arrays.cloud_s[s2]))
        if not services:
            return 0.0
        n_r = len(services) / max(1, cfg.n_replicas)
        s_bar = (sum(services) / len(services)) * cfg.queue_service_scale
        if s_bar <= 0.0:
            return 0.0
        rho_max = n_r / (n_r + 1.0)
        return rho_max / s_bar

    @property
    def place_of(self) -> List[tuple]:
        """Compatibility view of the per-robot placement state (the
        struct-of-arrays refactor split it into ``place_s1``/``place_s2``)."""
        return list(zip(self.place_s1.tolist(), self.place_s2.tolist()))

    def _refresh_pool_cache(self) -> None:
        """Re-snapshot every robot's parameter-sharing pools — the Pool
        objects for the scalar clamp and the lo/hi bound arrays for the
        vectorized one.  Pools move only inside ``RoboECC.replan()``, so
        this runs at construction and after each ``_on_replicas`` replan
        wave — the per-request clamp then never touches the controller."""
        for i, ctl in enumerate(self.controllers):
            p1 = ctl.pool
            p2 = getattr(ctl, "pool2", None)
            self._pools1[i] = p1
            self._pools2[i] = p2
            self._pool_lo1[i] = p1.start
            self._pool_hi1[i] = p1.end
            if p2 is not None:
                self._pool_lo2[i] = p2.start
                self._pool_hi2[i] = p2.end
                self._has_pool2[i] = True
            else:
                self._pool_lo2[i] = 0
                self._pool_hi2[i] = 0
                self._has_pool2[i] = False

    # ----------------------------------------------------------- elasticity
    # attributes ``RoboECC.replan`` reassigns — the replan memo snapshots
    # exactly these (all are replaced wholesale, never mutated in place,
    # so a shallow snapshot/restore is exact)
    _REPLAN_ATTRS = ("edge_dev", "cloud_dev", "seg", "placement", "split",
                     "pool", "pool2")

    def _ctl_snapshot(self, ctl: RoboECC) -> dict:
        return {a: getattr(ctl, a) for a in self._REPLAN_ATTRS}

    def _replan_wave(self, condition: str) -> None:
        """Replan every DISTINCT controller for a cloud condition
        (``"dead"`` = full outage, ``"alive"`` = restored), restoring a
        memoized snapshot when this controller has already been replanned
        for the condition — ``replan()`` under a fixed condition is
        deterministic, so the snapshot IS the replan result."""
        cfg = self.cfg
        t0 = time.perf_counter()
        done: set = set()
        for ctl in self.controllers:
            if id(ctl) in done:
                continue
            done.add(id(ctl))
            key = (id(ctl), condition)
            snap = self._replan_memo.get(key)
            if snap is not None:
                for attr, val in snap.items():
                    setattr(ctl, attr, val)
                continue
            if condition == "dead":
                ctl.replan(cloud=self._dead_cloud,
                           nominal_bw_bps=cfg.nominal_bw_bps)
            else:
                ctl.replan(cloud=cfg.cloud,
                           cloud_budget_bytes=cfg.cloud_budget_bytes,
                           nominal_bw_bps=cfg.nominal_bw_bps)
            self._replan_memo[key] = self._ctl_snapshot(ctl)
        # accounting matches the historical one-replan-per-robot waves:
        # sharing controllers dedups the WORK, not the event count
        self.n_replans += cfg.n_robots
        self._refresh_pool_cache()
        self.replan_wall_s += time.perf_counter() - t0

    def _on_replicas(self, live: List[str]) -> None:
        """ElasticPool transition: full outage → every robot replans to
        edge-only (split = n); first re-join → replan restores Alg. 1."""
        if not live and self._cloud_up:
            self._cloud_up = False
            self._replan_wave("dead")
        elif live and not self._cloud_up:
            self._cloud_up = True
            self._replan_wave("alive")

    # ------------------------------------------------------------- planning
    def _planned_placement(self, robot: int, bw_bps: float) -> tuple:
        """Plan-table lookup for this bandwidth bin: the (S1, S2) placement
        window, each cut clamped into its parameter-sharing pool — cuts
        may only move where weights are already resident on both tiers
        (a robot whose controller planned single-cut has no tail pool, so
        its S2 pins to n).  Also advances the robot's codec state to the
        jointly-planned codec (a pure software switch — no weights move)
        and counts effective placement changes in ``n_cut_moves``; in
        streamed mode likewise the robot's chunk count (another pure
        software reconfiguration, ``n_chunk_reconfigs``) — bins or
        clamped placements where streaming does not apply reset it to 1.
        Returns ``(s1, s2, n_chunks)``."""
        arch = self.arch_of[robot]
        k = bisect.bisect_left(self._bw_mid_list, bw_bps)
        n = self.arrays[arch].n
        s1_plan = int(self.plan[arch][k])
        s2_plan = int(self.plan_s2[arch][k])
        # adopt the bin's codec only when its plan has a codec-applicable
        # transport leg — a no-transfer (edge-only) or raw-observation-only
        # bin breaks codec ties arbitrarily, and the pool clamp below may
        # still force a collaborative cut, which must not ship raw just
        # because the bin's codec was meaningless
        if s1_plan < s2_plan and (0 < s1_plan < n or s2_plan < n):
            ci = int(self.plan_codec[arch][k])
            if ci != self.codec_of[robot]:
                self.codec_of[robot] = ci
                self.n_codec_switches += 1
        s1 = self._pools1[robot].clamp(s1_plan)
        pool2 = self._pools2[robot]
        if pool2 is not None:
            s2 = max(s1, pool2.clamp(s2_plan))
        else:
            s2 = n
        if s1 != self.place_s1[robot] or s2 != self.place_s2[robot]:
            self.place_s1[robot] = s1
            self.place_s2[robot] = s2
            self.n_cut_moves += 1
        kc = int(self.plan_chunks[arch][k]) if self.cfg.streamed else 1
        if not (s1 < s2 and stream_applies(
                s1, n, float(self.arrays[arch].wire_bytes[s1]))):
            kc = 1          # clamped/degenerate placement: nothing streams
        if kc != self.chunks_of[robot]:
            self.chunks_of[robot] = kc
            self.n_chunk_reconfigs += 1
        return s1, s2, kc

    def _planned_split(self, robot: int, bw_bps: float) -> int:
        """Single-cut view of ``_planned_placement`` (legacy helper)."""
        return self._planned_placement(robot, bw_bps)[0]

    # -------------------------------------------------------- temporal delta
    def _refresh_delta_tables(self) -> None:
        """Per-codec-index delta parameter arrays for the measured
        pricing: which codecs are delta, the base codec's wire factor
        (key-frame cost), the change-mask wire factor (one bit per
        ``row_elems`` raw elements) and the resync cadence.  Rebuilt
        whenever ``self.codecs`` is swapped by a drift replan."""
        cd = self.codecs
        self._delta_is = np.asarray(
            [isinstance(c, DeltaCodec) for c in cd], dtype=bool)
        base_wf = np.zeros(len(cd))
        mask_wf = np.zeros(len(cd))
        R = np.ones(len(cd), dtype=np.int64)
        for j, c in enumerate(cd):
            if isinstance(c, DeltaCodec):
                b = make_codecs(c.raw_bytes_per_elem)[c.base]
                base_wf[j] = b.wire_factor
                mask_wf[j] = (1.0 / (8.0 * c.row_elems)) \
                    / c.raw_bytes_per_elem
                R[j] = c.resync_every
        self._delta_base_wf = base_wf
        self._delta_mask_wf = mask_wf
        self._delta_R = R

    def _schedule_delta_replans(self) -> None:
        """Precompute the drift-replan schedule from the scene matrix:
        every ``delta_drift_every`` ticks, compare the fleet-mean
        measured change fraction over the window against the current
        planned ``change_frac``; relative drift beyond
        ``delta_drift_tol`` schedules a replan at that tick.  Purely a
        function of (seed, scene, tick) — robot processing order never
        enters — so the tick, scalar-event and vectorized-event engines
        apply identical replans at identical points."""
        cfg = self.cfg
        fm = self.scene_mat.mean(axis=0)
        planned = float(next(c.change_frac for c in self.codecs
                             if isinstance(c, DeltaCodec)))
        w = int(cfg.delta_drift_every)
        for t0 in range(w, cfg.n_ticks + 1, w):
            m = float(fm[t0 - w:t0].mean())
            if planned > 0.0 and abs(m - planned) / planned \
                    > cfg.delta_drift_tol:
                self._delta_replan_at[t0] = m
                planned = m
        self._delta_replan_ticks = sorted(self._delta_replan_at)

    def _maybe_delta_replan(self, tick: int) -> None:
        """Apply every scheduled drift replan with trigger tick ≤ this
        tick.  Called at the top of both robot-phase bodies, before any
        robot of the tick is priced; the fast path (no pending replan)
        is one comparison."""
        ptr = self._delta_replan_ptr
        ts = self._delta_replan_ticks
        while ptr < len(ts) and ts[ptr] <= tick:
            self._apply_delta_replan(self._delta_replan_at[ts[ptr]])
            ptr += 1
        self._delta_replan_ptr = ptr

    def _apply_delta_replan(self, measured_frac: float) -> None:
        """Rebuild every delta codec around the measured change fraction
        (same base / cadence / threshold, same NAME — codec indices in
        ``codec_of`` and the plan tables stay valid) and re-run the plan
        tables with it.  Controllers keep their construction-time codec:
        fleet drift replans move the shared plan tables, not the
        per-arch ``RoboECC`` state — controller-grade adaptation is the
        separately-tested ``RoboECC.observe_change_frac``."""
        self.codecs = [
            make_delta_codec(base=c.base, change_frac=measured_frac,
                             resync_every=c.resync_every,
                             threshold=c.threshold, row_elems=c.row_elems,
                             raw_bytes_per_elem=c.raw_bytes_per_elem,
                             name=c.name)
            if isinstance(c, DeltaCodec) else c for c in self.codecs]
        (self.plan, self.plan_s2, self.plan_codec,
         self.plan_chunks) = self._build_plans(self.plan_queue_hz)
        self._bst = None
        self._refresh_delta_tables()
        self.n_delta_replans += 1

    def _delta_frame(self, i: int, ci: int, frac: float, wire_raw: float
                     ) -> float:
        """One robot's delta-frame decision: key frame when the robot
        has no live reference, the resync cadence fires, or the delta
        at this frame's change fraction would not beat a key frame
        (fully dynamic scenes degrade to every-frame key frames — the
        honest negative).  Updates the per-robot cadence state, the
        frame counters and — with a budget — the reference ledger
        (reference bytes = the raw activation at the cut; evicted
        robots lose their reference and key-frame next time).  Returns
        the measured wire factor for this frame."""
        base_wf = float(self._delta_base_wf[ci])
        dwf = frac * base_wf + float(self._delta_mask_wf[ci])
        key = ((not self.delta_has_ref[i])
               or self.delta_ssk[i] >= self._delta_R[ci] - 1
               or dwf >= base_wf)
        self.delta_ssk[i] = 0 if key else self.delta_ssk[i] + 1
        self.delta_has_ref[i] = True
        if key:
            self.n_keyframes += 1
        else:
            self.n_delta_frames += 1
        if self._delta_ledger is not None:
            for k in self._delta_ledger.put(int(i), wire_raw):
                self.delta_has_ref[k] = False
                self.n_ref_evictions += 1
        return base_wf if key else dwf

    def _delta_uplink(self, i: int, tick: int, s1: int, s2: int, n: int,
                      wire_raw: float, cdc: Codec) -> Optional[float]:
        """Scalar measured-wire hook for one robot step: ``None`` when
        the placement has no codec-applicable uplink leg; otherwise the
        measured wire factor (the codec's own factor for non-delta
        codecs — the byte accounting must cover the comparison
        baselines too), with the robot's wire bytes accumulated."""
        if not (s1 < s2 and 0 < s1 < n and wire_raw > 0.0):
            return None
        if self._delta_is[cdc_i := int(self.codec_of[i])]:
            wf = self._delta_frame(i, cdc_i, float(self.scene_mat[i, tick]),
                                   wire_raw)
        else:
            wf = cdc.wire_factor
        self.wire_bytes_of[i] += wf * wire_raw
        return wf

    def _delta_uplink_batch(self, idxs: np.ndarray, tick: int,
                            s1: np.ndarray, s2: np.ndarray,
                            n_v: np.ndarray, wire_s1: np.ndarray,
                            ci: np.ndarray) -> tuple:
        """Vector mirror of ``_delta_uplink`` over one tick's batch:
        identical expressions elementwise, per-robot state updates
        vectorized (independent across robots), byte accumulation
        per-robot (order-independent — ``idxs`` are unique).  With a
        reference budget the delta walk drops to a scalar loop in
        ascending index: ledger eviction is order-sensitive, and the
        scalar engine processes robots in exactly that order.  Returns
        ``(wire factors, applicable mask)``."""
        bst = self._bst
        app = (s1 < s2) & (0 < s1) & (s1 < n_v) & (wire_s1 > 0.0)
        wf = np.array(bst["wf"][ci])
        d = app & self._delta_is[ci]
        if self._delta_ledger is None:
            if d.any():
                frac = self.scene_mat[idxs, tick]
                base_wf = self._delta_base_wf[ci]
                dwf = frac * base_wf + self._delta_mask_wf[ci]
                ssk = self.delta_ssk[idxs]
                key = d & (~self.delta_has_ref[idxs]
                           | (ssk >= self._delta_R[ci] - 1)
                           | (dwf >= base_wf))
                wf = np.where(d, np.where(key, base_wf, dwf), wf)
                self.delta_ssk[idxs] = np.where(
                    d, np.where(key, 0, ssk + 1), ssk)
                self.delta_has_ref[idxs] |= d
                self.n_keyframes += int(np.count_nonzero(key))
                self.n_delta_frames += int(np.count_nonzero(d & ~key))
        else:
            for j in np.flatnonzero(d):
                wf[j] = self._delta_frame(
                    int(idxs[j]), int(ci[j]),
                    float(self.scene_mat[int(idxs[j]), tick]),
                    float(wire_s1[j]))
        aw = np.flatnonzero(app)
        if len(aw):
            self.wire_bytes_of[idxs[aw]] += wf[aw] * wire_s1[aw]
        return wf, app

    # ------------------------------------------------------------- streaming
    def _stream_uplink(self, robot: int, arrays: GraphArrays, s1: int,
                       cdc: Codec, edge_head_s: float, cloud_s: float,
                       wire_factor: Optional[float] = None) -> tuple:
        """Price the robot's chunked uplink against its ACTUAL trace: the
        transfer starts once the edge head finishes and chunk 1 is
        encoded, chunks ship back-to-back consuming each tick's bandwidth
        (``NetworkSim.wire_trace_s`` — a transfer spanning many ticks
        sees every tick it spans, not one frozen rate), and the cloud
        window's prefill overlaps arrived chunks.  Returns the
        transport-exposed uplink seconds (``makespan − cloud_s`` — the
        replica still executes the full window inside its batch, so the
        batched-execution machinery composes unchanged) and the pipeline's
        fill/drain bubble fraction.

        ``wire_factor`` overrides the codec's cycle-average wire factor
        with this frame's MEASURED one (temporal delta: key frames ship
        the full base payload, delta frames only the changed rows).
        Encode/decode stay at the codec's cycle-average rates — the
        per-frame codec work variation is second-order next to the wire
        term it scales, and keeping it fixed keeps the planner's
        compute-side pricing exact."""
        net = self.nets[robot]
        K = self.chunks_of[robot]
        wire_raw = float(arrays.wire_bytes[s1])
        enc = cdc.encode_s(wire_raw, self.cfg.edge)
        dec = cdc.decode_s(wire_raw, self.cfg.cloud)
        wire_c = (wire_raw * wire_factor if wire_factor is not None
                  else cdc.wire_bytes(wire_raw))
        per_chunk = wire_c / K
        off = edge_head_s + enc / K
        wire_times = []
        for _ in range(K):
            w = net.wire_trace_s(per_chunk, off)
            wire_times.append(w)
            off += w
        m = stream_makespan_scalar(enc, np.asarray(wire_times),
                                   dec + cloud_s, K, net.rtt_s)
        peak = max(enc, sum(wire_times) + K * net.rtt_s, dec + cloud_s)
        bubble = (m - peak) / m if m > 0 else 0.0
        return m - cloud_s, bubble

    # ------------------------------------------------------------ telemetry
    # Issue-time prediction capture for the drift audit.  Only sampled
    # requests pay for these (the recorder's ``want()`` gate comes
    # first), and nothing here touches ``self.rng`` or any other
    # simulation state — the recorder-off run is bit-identical.

    def _tele_key(self, i: int, now: float) -> int:
        """Engine-order-independent request identity for sampling: robot
        (or arrival) index × issue tick.  Both engines and both robot
        phases (scalar/vectorized) derive the same key for the same
        request, so the sampled subset never depends on replay order."""
        return i * 1_000_003 + int(round(now / self.cfg.tick_s))

    def _tele_want_js(self, idxs: np.ndarray, now: float) -> np.ndarray:
        """Vectorized ``FlightRecorder.want`` over one batch of robot
        indices: the same ``_tele_key`` → Knuth-hash keep/drop decision
        as the scalar gate, in one numpy pass — sampled mode must not
        pay a Python loop over every unsampled robot.  uint64 wraps mod
        2**64, a multiple of the gate's 2**32 mask, so the masked hash
        is bitwise the scalar one.  Returns positions into ``idxs``
        whose request is recorded (all of them in full mode)."""
        rec = self.recorder
        if rec.mode == "full":
            return np.arange(len(idxs))
        tickk = int(round(now / self.cfg.tick_s))
        keys = idxs.astype(np.uint64) * np.uint64(1_000_003) \
            + np.uint64(tickk)
        h = (keys * np.uint64(_HASH_KNUTH)) & np.uint64(0xFFFFFFFF)
        return np.flatnonzero(h % np.uint64(rec.sample_every) == 0)

    def _tele_pred_edge(self, lane: str, e: float) -> dict:
        """Edge-only prediction (outage / no-cloud-work placements)."""
        return {"edge_s": e, "uplink_s": 0.0, "queue_s": 0.0,
                "service_s": 0.0, "down_s": 0.0, "total_s": e,
                "wire_bytes": 0.0, "_lane": lane, "_enc_s": 0.0,
                "_dec_s": 0.0, "_wire_bytes": 0.0, "_bubble": None}

    def _tele_pred(self, lane: str, arch: str, bw: float, s1: int, s2: int,
                   kc: int, ci: int, e: float, c: float, t: float,
                   down: float, wire_meas_over: Optional[float] = None
                   ) -> dict:
        """The planner's predicted stage decomposition at issue time —
        the ``evaluate_placement`` legs as priced (edge head, uplink,
        cloud window, downlink + tail), the M/G/1 wait prior the
        queue-aware tables optimized (``queue_delay_s`` at the plan's
        arrival rate; 0 when queue-blind, clamped to 0 with a counter
        when the prior saturates), and for streamed placements the
        FROZEN-bandwidth 3-stage makespan (uniform chunk wire times at
        the issue-time rate) in place of the trace-integrated uplink the
        runtime will actually pay.  Private ``_``-keys carry span
        context (lane, codec costs, measured wire bytes) to completion.

        ``wire_meas_over`` overrides the measured wire bytes with this
        frame's actual shipped bytes (temporal delta); the predicted
        bytes stay at the plan bin's cycle average, so the existing
        ``wire_bytes`` drift stage directly audits how far the planned
        change fraction sat from the scene's reality."""
        cfg = self.cfg
        rec = self.recorder
        arrays = self.arrays[arch]
        cdc = self.codecs[ci]
        n = arrays.n
        wire_raw = float(arrays.wire_bytes[s1])
        applicable = (0 < s1 < n) and wire_raw > 0.0
        wire_meas = cdc.wire_bytes(wire_raw) if applicable else wire_raw
        if wire_meas_over is not None:
            wire_meas = wire_meas_over
        # predicted wire bytes come from the PLAN BIN (unclamped split,
        # bin codec); the measured bytes from the clamped split + sticky
        # codec state — their gap is the pool-clamp / codec-gate drift
        k = bisect.bisect_left(self._bw_mid_list, bw)
        s1p = int(self.plan[arch][k])
        cp = self.codecs[int(self.plan_codec[arch][k])]
        wire_rawp = float(arrays.wire_bytes[s1p]) if s1p <= n else 0.0
        wire_pred = (cp.wire_bytes(wire_rawp)
                     if (0 < s1p < n) and wire_rawp > 0.0 else wire_rawp)
        up_pred, bub_pred = t, 0.0
        enc_s = dec_s = 0.0
        if applicable:
            enc_s = cdc.encode_s(wire_raw, cfg.edge)
            dec_s = cdc.decode_s(wire_raw, cfg.cloud)
        if kc > 1 and c > 0.0:
            # frozen-bandwidth streamed makespan: what the plan table's
            # pipeline model promised before the trace moved under it
            wires = np.full(kc, wire_meas / kc / bw)
            m = stream_makespan_scalar(enc_s, wires, dec_s + c, kc,
                                       cfg.rtt_s)
            peak = max(enc_s, float(wires.sum()) + kc * cfg.rtt_s,
                       dec_s + c)
            bub_pred = (m - peak) / m if m > 0 else 0.0
            up_pred = m - c
            enc_s = dec_s = 0.0      # chunked: no single encode/wire split
        q_pred = 0.0
        if c > 0.0 and self.plan_queue_hz > 0.0:
            q_pred = queue_delay_s(c, self.plan_queue_hz,
                                   cv2=cfg.queue_cv2,
                                   service_scale=cfg.queue_service_scale)
            if not math.isfinite(q_pred):
                rec.drift.n_pred_saturated += 1
                q_pred = 0.0
        return {"edge_s": e, "uplink_s": up_pred, "queue_s": q_pred,
                "service_s": c, "down_s": down,
                "total_s": e + up_pred + q_pred + c + down,
                "wire_bytes": wire_pred, "bubble_frac": bub_pred,
                "_lane": lane, "_enc_s": enc_s, "_dec_s": dec_s,
                "_wire_bytes": wire_meas, "_bubble": None}

    # ------------------------------------------------------------ execution
    def _complete(self, robot: int, issued_s: float, latency_s: float) -> None:
        """Fold a finished request into the robot's series and release the
        robot's control loop (closed loop: one outstanding request each).
        The events engine hooks ``_wake`` to schedule the robot's next
        control step; the tick loop polls ``next_free`` instead."""
        self.latencies[robot].append(latency_s)
        self.next_free[robot] = issued_s + latency_s
        if self._wake is not None:
            self._wake(robot)

    def _deliver(self, it: _CloudWork, latency_s: float) -> None:
        """Route a finished piece of work to its owner: closed-loop robots
        fold into ``_complete`` (releasing the control loop), open-loop
        arrivals into their process latency series (nothing to release —
        a one-shot request has no issuer waiting)."""
        if it.proc >= 0:
            self.proc_latencies[it.proc].append(latency_s)
        else:
            self._complete(it.robot, it.issued_s, latency_s)

    def _execute(self, requests: Sequence[Request], live: List[str]) -> None:
        """Run one formed batch on the best replica, hedging stragglers."""
        cfg = self.cfg
        items = [self._pending.pop(rq.rid) for rq in requests]
        ready = max(it.ready_s for it in items)
        costs = [it.cloud_s for it in items]
        peak = max(costs)
        # batched execution: the heaviest member bounds the pass; the rest
        # overlaps all but (1 - batch_overlap) of its work
        base = peak + (sum(costs) - peak) * (1.0 - cfg.batch_overlap)

        def exec_fn(replica: str) -> float:
            wait = max(0.0, self.busy_until[replica] - ready)
            slow = float(np.exp(self.rng.normal(0.0, cfg.straggler_sigma)))
            if self.rng.random() < cfg.tail_prob:
                slow *= cfg.tail_scale
            return wait + base * slow

        out = self.mitigator.run(list(live), exec_fn)
        if out.hedged:
            self.n_hedged += 1
        rec = self.recorder
        # winner's pre-update busy wait: the queue share of out.latency_s
        wait_w = (max(0.0, self.busy_until[out.winner] - ready)
                  if rec is not None else 0.0)
        self.busy_until[out.winner] = ready + out.latency_s
        for rq, it in zip(requests, items):
            # down_s = downlink transport + edge-tail compute of a 2-cut
            # placement (0 for single-cut), paid after the cloud batch.
            # Only requests that actually complete the 2-cut path count —
            # outage fallbacks re-execute edge-only and don't.
            if it.two_cut:
                self.n_multicut_requests += 1
            lat = (it.edge_s + it.net_s
                   + (ready - it.ready_s) + out.latency_s
                   + it.down_s)
            if rec is not None and it.pred is not None:
                p = it.pred
                rec.record_request(
                    req=rq.rid, lane=p["_lane"], t0_s=it.issued_s,
                    edge_s=it.edge_s, uplink_s=it.net_s,
                    queue_s=(ready - it.ready_s) + wait_w,
                    service_s=out.latency_s - wait_w, down_s=it.down_s,
                    total_s=lat, replica=out.winner,
                    enc_s=p["_enc_s"], dec_s=p["_dec_s"], pred=p,
                    outcome="hedged" if out.hedged else "ok",
                    wire_bytes=p["_wire_bytes"],
                    bubble_frac=p["_bubble"])
            self._deliver(it, lat)

    def _finish_cont(self, req: Request, fin_s: float) -> None:
        """Fold one continuous-tier completion: the robot pays its edge +
        uplink legs, the replica-side sojourn (admission wait + batched
        service, ``fin_s - ready_s``) and any 2-cut downlink tail."""
        it = self._pending.pop(req.rid)
        if it.two_cut:
            self.n_multicut_requests += 1
        lat = (it.edge_s + it.net_s + (fin_s - it.ready_s)
               + it.down_s)
        rec = self.recorder
        if rec is not None and it.pred is not None:
            # the ContObserver accumulated this request's admission
            # waits; service = sojourn minus queue (batched execution
            # including any preempt/recompute cycles)
            st = rec.pop_cont(req.rid) or {}
            p = it.pred
            q = st.get("queue_s", 0.0)
            rec.record_request(
                req=req.rid, lane=p["_lane"], t0_s=it.issued_s,
                edge_s=it.edge_s, uplink_s=it.net_s, queue_s=q,
                service_s=(fin_s - it.ready_s) - q, down_s=it.down_s,
                total_s=lat, replica=st.get("replica"),
                enc_s=p["_enc_s"], dec_s=p["_dec_s"], pred=p,
                extra_spans=st.get("spans", ()),
                outcome="preempted" if st.get("preempts") else "ok",
                wire_bytes=p["_wire_bytes"], bubble_frac=p["_bubble"])
        self._deliver(it, lat)

    def _drain_dead_cont(self, routable: List[str]) -> None:
        """Continuous tier: a dead replica's slots and queue are evicted
        (in-flight KV is lost — full recompute) and re-admitted on the
        least-backlogged routable replica, or fall back to edge-only
        re-execution when no replica accepts work."""
        for r in self.replica_names:
            if r in self._down and len(self.cbatchers[r]):
                for req, svc, kv in self.cbatchers[r].drain():
                    if routable:
                        tgt = min(routable, key=lambda x:
                                  self.cbatchers[x].backlog_s)
                        self.cbatchers[tgt].add(req, svc, kv)
                    else:
                        if self.recorder is not None:
                            self.recorder.pop_cont(req.rid)
                        self._fallback_one(self._pending.pop(req.rid))

    def _fallback_one(self, it: _CloudWork) -> None:
        """Cloud unavailable with work in flight: re-execute the request
        entirely on its robot's edge device (uplink time already spent is
        kept as sunk cost)."""
        arch = (self.arch_of[it.robot] if it.proc < 0
                else self.cfg.arrival_processes[it.proc].arch)
        arrays = self.arrays[arch]
        edge_only = float(arrays.edge_s[arrays.n])
        lat = it.edge_s + it.net_s + edge_only
        rec = self.recorder
        if rec is not None and it.pred is not None:
            # sunk edge+uplink cost plus the edge re-execution; the
            # planned cloud window/downlink never ran — their drift is
            # the full prediction, which is exactly the outage story
            p = it.pred
            rec.record_request(
                req=-1, lane=p["_lane"], t0_s=it.issued_s,
                edge_s=it.edge_s, uplink_s=it.net_s, queue_s=0.0,
                service_s=edge_only, down_s=0.0, total_s=lat,
                enc_s=p["_enc_s"], dec_s=p["_dec_s"], pred=p,
                outcome="fallback", wire_bytes=p["_wire_bytes"])
        self._deliver(it, lat)
        self.n_outage_completions += 1

    def _fallback(self, requests: Sequence[Request]) -> None:
        for rq in requests:
            self._fallback_one(self._pending.pop(rq.rid))

    # --------------------------------------------------- shared phase bodies
    # Both engines call these EXACT bodies.  The parity proof
    # (tests/test_engine_parity.py: FleetReport dataclass-equal across the
    # whole config matrix) rests on the event engine replaying the same
    # arithmetic in the same order, just sparsely — so the phase bodies
    # live here once, and the engines only differ in *when* they call them.

    def _robot_step(self, i: int, now: float, routable: List[str]) -> None:
        """One closed-loop control step for a free robot: plan, price,
        enqueue cloud work (or complete locally).  The caller guarantees
        ``now >= next_free[i]`` and that ``nets[i]`` sits at this tick."""
        cfg = self.cfg
        if self.scene_mat is not None:
            # drift replans fire on a precomputed tick schedule, before
            # any robot of the tick is priced (both engines identical)
            self._maybe_delta_replan(int(round(now / cfg.tick_s)))
        net = self.nets[i]
        bw = net.now_bps
        arrays = self.arrays[self.arch_of[i]]
        down, two_cut = 0.0, False
        s1 = s2 = arrays.n
        kc, bub = 1, None
        wf_eff = None                  # measured wire factor (scene axis)
        if self._cloud_up:
            s1, s2, kc = self._planned_placement(i, bw)
            cdc = self.codecs[self.codec_of[i]]
            if s2 < arrays.n:
                # real 2-cut placement: the edge head runs before the
                # uplink, the edge tail after the downlink — only the
                # head gates when the cloud can start
                eh, c, t, dn = arrays.placement_latency(
                    s1, s2, bw, cfg.rtt_s, codec=cdc,
                    down_bw_factor=cfg.down_bw_factor)
                tail = float(arrays.edge_s[arrays.n] - arrays.edge_s[s2])
                e = eh - tail
                down = dn + tail
                two_cut = True
            else:
                e, c, t = arrays.latency(s1, bw, cfg.rtt_s, codec=cdc)
            if self.scene_mat is not None:
                wf_eff = self._delta_uplink(
                    i, int(round(now / cfg.tick_s)), s1, s2, arrays.n,
                    float(arrays.wire_bytes[s1]), cdc)
            if kc > 1 and c > 0.0:
                # streamed uplink: chunk transfers drawn from the
                # PER-TICK trace (not one frozen bandwidth) while the
                # cloud window prefills arrived chunks; the exposed
                # transport time replaces the sequential uplink leg
                t, bub = self._stream_uplink(i, arrays, s1, cdc, e, c,
                                             wire_factor=wf_eff)
                self.n_streamed_requests += 1
                self._bubble_sum += bub
            elif wf_eff is not None:
                # exact wire-term correction: this frame's measured
                # bytes replace the plan's cycle average in the uplink
                # (identically ``+0.0`` for non-delta codecs, whose
                # measured factor IS the cycle average)
                t = t + (wf_eff - cdc.wire_factor) \
                    * float(arrays.wire_bytes[s1]) / bw
        else:
            e, c, t = float(arrays.edge_s[arrays.n]), 0.0, 0.0
        net.step()                      # link evolves every tick
        rec = self.recorder
        tele = None
        if rec is not None and rec.want(self._tele_key(i, now)):
            lane = f"robot:{self.arch_of[i]}"
            if self._cloud_up:
                tele = self._tele_pred(
                    lane, self.arch_of[i], bw, s1, s2, int(kc),
                    int(self.codec_of[i]), e, c, t, down,
                    wire_meas_over=(
                        wf_eff * float(arrays.wire_bytes[s1])
                        if wf_eff is not None else None))
                tele["_bubble"] = bub
            else:
                tele = self._tele_pred_edge(lane, e)
        if c > 0.0 and routable:
            wid = self._next_wid
            self._next_wid += 1
            work = _CloudWork(i, now, now + e + t, e, t, c, down, two_cut,
                              pred=tele)
            self._pending[wid] = work
            self.next_free[i] = float("inf")   # until completion
            if tele is not None and cfg.continuous:
                rec.cont_open(wid)
            if cfg.continuous:
                # continuous tier: the straggler multiplier is drawn per
                # request at enqueue (batching efficiency lives in the
                # batcher's eff(k) model), the window's analytic KV
                # footprint is priced from the suffix cumsums, and
                # routing is least-backlog rather than EWMA-primary
                slow = float(np.exp(self.rng.normal(
                    0.0, cfg.straggler_sigma)))
                if self.rng.random() < cfg.tail_prob:
                    slow *= cfg.tail_scale
                kvc = self.kv_cumsum[self.arch_of[i]]
                replica = min(routable, key=lambda r:
                              self.cbatchers[r].backlog_s)
                self.cbatchers[replica].add(
                    Request(wid, now + e + t, 0), c * slow,
                    float(kvc[s1] - kvc[s2]))
            else:
                replica = self.mitigator.pick_primary(routable)
                self.batchers[replica].add(Request(wid, now + e + t, 0))
            if self._enq is not None:
                self._enq(replica)
        elif c > 0.0:
            # planned a collaborative split but no replica accepts work
            # (undetected outage window): edge re-execution
            self._fallback_one(_CloudWork(i, now, now + e + t,
                                          e, t, c, down, two_cut,
                                          pred=tele))
        else:
            # no cloud work: complete locally.  ``down`` is normally 0
            # here, but a clamped placement degenerating to an empty
            # cloud window still owes its edge-tail compute
            lat = e + t + down
            if tele is not None:
                rec.record_request(
                    req=-1, lane=tele["_lane"], t0_s=now, edge_s=e,
                    uplink_s=t, queue_s=0.0, service_s=0.0, down_s=down,
                    total_s=lat, enc_s=tele["_enc_s"],
                    dec_s=tele["_dec_s"], pred=tele,
                    outcome="local" if self._cloud_up else "outage",
                    wire_bytes=tele["_wire_bytes"])
            self._complete(i, now, lat)
            if not self._cloud_up:
                self.n_outage_completions += 1

    # ------------------------------------------------- vectorized robot phase
    # ``_robot_step_batch`` prices every robot that wakes on the same tick
    # in one numpy pass over struct-of-arrays state.  Parity discipline:
    # each array expression mirrors the scalar ``_robot_step`` arithmetic
    # OPERATION FOR OPERATION (same association order, same branch
    # structure via masks) — elementwise numpy ufuncs are bitwise
    # identical to their scalar counterparts, so the batch is
    # full-`FleetReport` dataclass-equal to the scalar loop
    # (tests/test_engine_parity.py pins this on the vectorized axis).
    # Order-sensitive side effects (RNG draws, work ids, batcher adds,
    # streamed pricing, float accumulators) drop to scalar loops in
    # ascending robot index — exactly the order the event heap pops
    # same-tick ROBOT events.

    def _ensure_batch_state(self) -> dict:
        """Stacked per-arch plan/cost tables for the batched robot phase,
        built lazily on first use (plan tables are frozen after
        ``__init__``; pools/codecs live in their own refreshed arrays).
        Arch tables are padded to the widest graph — padding lanes are
        never indexed because every split is bounded by its own arch's
        ``n``."""
        if self._bst is not None:
            return self._bst
        cfg = self.cfg
        archs = list(self.graphs)
        aidx = {a: j for j, a in enumerate(archs)}
        A, B = len(archs), len(self.bw_grid)
        nmax = max(self.arrays[a].n for a in archs)
        s1_t = np.zeros((A, B), dtype=np.int64)
        s2_t = np.zeros((A, B), dtype=np.int64)
        cd_t = np.zeros((A, B), dtype=np.int64)
        kc_t = np.ones((A, B), dtype=np.int64)
        E = np.zeros((A, nmax + 1))
        C = np.zeros((A, nmax + 1))
        W = np.zeros((A, nmax + 1))
        DW = np.zeros((A, nmax + 1))
        n_arr = np.zeros(A, dtype=np.int64)
        has_down = np.zeros(A, dtype=bool)
        edge_only = np.zeros(A)
        for j, a in enumerate(archs):
            s1_t[j] = np.asarray(self.plan[a], dtype=np.int64)
            s2_t[j] = np.asarray(self.plan_s2[a], dtype=np.int64)
            cd_t[j] = np.asarray(self.plan_codec[a], dtype=np.int64)
            kc_t[j] = np.asarray(self.plan_chunks[a], dtype=np.int64)
            ar = self.arrays[a]
            n = ar.n
            E[j, :n + 1] = ar.edge_s
            C[j, :n + 1] = ar.cloud_s
            W[j, :n + 1] = ar.wire_bytes
            if ar.down_wire_bytes is not None:
                DW[j, :n + 1] = ar.down_wire_bytes
                has_down[j] = True
            n_arr[j] = n
            edge_only[j] = float(ar.edge_s[n])
        cd = self.codecs
        self._arch_idx = np.asarray([aidx[a] for a in self.arch_of],
                                    dtype=np.int64)
        self._bst = {
            "s1": s1_t, "s2": s2_t, "codec": cd_t, "chunks": kc_t,
            "E": E, "C": C, "W": W, "DW": DW, "n": n_arr,
            "has_down": has_down, "edge_only": edge_only,
            # codec cost tables (linear per raw byte — codec.py contract)
            "wf": np.asarray([c.wire_factor for c in cd]),
            "enc_up": np.asarray([c.encode_s_per_byte(cfg.edge)
                                  for c in cd]),
            "dec_up": np.asarray([c.decode_s_per_byte(cfg.cloud)
                                  for c in cd]),
            "enc_dn": np.asarray([c.encode_s_per_byte(cfg.cloud)
                                  for c in cd]),
            "dec_dn": np.asarray([c.decode_s_per_byte(cfg.edge)
                                  for c in cd]),
        }
        return self._bst

    def _net_time_vec(self, wire: np.ndarray, bw: np.ndarray,
                      ci: np.ndarray, applicable: np.ndarray,
                      enc_rates: np.ndarray, dec_rates: np.ndarray
                      ) -> np.ndarray:
        """Vector mirror of ``segmentation.net_time`` with a codec and
        both devices bound: codec path = compressed wire + rtt + encode +
        decode (the ``transport_s`` term order), non-applicable path =
        raw wire + rtt, zero raw bytes free."""
        bst = self._bst
        rtt = self.cfg.rtt_s
        tc = (wire * bst["wf"][ci]) / bw + rtt
        tc = tc + wire * enc_rates[ci]
        tc = tc + wire * dec_rates[ci]
        tp = wire / bw + rtt
        t = np.where(applicable, tc, tp)
        return np.where(wire == 0.0, 0.0, t)

    def _complete_batch(self, idx: np.ndarray, issued_s: float,
                        lat: np.ndarray) -> None:
        """Vector mirror of ``_complete`` over a batch of robots."""
        self.next_free[idx] = issued_s + lat
        lats = self.latencies
        for j, i in enumerate(idx):
            lats[i].append(float(lat[j]))
        if self._wake_batch is not None:
            self._wake_batch(idx)
        elif self._wake is not None:
            for i in idx:
                self._wake(int(i))

    def _robot_step_batch(self, idxs: np.ndarray, tick: int, now: float,
                          routable: List[str]) -> None:
        """All of one tick's free robots in a single vectorized pass:
        plan-table lookup, codec/cut/chunk state advance, placement
        pricing, then dispatch.  ``idxs`` must be ascending and unique;
        every robot's ``NetworkSim`` conceptually sits at ``tick``
        (bandwidth reads come straight from ``trace_mat``; only streamed
        rows touch their cursor, via ``seek``)."""
        cfg = self.cfg
        if self.scene_mat is not None:
            # before _ensure_batch_state: a due drift replan swaps the
            # plan tables this very batch prices against (the scalar
            # engine replans before pricing the tick's first robot)
            self._maybe_delta_replan(tick)
        bst = self._ensure_batch_state()
        ai = self._arch_idx[idxs]
        if not self._cloud_up:
            # outage fast path: every robot executes edge-only (the
            # scalar branch's ``e + 0.0 + 0.0`` is bitwise ``e``)
            eo = bst["edge_only"][ai]
            rec = self.recorder
            if rec is not None:
                for j in self._tele_want_js(idxs, now):
                    i = int(idxs[j])
                    ev = float(eo[j])
                    tele = self._tele_pred_edge(
                        f"robot:{self.arch_of[i]}", ev)
                    rec.record_request(
                        req=-1, lane=tele["_lane"], t0_s=now,
                        edge_s=ev, uplink_s=0.0, queue_s=0.0,
                        service_s=0.0, down_s=0.0, total_s=ev,
                        pred=tele, outcome="outage", wire_bytes=0.0)
            self._complete_batch(idxs, now, eo)
            self.n_outage_completions += len(idxs)
            return

        bw = self.trace_mat[idxs, tick]
        k = np.searchsorted(self._bw_mid, bw)
        n_v = bst["n"][ai]
        s1p = bst["s1"][ai, k]
        s2p = bst["s2"][ai, k]
        # codec adoption — same gate as _planned_placement: only bins
        # whose plan has a codec-applicable transport leg
        cur = self.codec_of[idxs]
        adopt = (s1p < s2p) & (((0 < s1p) & (s1p < n_v)) | (s2p < n_v))
        ci = np.where(adopt, bst["codec"][ai, k], cur)
        self.n_codec_switches += int(np.count_nonzero(ci != cur))
        self.codec_of[idxs] = ci
        # pool clamps (numpy min/max == Pool.clamp)
        s1 = np.minimum(np.maximum(s1p, self._pool_lo1[idxs]),
                        self._pool_hi1[idxs])
        s2c = np.minimum(np.maximum(s2p, self._pool_lo2[idxs]),
                         self._pool_hi2[idxs])
        s2 = np.where(self._has_pool2[idxs], np.maximum(s1, s2c), n_v)
        moved = ((s1 != self.place_s1[idxs])
                 | (s2 != self.place_s2[idxs]))
        self.n_cut_moves += int(np.count_nonzero(moved))
        self.place_s1[idxs] = s1
        self.place_s2[idxs] = s2
        # chunk state — stream_applies gate, degenerate placements reset
        wire_s1 = bst["W"][ai, s1]
        if cfg.streamed:
            kc = bst["chunks"][ai, k]
            ok = (s1 < s2) & (0 < s1) & (s1 < n_v) & (wire_s1 > 0)
            kc = np.where(ok, kc, 1)
        else:
            kc = np.ones(len(idxs), dtype=np.int64)
        self.n_chunk_reconfigs += int(
            np.count_nonzero(kc != self.chunks_of[idxs]))
        self.chunks_of[idxs] = kc

        # pricing — mirrors latency()/placement_latency() + the 2-cut
        # head/tail shuffle in _robot_step, association order preserved
        Es1 = bst["E"][ai, s1]
        En = bst["E"][ai, n_v]
        Es2 = bst["E"][ai, s2]
        two = s2 < n_v
        collab = s1 < s2
        eh = (Es1 + En) - Es2
        tail = En - Es2
        c2 = bst["C"][ai, s1] - bst["C"][ai, s2]
        tv = self._net_time_vec(wire_s1, bw, ci, (0 < s1) & (s1 < n_v),
                                bst["enc_up"], bst["dec_up"])
        # 2-cut with s1 >= s2 short-circuits before the transport terms
        t = np.where(two & ~collab, 0.0, tv)
        c = np.where(two, np.where(collab, c2, 0.0), bst["C"][ai, s1])
        dn = np.zeros(len(idxs))
        dmask = two & collab & bst["has_down"][ai]
        if dmask.any():
            dnv = self._net_time_vec(
                bst["DW"][ai, s2], bw * cfg.down_bw_factor, ci,
                (0 < s2) & (s2 < n_v), bst["enc_dn"], bst["dec_dn"])
            dn = np.where(dmask, dnv, 0.0)
        e = np.where(two, eh - tail, Es1)
        down = np.where(two, dn + tail, 0.0)

        # measured delta wire factors: the scalar path's exact wire-term
        # correction, vectorized (``+0.0`` on non-delta rows).  Streamed
        # rows are corrected here then overwritten below — value-equal
        # to the scalar if/elif.
        wf_meas = app = None
        if self.scene_mat is not None:
            wf_meas, app = self._delta_uplink_batch(
                idxs, tick, s1, s2, n_v, wire_s1, ci)
            t = t + np.where(app, (wf_meas - bst["wf"][ci]) * wire_s1
                             / bw, 0.0)

        # streamed uplinks price against the per-tick trace — inherently
        # sequential per robot, so scalar in index order
        rec = self.recorder
        bub_of: dict = {}
        if cfg.streamed:
            for j in np.flatnonzero((kc > 1) & (c > 0.0)):
                i = int(idxs[j])
                self.nets[i].seek(tick)
                t[j], bub = self._stream_uplink(
                    i, self.arrays[self.arch_of[i]], int(s1[j]),
                    self.codecs[int(ci[j])], float(e[j]), float(c[j]),
                    wire_factor=(float(wf_meas[j])
                                 if wf_meas is not None and app[j]
                                 else None))
                self.n_streamed_requests += 1
                self._bubble_sum += bub
                if rec is not None:
                    bub_of[int(j)] = bub

        # issue-time telemetry capture (recorder on): the same pred the
        # scalar path builds, from the batch lanes' scalarized values
        tele_of: dict = {}
        if rec is not None:
            for j in self._tele_want_js(idxs, now):
                j = int(j)
                i = int(idxs[j])
                tele = self._tele_pred(
                    f"robot:{self.arch_of[i]}", self.arch_of[i],
                    float(bw[j]), int(s1[j]), int(s2[j]), int(kc[j]),
                    int(ci[j]), float(e[j]), float(c[j]), float(t[j]),
                    float(down[j]),
                    wire_meas_over=(
                        float(wf_meas[j] * wire_s1[j])
                        if wf_meas is not None and app[j] else None))
                tele["_bubble"] = bub_of.get(j)
                tele_of[j] = tele

        # dispatch: cloud work in ascending robot order (work ids, RNG
        # draws and batcher adds replay the scalar sequence), local
        # completions batched
        cloudy = c > 0.0
        if routable:
            for j in np.flatnonzero(cloudy):
                i = int(idxs[j])
                ej, tj, cj = float(e[j]), float(t[j]), float(c[j])
                wid = self._next_wid
                self._next_wid += 1
                tele = tele_of.get(int(j))
                work = _CloudWork(i, now, now + ej + tj, ej, tj, cj,
                                  float(down[j]), bool(two[j]),
                                  pred=tele)
                self._pending[wid] = work
                self.next_free[i] = float("inf")
                if tele is not None and cfg.continuous:
                    rec.cont_open(wid)
                if cfg.continuous:
                    slow = float(np.exp(self.rng.normal(
                        0.0, cfg.straggler_sigma)))
                    if self.rng.random() < cfg.tail_prob:
                        slow *= cfg.tail_scale
                    kvc = self.kv_cumsum[self.arch_of[i]]
                    replica = min(routable, key=lambda r:
                                  self.cbatchers[r].backlog_s)
                    self.cbatchers[replica].add(
                        Request(wid, now + ej + tj, 0), cj * slow,
                        float(kvc[int(s1[j])] - kvc[int(s2[j])]))
                else:
                    replica = self.mitigator.pick_primary(routable)
                    self.batchers[replica].add(
                        Request(wid, now + ej + tj, 0))
                if self._enq is not None:
                    self._enq(replica)
        else:
            for j in np.flatnonzero(cloudy):
                i = int(idxs[j])
                ej, tj = float(e[j]), float(t[j])
                self._fallback_one(_CloudWork(
                    i, now, now + ej + tj, ej, tj, float(c[j]),
                    float(down[j]), bool(two[j]),
                    pred=tele_of.get(int(j))))
        loc = np.flatnonzero(~cloudy)
        if len(loc):
            lat = (e[loc] + t[loc]) + down[loc]
            if rec is not None and tele_of:
                for jj, j in enumerate(loc.tolist()):
                    tele = tele_of.get(j)
                    if tele is not None:
                        rec.record_request(
                            req=-1, lane=tele["_lane"], t0_s=now,
                            edge_s=float(e[j]), uplink_s=float(t[j]),
                            queue_s=0.0, service_s=0.0,
                            down_s=float(down[j]),
                            total_s=float(lat[jj]),
                            enc_s=tele["_enc_s"], dec_s=tele["_dec_s"],
                            pred=tele, outcome="local",
                            wire_bytes=tele["_wire_bytes"])
            self._complete_batch(idxs[loc], now, lat)

    def _drain_dead(self, now: float, routable: List[str]) -> None:
        """Replicas that died with queued work: re-route or fall back."""
        if self.cfg.continuous:
            self._drain_dead_cont(routable)
            return
        for r in self.replica_names:
            if r in self._down and self.batchers[r].queue:
                if routable:
                    for rq in list(self.batchers[r].queue):
                        self.batchers[self.mitigator.pick_primary(
                            routable)].add(rq)
                    self.batchers[r].queue.clear()
                else:
                    batch = self.batchers[r].flush(now)
                    while batch is not None:
                        self._fallback(batch.requests)
                        batch = self.batchers[r].flush(now)

    def _service_replica(self, r: str, end: float,
                         routable: List[str]) -> None:
        """Advance one accepting replica's service to the tick boundary:
        micro-batches form and execute, the continuous tier's event loop
        runs to ``end`` and completions release robots."""
        if self.cfg.continuous:
            for req, fin in self.cbatchers[r].step(end):
                self._finish_cont(req, fin)
        else:
            batch = self.batchers[r].maybe_form(end)
            while batch is not None:
                self._execute(batch.requests, routable)
                batch = self.batchers[r].maybe_form(end)

    def _final_drain(self) -> None:
        """Drain whatever is still queued at the end of the run."""
        cfg = self.cfg
        end = cfg.n_ticks * cfg.tick_s
        routable = [r for r in self.replica_names if r not in self._down]
        if cfg.continuous:
            self._drain_dead_cont(routable)
            for r in routable:
                for req, fin in self.cbatchers[r].step(None):
                    self._finish_cont(req, fin)
        else:
            for r in self.replica_names:
                batch = self.batchers[r].flush(end)
                while batch is not None:
                    if routable:
                        self._execute(batch.requests, routable)
                    else:
                        self._fallback(batch.requests)
                    batch = self.batchers[r].flush(end)

    # ------------------------------------------------------------------ run
    def run(self) -> FleetReport:
        cfg = self.cfg
        if cfg.engine == "events":
            from .events import EventEngine   # lazy: avoids import cycle
            return EventEngine(self).run()
        if cfg.engine != "ticks":
            raise ValueError(f"unknown engine {cfg.engine!r} "
                             "(expected 'ticks' or 'events')")
        if cfg.arrival_processes:
            raise ValueError("arrival_processes require engine='events' "
                             "(the tick loop has no sub-tick arrivals)")
        if cfg.autoscale:
            raise ValueError("autoscale requires engine='events'")
        return self._run_ticks()

    def _run_ticks(self) -> FleetReport:
        """The historical dense per-tick loop: every robot and replica is
        visited every tick.  Kept as the parity oracle for the event
        engine — and still the simplest thing to read when tracing a
        small run by hand."""
        cfg = self.cfg
        events = sorted(cfg.replica_events)
        ei = 0
        for tick in range(cfg.n_ticks):
            now = tick * cfg.tick_s
            while ei < len(events) and events[ei].tick <= tick:
                ev = events[ei]
                (self._down.add if ev.kind == "leave"
                 else self._down.discard)(ev.replica)
                ei += 1
            for r in self.replica_names:
                if r not in self._down:
                    self.pool.heartbeat(r, now)
            # control plane: heartbeat-timeout view (drives replan())
            live = self.pool.live(now)
            # data plane: fail-fast — connections to a dead replica error
            # immediately, before the heartbeat timeout notices
            routable = [r for r in live if r not in self._down]

            # ---- robots take one control step each (closed loop: a robot
            # issues its next observation once the previous action returned)
            for i in range(cfg.n_robots):
                if now < self.next_free[i]:
                    self.nets[i].step()         # link evolves every tick
                    continue                    # previous request in flight
                self._robot_step(i, now, routable)

            self._drain_dead(now, routable)

            # ---- form + execute batches per accepting replica
            end = now + cfg.tick_s
            for r in routable:
                self._service_replica(r, end, routable)

        self._final_drain()
        return self._report()

    # --------------------------------------------------------------- report
    def _report(self) -> FleetReport:
        cfg = self.cfg
        robots = []
        for i, lats in enumerate(self.latencies):
            xs = np.asarray(lats if lats else [0.0])
            robots.append(RobotStats(
                name=f"robot{i:03d}", arch=self.arch_of[i],
                n_requests=len(lats), mean_s=float(xs.mean()),
                p50_s=float(np.percentile(xs, 50)),
                p95_s=float(np.percentile(xs, 95)),
                codec=self.codecs[self.codec_of[i]].name,
                n_chunks=int(self.chunks_of[i])))
        allx = np.asarray([x for lats in self.latencies for x in lats]
                          or [0.0])
        sim_s = cfg.n_ticks * cfg.tick_s
        cbs = list(self.cbatchers.values())
        n_cont_done = sum(cb.n_completed for cb in cbs)
        procs = []
        for p, proc in enumerate(cfg.arrival_processes):
            lats = self.proc_latencies[p]
            ys = np.asarray(lats if lats else [0.0])
            procs.append(ProcessStats(
                name=proc.name, kind=proc.kind,
                n_arrivals=self.proc_arrivals[p],
                n_completed=len(lats),
                n_rejected=self.proc_rejections[p],
                mean_s=float(ys.mean()),
                p50_s=float(np.percentile(ys, 50)),
                p95_s=float(np.percentile(ys, 95)),
                p99_s=float(np.percentile(ys, 99)),
                p999_s=float(np.percentile(ys, 99.9))))
        metrics = None
        if self.recorder is not None:
            # mirror the report-level counters into gauges so a metrics
            # consumer never needs the dataclass, then snapshot
            m = self.recorder.metrics
            m.set_gauge("fleet/p95_s", float(np.percentile(allx, 95)))
            m.set_gauge("fleet/n_hedged", self.n_hedged)
            m.set_gauge("fleet/n_replans", self.n_replans)
            m.set_gauge("fleet/n_preemptions",
                        sum(cb.n_preempted for cb in cbs))
            m.set_gauge("fleet/kv_high_watermark_bytes", max(
                (cb.kv_high_watermark_bytes for cb in cbs), default=0.0))
            metrics = self.recorder.snapshot()
        return FleetReport(
            robots=robots, n_requests=int(sum(r.n_requests for r in robots)),
            fleet_p50_s=float(np.percentile(allx, 50)),
            fleet_p95_s=float(np.percentile(allx, 95)),
            throughput_rps=float(len(allx) / sim_s) if sim_s else 0.0,
            n_hedged=self.n_hedged, n_replans=self.n_replans,
            n_outage_completions=self.n_outage_completions,
            n_codec_switches=self.n_codec_switches,
            n_cut_moves=self.n_cut_moves,
            n_multicut_requests=self.n_multicut_requests,
            n_chunk_reconfigs=self.n_chunk_reconfigs,
            n_streamed_requests=self.n_streamed_requests,
            mean_bubble_frac=(self._bubble_sum / self.n_streamed_requests
                              if self.n_streamed_requests else 0.0),
            n_preemptions=int(sum(cb.n_preempted for cb in cbs)),
            mean_queue_delay_s=(sum(cb.queue_delay_sum_s for cb in cbs)
                                / max(1, n_cont_done)),
            kv_high_watermark_bytes=max(
                (cb.kv_high_watermark_bytes for cb in cbs), default=0.0),
            fleet_p99_s=float(np.percentile(allx, 99)),
            fleet_p999_s=float(np.percentile(allx, 99.9)),
            processes=tuple(procs),
            n_open_arrivals=int(sum(self.proc_arrivals)),
            n_slo_rejections=int(sum(self.proc_rejections)),
            n_autoscale_events=self.n_autoscale,
            metrics=metrics,
            total_wire_bytes=float(self.wire_bytes_of.sum()),
            n_keyframes=self.n_keyframes,
            n_delta_frames=self.n_delta_frames,
            n_ref_evictions=self.n_ref_evictions,
            n_delta_replans=self.n_delta_replans)


def run_fleet(cfg: FleetConfig) -> FleetReport:
    """Convenience one-shot: build a ``FleetSimulator`` and run it."""
    return FleetSimulator(cfg).run()
