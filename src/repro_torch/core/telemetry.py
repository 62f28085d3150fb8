"""Flight-recorder telemetry: spans, streaming metrics, drift audit.

The port's own copy of ``src/repro/core/telemetry.py``: the same code,
held equal to the reference by ``tests/test_torch_telemetry.py``, plus the
stage spans of the split executors (``stage``, ``FlightRecorder.open_run``),
which the reference does not have.

Zero-overhead-when-off observability for the fleet simulator
(``runtime/fleet.py``).  The design splits cleanly into three layers:

* **Span tracing** — every recorded request decomposes into typed stage
  spans (edge compute, encode/wire/decode of the uplink, cloud queue
  wait, batched service, downlink + edge tail) on per-cohort and
  per-replica lanes.  Span groups are held in a bounded ``Reservoir``
  (Algorithm R beyond the cap), so a 100k-robot run stays inside a fixed
  memory budget; ``runtime/trace_export.py`` renders the kept groups as
  Chrome trace-event JSON viewable in Perfetto.
* **Metrics registry** — counters, gauges and streaming quantile
  sketches (``QuantileSketch``, a t-digest-style fixed-size centroid
  merge: tails keep near-singleton resolution, the middle compresses)
  instead of full latency lists; the fleet report exposes one
  ``snapshot()`` dict.
* **Drift audit** — the planner's predicted stage decomposition
  (``evaluate_placement`` / ``stream_makespan`` / ``queue_delay_s``
  terms, captured at issue time) is joined against the measured spans at
  completion into per-stage signed-error sketches, plus an exact
  reconciliation check: the measured stages of every joined request must
  re-sum to its reported latency (``reconcile_max_abs_s``).

Stages of the executors (``stage``): the program's own time, split into
nested stages.  With a recorder, a stage is timed by two CUDA events on
the card (no synchronisation: the span resolves once the device has passed
its end) or by the host clock on the CPU; while ``torch.profiler`` records,
it is also a FUNCTION-scope range ``roboecc.<name>`` on the profiler's
own clock, so that the device trace can say which stage the host was in;
with neither, it costs one check of the profiler's state and one ``is
None``.

Determinism contract: the recorder NEVER touches the simulator's RNG —
the reservoir keeps its own ``random.Random`` and the sampling decision
is a pure hash of the request key (robot index × issue tick), so
recorder-off runs are bit-identical to a build without telemetry and
recorder-on runs never perturb the simulation's draw order
(tests/test_engine_parity.py pins both).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import random
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast

__all__ = [
    "Span", "Reservoir", "QuantileSketch", "MetricsRegistry",
    "DriftAudit", "FlightRecorder", "ContObserver", "DRIFT_STAGES",
    "stage", "RANGE_PREFIX",
]

# the host clock of spans timed on the CPU
_now = time.perf_counter
_profiler_enabled = torch.autograd._profiler_enabled
# the profiler's name of a stage: RANGE_PREFIX + the span's name
RANGE_PREFIX = "roboecc."


# ------------------------------------------------------------------- spans
@dataclasses.dataclass(frozen=True)
class Span:
    """One timed stage on one lane.  ``lane`` names the track the span
    renders on (``robot:<arch>`` cohorts, ``replica:<name>``,
    ``proc:<process>``, ``executor:<tier>``); ``req`` ties the stages of
    one request together across lanes (-1 = unaffiliated; an executor's
    co-inference takes the run number ``FlightRecorder.open_run`` hands
    out).  ``parent`` names the enclosing span of a stage nested inside
    another, which lies on its parent's lane ("" = none).

    The fleet simulator's spans are in its model time.  An executor's
    stages timed on the CPU are ``perf_counter`` readings; those timed on
    the card by CUDA events lie on the device's timeline: ``dur_s`` is the
    time between the two events, and ``t0_s`` the start event's time
    after the run's first event plus the host time at which that first
    event was recorded."""
    name: str                 # stage kind: "edge", "uplink", "queue", ...
    cat: str                  # trace category: "request", "cloud", "wall"
    t0_s: float
    dur_s: float
    lane: str
    req: int = -1
    parent: str = ""


# --------------------------------------------------------------- reservoir
class Reservoir:
    """Bounded uniform sample of an unbounded stream (Algorithm R).

    The first ``cap`` offers are kept verbatim; beyond that each new item
    replaces a random kept one with probability ``cap / n_seen`` — every
    item in the stream ends up kept with equal probability, with memory
    pinned at ``cap``.  Uses its OWN ``random.Random(seed)`` so offering
    never perturbs any simulation RNG."""

    def __init__(self, cap: int, seed: int = 0):
        if cap < 1:
            raise ValueError("reservoir cap must be >= 1")
        self.cap = int(cap)
        self.n_seen = 0
        self._rng = random.Random(seed)
        self._items: List = []

    def offer(self, item) -> bool:
        """Offer one item; returns True when it was kept."""
        self.n_seen += 1
        if len(self._items) < self.cap:
            self._items.append(item)
            return True
        j = self._rng.randrange(self.n_seen)
        if j < self.cap:
            self._items[j] = item
            return True
        return False

    @property
    def items(self) -> List:
        return self._items

    def __len__(self) -> int:
        return len(self._items)


# ---------------------------------------------------------- quantile sketch
class QuantileSketch:
    """Fixed-size streaming quantile estimator (merging t-digest).

    Values buffer until ``max_centroids`` are pending, then merge into
    weighted centroids under the arcsine scale function
    ``k(q) = δ/(2π) · asin(2q − 1)``: adjacent items merge while their
    combined quantile range spans less than one k-unit, so the tails
    stay near-singleton (p99.9 keeps resolution) while the middle
    compresses.  ``k`` spans δ/2 units over [0, 1], which hard-caps the
    merged centroid count at ``δ/2 + 2`` — memory is O(max_centroids)
    regardless of stream length.  No RNG, so identical streams give
    identical sketches."""

    def __init__(self, max_centroids: int = 128):
        self.max_centroids = max(8, int(max_centroids))
        self._cent: List[Tuple[float, float]] = []   # (mean, weight) sorted
        self._buf: List[float] = []
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def add(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        self._buf.append(x)
        if len(self._buf) >= self.max_centroids:
            self._compress()

    def extend(self, xs: Sequence[float]) -> None:
        for x in xs:
            self.add(x)

    def _k(self, q: float) -> float:
        return self.max_centroids / (2.0 * math.pi) \
            * math.asin(2.0 * min(1.0, max(0.0, q)) - 1.0)

    def _compress(self) -> None:
        items = self._cent + [(x, 1.0) for x in self._buf]
        self._buf = []
        if not items:
            return
        items.sort(key=lambda mw: mw[0])
        total = sum(w for _, w in items)
        out: List[Tuple[float, float]] = []
        cum = 0.0                      # weight strictly before the open centroid
        k_lo = self._k(0.0)
        c_sum, c_w = items[0][0] * items[0][1], items[0][1]
        for m, w in items[1:]:
            if self._k((cum + c_w + w) / total) - k_lo > 1.0:
                out.append((c_sum / c_w, c_w))
                cum += c_w
                k_lo = self._k(cum / total)
                c_sum, c_w = 0.0, 0.0
            c_sum += m * w
            c_w += w
        out.append((c_sum / c_w, c_w))
        self._cent = out

    @property
    def n_centroids(self) -> int:
        return len(self._cent) + len(self._buf)

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (0 <= q <= 1) by linear interpolation
        across centroid midpoints, anchored at the exact min/max."""
        if self.count == 0:
            return math.nan
        self._compress()
        cents = self._cent
        if q <= 0.0:
            return self.min
        if q >= 1.0:
            return self.max
        target = q * self.count
        # midpoint positions: centroid i sits at cum_before + w_i / 2
        pts = [(0.0, self.min)]
        cum = 0.0
        for m, w in cents:
            pts.append((cum + w / 2.0, m))
            cum += w
        pts.append((float(self.count), self.max))
        for k in range(1, len(pts)):
            p1, v1 = pts[k]
            if target <= p1:
                p0, v0 = pts[k - 1]
                if p1 <= p0:
                    return v1
                f = (target - p0) / (p1 - p0)
                return v0 + f * (v1 - v0)
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def snapshot(self) -> Dict[str, float]:
        if self.count == 0:
            return {"n": 0}
        return {"n": self.count, "min": self.min, "max": self.max,
                "mean": self.mean, "p50": self.quantile(0.50),
                "p95": self.quantile(0.95), "p99": self.quantile(0.99)}


# --------------------------------------------------------- metrics registry
class MetricsRegistry:
    """Counters, gauges and streaming histograms behind string names.
    Replaces ad-hoc per-metric plumbing: a new measurement is one
    ``observe()`` call, not a new report field."""

    def __init__(self, max_centroids: int = 128):
        self._max_centroids = max_centroids
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, QuantileSketch] = {}

    def inc(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = QuantileSketch(self._max_centroids)
        h.add(value)

    def snapshot(self) -> dict:
        return {
            "counters": {k: self.counters[k] for k in sorted(self.counters)},
            "gauges": {k: self.gauges[k] for k in sorted(self.gauges)},
            "hists": {k: self.hists[k].snapshot()
                      for k in sorted(self.hists)},
        }


# -------------------------------------------------------------- drift audit
# Stage keys of the planner's predicted decomposition and the measured
# one.  The seconds-stages MUST re-sum to the reported request latency
# (reconciliation below); the unit-suffixed extras ride alongside.
DRIFT_STAGES = ("edge_s", "uplink_s", "queue_s", "service_s", "down_s",
                "total_s")
DRIFT_EXTRAS = ("wire_bytes", "bubble_frac")


class DriftAudit:
    """Predicted-vs-measured per-stage signed error distributions.

    ``join(pred, meas)`` takes the stage decomposition the planner
    priced at issue time and the stages the runtime actually measured,
    and feeds ``measured - predicted`` into one sketch per stage — a
    standing, regression-checked version of the M/G/1-vs-reality
    experiments.  Every join also re-sums the measured seconds-stages
    against ``meas["total_s"]`` (the latency the fleet reported) and
    tracks the worst absolute mismatch: a drifted *model* is expected,
    a drifted *accounting identity* is a bug."""

    def __init__(self, max_centroids: int = 128):
        self.err: Dict[str, QuantileSketch] = {
            k: QuantileSketch(max_centroids)
            for k in DRIFT_STAGES + DRIFT_EXTRAS}
        self.n_joined = 0
        self.n_pred_saturated = 0      # P-K prior hit rho >= 1 (wait = inf)
        self.reconcile_max_abs_s = 0.0

    def join(self, pred: dict, meas: dict) -> None:
        self.n_joined += 1
        for k in DRIFT_STAGES + DRIFT_EXTRAS:
            if k in pred and k in meas:
                self.err[k].add(float(meas[k]) - float(pred[k]))
        recon = float(abs((meas["edge_s"] + meas["uplink_s"]
                           + meas["queue_s"] + meas["service_s"]
                           + meas["down_s"]) - meas["total_s"]))
        if recon > self.reconcile_max_abs_s:
            self.reconcile_max_abs_s = recon

    def summary(self) -> dict:
        stages = {}
        for k in DRIFT_STAGES + DRIFT_EXTRAS:
            sk = self.err[k]
            if sk.count == 0:
                continue
            stages[k] = {"n": sk.count, "mean_err": sk.mean,
                         "p50_err": sk.quantile(0.50),
                         "p95_err": sk.quantile(0.95)}
        return {"n_joined": self.n_joined,
                "n_pred_saturated": self.n_pred_saturated,
                "reconcile_max_abs_s": self.reconcile_max_abs_s,
                "stages": stages}


# ---------------------------------------------------------- flight recorder
_HASH_KNUTH = 2654435761     # Fibonacci-hash multiplier for key sampling


class FlightRecorder:
    """The fleet's flight recorder; ``None`` on the simulator means off.

    ``mode="full"`` records every request; ``mode="sampled"`` records a
    deterministic ~``1/sample_every`` subset chosen by hashing the
    request key (robot index and issue tick — NOT arrival order, so the
    sampled set is identical whichever engine or batching path replays
    the run).  Span groups are reservoir-bounded at ``cap``; metrics and
    drift sketches are O(1) memory either way.

    The split executors record their stages here (``open_run``, then
    ``stage``): one group per tier, the tier's span followed by the stages
    nested in it, whatever the sampling mode.  A group timed by CUDA events
    stays pending until the device has passed its last event: the next
    ``open_run`` keeps those whose end event has completed, and reading
    ``spans`` keeps every pending group, waiting for the device where need
    be.  So no synchronisation enters the executor's path."""

    def __init__(self, mode: str = "sampled", cap: int = 65536,
                 sample_every: int = 64, seed: int = 0,
                 max_centroids: int = 128):
        if mode not in ("sampled", "full"):
            raise ValueError(f"telemetry mode {mode!r} "
                             "(expected 'sampled' or 'full')")
        self.mode = mode
        self.sample_every = max(1, int(sample_every))
        self.metrics = MetricsRegistry(max_centroids)
        self.drift = DriftAudit(max_centroids)
        self._spans = Reservoir(cap, seed=seed * 0x9E3779B1 + 1)
        self.n_recorded = 0
        # continuous-tier per-request state fed by ContObserver
        self._cont: Dict[int, dict] = {}
        # the executors' stages: the open run, closed groups not yet kept
        self._run: Optional[_Run] = None
        self._pending: collections.deque = collections.deque()
        self._n_runs = 0

    @property
    def spans(self) -> Reservoir:
        """The kept span groups, every pending stage group included."""
        self._keep_pending(wait=True)
        return self._spans

    # ------------------------------------------------------------ sampling
    def want(self, key: int) -> bool:
        """Record this request?  Pure function of the request key, so the
        decision is independent of event replay order."""
        if self.mode == "full":
            return True
        h = (key * _HASH_KNUTH) & 0xFFFFFFFF
        return h % self.sample_every == 0

    # ----------------------------------------------------- continuous hooks
    def cont_open(self, rid: int) -> None:
        """Register a sampled continuous-tier request: only opened rids
        accumulate observer state, so unsampled traffic costs the
        observer a single failed dict lookup per event."""
        self._cont[rid] = {"queue_s": 0.0, "spans": [],
                           "replica": None, "preempts": 0}

    def cont_admit(self, rid: int, wait_s: float, now_s: float,
                   kv_reserved: float, replica: str) -> None:
        st = self._cont.get(rid)
        if st is None:
            return
        st["queue_s"] += wait_s
        st["replica"] = replica
        st["spans"].append(Span("kv_admit", "cloud", now_s, 0.0,
                                f"replica:{replica}", rid))
        self.metrics.observe("cloud/kv_admit_wait_s", wait_s)
        self.metrics.observe("cloud/kv_reserved_bytes", kv_reserved)

    def cont_preempt(self, rid: int, now_s: float, replica: str) -> None:
        st = self._cont.get(rid)
        if st is None:
            return
        st["preempts"] += 1
        st["spans"].append(Span("preempt", "cloud", now_s, 0.0,
                                f"replica:{replica}", rid))
        self.metrics.inc("cloud/preemptions")

    def pop_cont(self, rid: int) -> Optional[dict]:
        return self._cont.pop(rid, None)

    # ------------------------------------------------------------ recording
    def record_span(self, span: Span) -> None:
        """Offer one free-standing span to the reservoir."""
        self._spans.offer([span])

    def record_request(self, *, req: int, lane: str, t0_s: float,
                       edge_s: float, uplink_s: float, queue_s: float,
                       service_s: float, down_s: float, total_s: float,
                       replica: Optional[str] = None,
                       enc_s: float = 0.0, dec_s: float = 0.0,
                       pred: Optional[dict] = None,
                       extra_spans: Sequence[Span] = (),
                       outcome: str = "ok",
                       wire_bytes: Optional[float] = None,
                       bubble_frac: Optional[float] = None) -> None:
        """Fold one completed request: build its stage spans, feed the
        metrics sketches, and (when the issue-time prediction rode along)
        join the drift audit.  The five stage durations are the exact
        addends of the latency the fleet reported — reconciliation in
        ``DriftAudit.join`` holds by construction."""
        self.n_recorded += 1
        m = self.metrics
        m.inc("requests/total")
        m.inc(f"requests/{outcome}")
        m.observe("latency/total_s", total_s)
        m.observe("latency/edge_s", edge_s)
        m.observe("latency/uplink_s", uplink_s)
        m.observe("latency/queue_s", queue_s)
        m.observe("latency/service_s", service_s)
        if down_s:
            m.observe("latency/down_s", down_s)

        group: List[Span] = []
        t = t0_s
        if edge_s > 0.0:
            group.append(Span("edge", "request", t, edge_s, lane, req))
        t += edge_s
        if uplink_s > 0.0:
            # encode/decode sub-spans when the codec costs are known;
            # the wire span is the remainder of the uplink leg
            if enc_s > 0.0:
                group.append(Span("encode", "request", t, enc_s, lane, req))
            wire = max(0.0, uplink_s - enc_s - dec_s)
            group.append(Span("uplink", "request", t + enc_s, wire,
                              lane, req))
            if dec_s > 0.0:
                group.append(Span("decode", "request",
                                  t + enc_s + wire, dec_s, lane, req))
        t += uplink_s
        rlane = f"replica:{replica}" if replica is not None else lane
        if queue_s > 0.0:
            group.append(Span("queue", "cloud", t, queue_s, rlane, req))
        t += queue_s
        if service_s > 0.0:
            group.append(Span("service", "cloud", t, service_s, rlane, req))
        t += service_s
        if down_s > 0.0:
            group.append(Span("downlink", "request", t, down_s, lane, req))
        group.extend(extra_spans)
        self._spans.offer(group)

        if pred is not None:
            self.drift.join(pred, {
                "edge_s": edge_s, "uplink_s": uplink_s, "queue_s": queue_s,
                "service_s": service_s, "down_s": down_s, "total_s": total_s,
                **({"wire_bytes": wire_bytes} if wire_bytes is not None
                   else {}),
                **({"bubble_frac": bubble_frac} if bubble_frac is not None
                   else {}),
            })

    # ------------------------------------------------------ executor stages
    def open_run(self, device, numbered: bool = True) -> None:
        """Start one co-inference's stages on ``device``: timed by CUDA
        events on its current stream on the card, by the host clock on the
        CPU.  Keeps the pending groups whose device work has completed.
        ``numbered`` hands the run the next run number as its spans'
        ``req``; without it they keep -1, as the reference's executor
        spans do."""
        self._keep_pending(wait=False)
        req = -1
        if numbered:
            req = self._n_runs
            self._n_runs += 1
        stream = torch.cuda.current_stream(device) \
            if torch.device(device).type == "cuda" else None
        self._run = _Run(req, stream)

    def _mark(self, run: "_Run"):
        """A stage boundary: a CUDA event recorded on the run's stream, or
        a host clock reading."""
        if run.stream is None:
            return _now()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(run.stream)
        if run.anchor is None:
            run.anchor = (_now(), ev)
        return ev

    def _open(self, name: str, lane: str) -> None:
        run = self._run
        if run is None:
            raise RuntimeError(f"stage {name!r} outside a run: call "
                               "open_run first")
        stack = run.stack
        # a stage that follows its sibling starts where the sibling ended
        if run.last is not None and run.last[0] == len(stack):
            start = run.last[1]
        else:
            start = self._mark(run)
        run.last = None
        if stack:
            parent, lane = stack[-1][0], stack[-1][2]
        else:
            parent, run.group = "", []
        entry = [name, parent, lane, start, None]
        run.group.append(entry)
        stack.append(entry)

    def _close(self) -> None:
        run = self._run
        entry = run.stack.pop()
        entry[4] = self._mark(run)
        run.last = (len(run.stack), entry[4])
        if not run.stack:
            self._pending.append((run.req, run.anchor, run.group))
            run.group = None
            if run.stream is None:
                self._keep_pending(wait=False)

    def _keep_pending(self, wait: bool) -> None:
        """Offer the pending stage groups, in order, to the reservoir: all
        of them with ``wait``, else those whose last event has completed."""
        while self._pending:
            req, anchor, group = self._pending[0]
            end = group[0][4]           # the tier's span closes last
            if not isinstance(end, float) and not end.query():
                if not wait:
                    return
                end.synchronize()
            self._pending.popleft()
            spans = []
            for name, parent, lane, start, stop in group:
                t0 = _at(anchor, start)
                spans.append(Span(name, "executor", t0,
                                  _at(anchor, stop) - t0, lane, req, parent))
            self._spans.offer(spans)

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        return {"mode": self.mode,
                "n_recorded": self.n_recorded,
                "spans": {"kept": len(self.spans),
                          "seen": self._spans.n_seen,
                          "cap": self._spans.cap},
                "metrics": self.metrics.snapshot(),
                "drift": self.drift.summary()}


# ---------------------------------------------------------- executor stages
@dataclasses.dataclass
class _Run:
    """One co-inference's stages while it runs: its number, the stream its
    events go on (``None``: the host clock), the host time and event of
    its first event, the stages open, the group of the open tier, and the
    depth and mark of the stage that closed last."""
    req: int
    stream: Optional[object]
    anchor: Optional[tuple] = None
    stack: list = dataclasses.field(default_factory=list)
    group: Optional[list] = None
    last: Optional[tuple] = None


def _at(anchor: Optional[tuple], mark) -> float:
    """A stage boundary's time: a host clock reading as it is; an event's
    from the run's first event, so that a boundary two stages share reads
    the same in both."""
    if anchor is None:
        return mark
    return anchor[0] + anchor[1].elapsed_time(mark) * 1e-3


_OFF = contextlib.nullcontext()          # the stage that nothing records


class _Stage:
    """A stage a recorder times, and a profiler range while one records."""
    __slots__ = ("recorder", "name", "lane", "range")

    def __init__(self, recorder: FlightRecorder, name: str, lane: str):
        self.recorder, self.name, self.lane = recorder, name, lane
        self.range = None

    def __enter__(self):
        if _profiler_enabled():
            self.range = _RecordFunctionFast(RANGE_PREFIX + self.name)
            self.range.__enter__()
        self.recorder._open(self.name, self.lane)

    def __exit__(self, *exc):
        self.recorder._close()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def stage(name: str, recorder: Optional[FlightRecorder] = None,
          lane: str = ""):
    """A context manager around one stage of the program.

    With ``recorder`` (inside its ``open_run``) the stage becomes a span:
    on ``lane`` for a tier's span, on its parent's lane (``lane`` unused)
    for a stage nested in another.  While ``torch.profiler`` records, it is also a
    FUNCTION-scope range named ``RANGE_PREFIX + name``, which has no
    device-side twin in the trace (``record_function``'s USER_SCOPE range
    has one).  With neither, it costs one check of the profiler's state
    and one ``is None``: no event, no clock, no range."""
    if recorder is None:
        if not _profiler_enabled():
            return _OFF
        return _RecordFunctionFast(RANGE_PREFIX + name)
    return _Stage(recorder, name, lane)


# -------------------------------------------------------- batcher observer
class ContObserver:
    """Per-replica adapter between ``runtime/scheduler.ContinuousBatcher``
    and the recorder: the batcher only knows request ids and its own
    clock, the observer adds the replica identity and forwards admission
    waits / KV reservations / preemptions.  Attached by the fleet only
    when the recorder is on — a ``None`` observer costs the batcher one
    attribute check per event."""

    def __init__(self, recorder: FlightRecorder, replica: str):
        self.recorder = recorder
        self.replica = replica

    def on_admit(self, rid: int, wait_s: float, now_s: float,
                 kv_reserved: float) -> None:
        self.recorder.cont_admit(rid, wait_s, now_s, kv_reserved,
                                 self.replica)

    def on_preempt(self, rid: int, now_s: float) -> None:
        self.recorder.cont_preempt(rid, now_s, self.replica)
