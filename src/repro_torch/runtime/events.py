"""Event-driven fleet engine: the sparse, scale-out replay of the tick loop.

The port's own copy of ``src/repro/runtime/events.py``: the same code
(numpy only), importing from ``repro_torch`` only, held equal to the
reference by ``tests/test_torch_fleet.py`` and
``tests/test_torch_fleet_engines.py``.

The historical ``FleetSimulator._run_ticks`` loop visits every robot and
replica every tick — at 10k+ robots that is hundreds of millions of
Python iterations, almost all of which do nothing (a busy robot's only
per-tick work is advancing its link cursor).  ``EventEngine`` replaces
the dense scan with a single binary heap of **(tick, phase, idx)** keys
and visits a robot exactly when it has a control step to take:

* robot wake-ups are computed from each completion (``_complete`` fires
  the ``_wake`` hook instead of being polled), with the wake tick found
  by the same float comparison the tick loop would have made;
* per-robot ``NetworkSim`` cursors are positioned absolutely
  (``NetworkSim.seek``) instead of stepped once per tick;
* the ``ElasticPool`` heartbeat-timeout view is tracked analytically:
  live-set changes can only happen at tick 0, at replica join/leave
  ticks and at heartbeat-expiry ticks, so those are the only ticks a
  POOL event recomputes the live list (and fires the fleet's
  ``_on_replicas`` replan callback on change, exactly as the dense
  heartbeat loop would);
* micro-batch formation is driven by enqueue events plus the exact
  batch-age deadline tick; the continuous tier's replicas chain one
  SERVICE event per routable replica per tick (replica count, not robot
  count — the cheap dimension), which keeps every ``ContinuousBatcher``
  clock at the same boundary the tick loop would have stepped it to.

**Parity contract** (tests/test_engine_parity.py): with no open-loop
traffic the engine produces a ``FleetReport`` that is dataclass-EQUAL to
the tick loop's across the {micro, continuous} x {streamed, plain} x
{single-cut, multi-cut} matrix, outage schedules included.  The proof
strategy is structural: every phase body lives once in
``runtime/fleet.py`` (``_robot_step`` / ``_drain_dead`` /
``_service_replica`` / ``_final_drain``) and the heap's total order
replays the tick loop's phase order — REPLICA < POOL < ROBOT < ARRIVAL
< DRAIN < SERVICE < SCALE within a tick, robot index and replica rank
within a phase — so the same RNG draws happen in the same sequence.

Beyond parity, the engine adds what the tick loop cannot express:

* **open-loop arrival processes** (``fleet.ArrivalProcess``): Poisson
  and diurnally-modulated request streams with their own seeded traces
  and RNGs, pre-generated vectorized and replayed as ARRIVAL events;
* **SLO admission control** (``FleetConfig.slo_s``): arrivals whose
  estimated cloud wait exceeds the SLO are rejected to edge-only
  execution and counted;
* **replica autoscaling** (``scheduler.AutoScaler``): SCALE events
  compare backlog pressure against watermarks and apply synthetic
  join/leave transitions through the same pool machinery as scheduled
  chaos events.
"""
from __future__ import annotations

import bisect
import heapq
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from .fleet import FleetSimulator, _CloudWork
from .scheduler import AutoScaler, Request

# phase order within a tick — mirrors the tick loop's A..E sections
PH_REPLICA = 0       # scheduled/synthetic replica leave/join application
PH_POOL = 1          # heartbeat/live-set recomputation (replans fire here)
PH_ROBOT = 2         # closed-loop robot control steps, by robot index
PH_ARRIVAL = 3       # open-loop arrivals, by global arrival sequence
PH_DRAIN = 4         # dead-replica queue drain
PH_SERVICE = 5       # batch formation / continuous event loop, by replica
PH_SCALE = 6         # autoscaler decision


class EventHeap:
    """Binary heap over ``(tick, phase, idx)`` with a push-sequence
    tiebreak (equal keys pop in insertion order; the engine's handlers
    are idempotent under duplicates, so the tiebreak is about
    determinism, not correctness).  ``validate=True`` checks the
    nondecreasing-pop invariant on every pop."""

    def __init__(self, validate: bool = False):
        self._h: List[Tuple[int, int, int, int]] = []
        self._seq = 0
        self.validate = validate
        self.n_pushed = 0
        self.n_popped = 0
        self._last_key: Optional[Tuple[int, int, int]] = None

    def __len__(self) -> int:
        return len(self._h)

    def push(self, tick: int, phase: int, idx: int) -> None:
        heapq.heappush(self._h, (tick, phase, idx, self._seq))
        self._seq += 1
        self.n_pushed += 1

    def peek(self) -> Optional[Tuple[int, int, int]]:
        return self._h[0][:3] if self._h else None

    def pop(self) -> Tuple[int, int, int]:
        tick, phase, idx, _ = heapq.heappop(self._h)
        self.n_popped += 1
        if self.validate:
            key = (tick, phase, idx)
            if self._last_key is not None and key < self._last_key:
                raise AssertionError(
                    f"heap popped {key} after {self._last_key}")
            self._last_key = key
        return tick, phase, idx


def _poisson_times(rng: np.random.Generator, rate_hz: float,
                   horizon_s: float) -> np.ndarray:
    """Vectorized homogeneous-Poisson arrival times on [0, horizon)."""
    block = max(16, int(rate_hz * horizon_s * 1.2) + 16)
    t = np.cumsum(rng.exponential(1.0 / rate_hz, block))
    while t[-1] < horizon_s:
        t = np.concatenate(
            [t, t[-1] + np.cumsum(rng.exponential(1.0 / rate_hz, block))])
    return t[t < horizon_s]


def generate_arrivals(cfg) -> List[Tuple[float, int]]:
    """Pre-generate every open-loop arrival as ``(time_s, process_idx)``,
    globally time-sorted.  Poisson streams are exponential-gap cumsums;
    diurnal streams thin a peak-rate stream against the sinusoidal
    intensity ``rate * (1 + amp * sin(2*pi*t/period))``.  Each process
    draws from its own seeded generator, so traffic mixes are
    reproducible and adding a process never disturbs another."""
    horizon = cfg.n_ticks * cfg.tick_s
    out: List[Tuple[float, int]] = []
    for p, proc in enumerate(cfg.arrival_processes):
        rate = float(proc.rate_hz)
        if rate <= 0.0 or horizon <= 0.0:
            continue
        rng = np.random.default_rng(cfg.seed * 1_000_003 + 7919 * (p + 1))
        if proc.kind == "poisson":
            ts = _poisson_times(rng, rate, horizon)
        elif proc.kind == "diurnal":
            lam_max = rate * (1.0 + abs(proc.diurnal_amp))
            ts = _poisson_times(rng, lam_max, horizon)
            lam_t = rate * (1.0 + proc.diurnal_amp * np.sin(
                2.0 * np.pi * ts / proc.diurnal_period_s))
            ts = ts[rng.random(len(ts)) * lam_max < lam_t]
        else:
            raise ValueError(f"unknown arrival kind {proc.kind!r}")
        out.extend((float(t), p) for t in ts)
    out.sort()
    return out


class EventEngine:
    """Runs a ``FleetSimulator`` off an event heap.  Construct with the
    simulator (fresh — one engine per run) and call ``run()``;
    ``validate=True`` turns on the heap/state invariant assertions used
    by the property tests (nondecreasing pops, a robot never acts while
    a request is in flight, replica slot/KV capacity respected)."""

    def __init__(self, sim: FleetSimulator, validate: bool = False):
        self.sim = sim
        self.cfg = sim.cfg
        self.validate = validate
        self.heap = EventHeap(validate=validate)
        # vectorized ROBOT phase: same-tick robot wake-ups collect into
        # per-tick index buckets (one PH_ROBOT marker event per tick)
        # and run as one ``_robot_step_batch``; ``vectorized=False``
        # keeps the per-robot heap entries and the scalar ``_robot_step``
        # as the parity oracle
        self.vectorized = bool(self.cfg.vectorized)
        self._wake_buckets: Dict[int, List[np.ndarray]] = {}
        # replica rank = position in the SORTED name list: the tick loop
        # services `for r in routable` where routable inherits the
        # ElasticPool's sorted order, so heap idx must rank the same way
        self._names_sorted = sorted(sim.replica_names)
        self._rank = {r: k for k, r in enumerate(self._names_sorted)}
        # analytic ElasticPool view
        self.prev_live: List[str] = []       # == ElasticPool._live init
        self.routable: List[str] = []
        self.last_beat_tick: Dict[str, int] = {}
        self.up_since: Dict[str, int] = {r: 0 for r in sim.replica_names}
        # dedupe sets so duplicate (tick, idx) work items stay O(1)
        self._svc_sched: set = set()
        self._pool_sched: set = set()
        self._drain_sched: set = set()
        self._cur_tick = 0
        self._rev = sorted(self.cfg.replica_events)
        # open-loop traffic
        self._arrivals = generate_arrivals(self.cfg)
        self._proc_nets = []
        self._proc_rng = []
        for p, proc in enumerate(self.cfg.arrival_processes):
            from ..core.network import NetworkSim, generate_trace
            # a process may carry its own regional bandwidth regime
            # (ArrivalProcess.trace); None inherits the fleet-wide one
            tr = proc.trace if proc.trace is not None else self.cfg.trace
            self._proc_nets.append(NetworkSim(
                generate_trace(self.cfg.n_ticks + 1, tr,
                               seed=(self.cfg.seed * 100_003
                                     + self.cfg.n_robots + p)),
                tick_s=self.cfg.tick_s, rtt_s=self.cfg.rtt_s))
            self._proc_rng.append(np.random.default_rng(
                self.cfg.seed * 1_000_003 + 7919 * (p + 1) + 1))
        self.scaler: Optional[AutoScaler] = None
        if self.cfg.autoscale:
            mx = (self.cfg.autoscale_max
                  if self.cfg.autoscale_max is not None
                  else self.cfg.n_replicas)
            self.scaler = AutoScaler(
                min_replicas=self.cfg.autoscale_min, max_replicas=mx,
                high_s=self.cfg.autoscale_high_s,
                low_s=self.cfg.autoscale_low_s)

    # ------------------------------------------------------- tick algebra
    # All tick computations replicate the tick loop's float comparisons
    # exactly: compute a fast first guess, then adjust with the SAME
    # expressions (`t * tick_s`, `tick * tick_s + tick_s`) the dense loop
    # evaluates, so rounding never shifts an event across a tick edge.

    def _tick_at_or_after(self, t_s: float) -> int:
        """Smallest tick t with ``t * tick_s >= t_s`` — the first tick at
        which the tick loop would see ``now >= t_s``."""
        ts = self.cfg.tick_s
        t = int(math.ceil(t_s / ts))
        while t * ts < t_s:
            t += 1
        while t > 0 and (t - 1) * ts >= t_s:
            t -= 1
        return t

    def _expiry_tick(self, beat_tick: int) -> int:
        """First tick at which a beat at ``beat_tick`` has timed out of
        the ElasticPool view (``now - beat > timeout`` with the pool's
        ``<=`` liveness comparison)."""
        ts = self.cfg.tick_s
        timeout = self.cfg.heartbeat_timeout_s
        beat_s = beat_tick * ts
        t = beat_tick + max(1, int(timeout / ts))
        while t - 1 > beat_tick and (t - 1) * ts - beat_s > timeout:
            t -= 1
        while t * ts - beat_s <= timeout:
            t += 1
        return t

    def _deadline_tick(self, oldest_s: float, cur_tick: int) -> int:
        """First tick whose service boundary trips the micro-batch age
        trigger: smallest m with ``(m*tick_s + tick_s) - oldest >= wait``
        (the exact ``maybe_form`` comparison at ``end = now + tick_s``)."""
        ts = self.cfg.tick_s
        wait = self.cfg.batch_wait_s
        m = max(cur_tick,
                int(math.floor((oldest_s + wait) / ts)) - 2)
        while m * ts + ts - oldest_s < wait:
            m += 1
        return m

    # --------------------------------------------------------- scheduling
    def _push_pool(self, tick: int) -> None:
        if tick < self.cfg.n_ticks and tick not in self._pool_sched:
            self._pool_sched.add(tick)
            self.heap.push(tick, PH_POOL, 0)

    def _push_drain(self, tick: int) -> None:
        if tick < self.cfg.n_ticks and tick not in self._drain_sched:
            self._drain_sched.add(tick)
            self.heap.push(tick, PH_DRAIN, 0)

    def _push_service(self, tick: int, replica: str) -> None:
        key = (tick, self._rank[replica])
        if tick < self.cfg.n_ticks and key not in self._svc_sched:
            self._svc_sched.add(key)
            self.heap.push(tick, PH_SERVICE, key[1])

    def _note_enqueue(self, replica: str) -> None:
        """``FleetSimulator._enq`` hook: cloud work landed on a replica
        during the current tick — make sure it gets a service pass."""
        self._push_service(self._cur_tick, replica)

    def _bucket_add(self, tick: int, idx: np.ndarray) -> None:
        """Collect woken robot indices into the tick's bucket; the FIRST
        insert for a tick pushes one PH_ROBOT marker event (idx 0) that
        triggers the whole batch.  Wake-ups always target strictly future
        ticks, so a popped bucket's tick can never be re-entered."""
        parts = self._wake_buckets.get(tick)
        if parts is None:
            self._wake_buckets[tick] = [idx]
            self.heap.push(tick, PH_ROBOT, 0)
        else:
            parts.append(idx)

    def _wake_robot(self, i: int) -> None:
        """``FleetSimulator._complete`` hook: the robot's closed loop is
        released at ``next_free``; schedule its next control step at the
        first tick the dense loop would have found it free (never before
        the next tick — this tick's robot phase has already run)."""
        t = max(self._cur_tick + 1,
                self._tick_at_or_after(float(self.sim.next_free[i])))
        if t < self.cfg.n_ticks:
            if self.vectorized:
                self._bucket_add(t, np.asarray([i], dtype=np.int64))
            else:
                self.heap.push(t, PH_ROBOT, i)

    def _wake_robots(self, idx: np.ndarray) -> None:
        """``FleetSimulator._complete_batch`` hook: vectorized
        ``_wake_robot`` over a completion batch.  The wake tick replays
        ``_tick_at_or_after``'s ceil-then-adjust float comparisons
        elementwise, so no robot shifts across a tick edge relative to
        the scalar path."""
        ts = self.cfg.tick_s
        nf = self.sim.next_free[idx]
        t = np.ceil(nf / ts).astype(np.int64)
        while True:
            m = t.astype(np.float64) * ts < nf
            if not m.any():
                break
            t[m] += 1
        while True:
            m = (t > 0) & ((t - 1).astype(np.float64) * ts >= nf)
            if not m.any():
                break
            t[m] -= 1
        t = np.maximum(t, self._cur_tick + 1)
        keep = t < self.cfg.n_ticks
        if not keep.all():
            t, idx = t[keep], idx[keep]
        if not len(t):
            return
        order = np.argsort(t, kind="stable")
        t, idx = t[order], idx[order]
        uniq, starts = np.unique(t, return_index=True)
        bounds = list(starts[1:]) + [len(t)]
        for k, tk in enumerate(uniq):
            self._bucket_add(int(tk), idx[int(starts[k]):int(bounds[k])])

    def _schedule_initial(self) -> None:
        cfg, heap = self.cfg, self.heap
        self._push_pool(0)
        if self.vectorized:
            self._bucket_add(0, np.arange(cfg.n_robots, dtype=np.int64))
        else:
            for i in range(cfg.n_robots):
                heap.push(0, PH_ROBOT, i)
        for pos, ev in enumerate(self._rev):
            t = max(0, ev.tick)      # the tick loop applies tick<=0 at 0
            if t < cfg.n_ticks:
                heap.push(t, PH_REPLICA, pos)
        for k, (t_arr, _p) in enumerate(self._arrivals):
            tk = min(cfg.n_ticks - 1, int(t_arr / cfg.tick_s))
            heap.push(tk, PH_ARRIVAL, k)
        if cfg.continuous:
            # continuous batcher clocks advance every tick they are
            # routable (exactly like the dense loop), so seed the
            # per-replica service chain at tick 0
            for r in self.sim.replica_names:
                self._push_service(0, r)
        if self.scaler is not None:
            for t in range(cfg.autoscale_every, cfg.n_ticks,
                           cfg.autoscale_every):
                heap.push(t, PH_SCALE, 0)

    # ----------------------------------------------------------- liveness
    def _is_live(self, r: str, now: float) -> bool:
        if r not in self.sim._down:
            return True              # beats this tick
        lb = self.last_beat_tick.get(r)
        if lb is None:
            return False             # never heartbeated: not in the pool
        return now - lb * self.cfg.tick_s <= self.cfg.heartbeat_timeout_s

    def _refresh_pool_view(self, tick: int) -> None:
        """POOL event: recompute the sorted live list the ElasticPool
        would report this tick and fire the fleet's replan callback on
        change — then refresh the fail-fast routable view."""
        sim = self.sim
        now = tick * self.cfg.tick_s
        live = [r for r in self._names_sorted if self._is_live(r, now)]
        if live != self.prev_live:
            sim._on_replicas(live)
            self.prev_live = live
        self.routable = [r for r in live if r not in sim._down]

    def _apply_leave(self, r: str, tick: int) -> None:
        sim = self.sim
        if r in sim._down:
            return                   # already down: idempotent
        if tick - 1 >= self.up_since.get(r, 0) and tick >= 1:
            self.last_beat_tick[r] = tick - 1
        sim._down.add(r)
        lb = self.last_beat_tick.get(r)
        if lb is not None:
            self._push_pool(self._expiry_tick(lb))
        self._push_pool(tick)
        self._push_drain(tick)

    def _apply_join(self, r: str, tick: int) -> None:
        sim = self.sim
        if r not in sim._down:
            return
        sim._down.discard(r)
        self.up_since[r] = tick
        self._push_pool(tick)
        if self.cfg.continuous:
            self._push_service(tick, r)   # resume the clock chain

    # ------------------------------------------------------ open arrivals
    def _est_wait_s(self, now_s: float) -> float:
        """Cheapest-replica wait estimate for SLO admission: continuous
        replicas expose outstanding service-seconds directly, the micro
        tier's proxy is the busy-until horizon."""
        sim = self.sim
        if self.cfg.continuous:
            return min(sim.cbatchers[r].backlog_s for r in self.routable)
        return min(max(0.0, sim.busy_until[r] - now_s)
                   for r in self.routable)

    def _handle_arrival(self, tick: int, k: int) -> None:
        sim, cfg = self.sim, self.cfg
        t_arr, p = self._arrivals[k]
        proc = cfg.arrival_processes[p]
        sim.proc_arrivals[p] += 1
        arrays = sim.arrays[proc.arch]
        n = arrays.n
        edge_only = float(arrays.edge_s[n])
        # telemetry sampling key: arrival sequence index offset past the
        # robot id space — engine-order-independent like the robot keys
        rec = sim.recorder
        lane = f"proc:{proc.name}"
        want = (rec is not None
                and rec.want((cfg.n_robots + 1 + p) * 1_000_003 + k))
        if not sim._cloud_up or not self.routable:
            if want:
                rec.record_request(
                    req=-1, lane=lane, t0_s=t_arr, edge_s=edge_only,
                    uplink_s=0.0, queue_s=0.0, service_s=0.0, down_s=0.0,
                    total_s=edge_only,
                    pred=sim._tele_pred_edge(lane, edge_only),
                    outcome="outage", wire_bytes=0.0)
            sim.proc_latencies[p].append(edge_only)
            return
        net = self._proc_nets[p]
        net.seek(tick)
        bw = net.now_bps if proc.bw_bps is None else float(proc.bw_bps)
        kidx = bisect.bisect_left(sim._bw_mid_list, bw)
        s1 = int(sim.plan[proc.arch][kidx])
        s2 = int(sim.plan_s2[proc.arch][kidx])
        ci = int(sim.plan_codec[proc.arch][kidx])
        cdc = sim.codecs[ci]
        down_s, two_cut = 0.0, False
        if s2 < n:
            eh, c, t, dn = arrays.placement_latency(
                s1, s2, bw, cfg.rtt_s, codec=cdc,
                down_bw_factor=cfg.down_bw_factor)
            tail = float(arrays.edge_s[n] - arrays.edge_s[s2])
            e = eh - tail
            down_s = dn + tail
            two_cut = True
        else:
            e, c, t = arrays.latency(s1, bw, cfg.rtt_s, codec=cdc)
        tele = None
        if want:
            tele = sim._tele_pred(lane, proc.arch, bw, s1, s2, 1, ci,
                                  e, c, t, down_s)
        if c <= 0.0:
            lat = e + t + down_s
            if want:
                rec.record_request(
                    req=-1, lane=lane, t0_s=t_arr, edge_s=e, uplink_s=t,
                    queue_s=0.0, service_s=0.0, down_s=down_s,
                    total_s=lat, enc_s=tele["_enc_s"],
                    dec_s=tele["_dec_s"], pred=tele, outcome="local",
                    wire_bytes=tele["_wire_bytes"])
            sim.proc_latencies[p].append(lat)
            return
        if cfg.slo_s is not None and self._est_wait_s(t_arr) > cfg.slo_s:
            # SLO admission: the cloud cannot meet the deadline — serve
            # the whole model on the edge instead of joining the queue
            sim.proc_rejections[p] += 1
            if want:
                # measured = the edge-only fallback; predicted = the
                # split the planner wanted — the drift IS the rejection
                rec.record_request(
                    req=-1, lane=lane, t0_s=t_arr, edge_s=edge_only,
                    uplink_s=0.0, queue_s=0.0, service_s=0.0, down_s=0.0,
                    total_s=edge_only, pred=tele, outcome="slo_reject",
                    wire_bytes=0.0)
            sim.proc_latencies[p].append(edge_only)
            return
        wid = sim._next_wid
        sim._next_wid += 1
        sim._pending[wid] = _CloudWork(-1, t_arr, t_arr + e + t, e, t, c,
                                       down_s, two_cut, proc=p, pred=tele)
        if tele is not None and cfg.continuous:
            rec.cont_open(wid)
        if cfg.continuous:
            rng = self._proc_rng[p]
            slow = float(np.exp(rng.normal(0.0, cfg.straggler_sigma)))
            if rng.random() < cfg.tail_prob:
                slow *= cfg.tail_scale
            kvc = sim.kv_cumsum[proc.arch]
            replica = min(self.routable,
                          key=lambda r: sim.cbatchers[r].backlog_s)
            sim.cbatchers[replica].add(Request(wid, t_arr + e + t, 0),
                                       c * slow, float(kvc[s1] - kvc[s2]))
        else:
            replica = sim.mitigator.pick_primary(self.routable)
            sim.batchers[replica].add(Request(wid, t_arr + e + t, 0))
        self._push_service(tick, replica)

    # --------------------------------------------------------- autoscaling
    def _handle_scale(self, tick: int) -> None:
        sim, cfg = self.sim, self.cfg
        now = tick * cfg.tick_s
        if self.routable:
            if cfg.continuous:
                bl = [sim.cbatchers[r].backlog_s for r in self.routable]
            else:
                bl = [max(0.0, sim.busy_until[r] - now)
                      for r in self.routable]
            n_live, mean_bl = len(self.routable), sum(bl) / len(bl)
        else:
            n_live, mean_bl = 0, 0.0
        delta = self.scaler.decide(n_live, mean_bl)
        if delta > 0:
            spares = [r for r in sim.replica_names if r in sim._down]
            if spares:
                r = spares[0]
                sim._down.discard(r)
                self.up_since[r] = tick + 1   # starts beating next tick
                sim.n_autoscale += 1
                self._push_pool(tick + 1)
                if cfg.continuous:
                    self._push_service(tick + 1, r)
        elif delta < 0 and self.routable:
            r = self.routable[-1]
            # it heartbeated through this tick; down from the next
            self.last_beat_tick[r] = tick
            sim._down.add(r)
            sim.n_autoscale += 1
            self._push_pool(self._expiry_tick(tick))
            self._push_pool(tick + 1)
            self._push_drain(tick + 1)

    # ---------------------------------------------------------------- run
    def run(self):
        sim, cfg = self.sim, self.cfg
        heap = self.heap
        n_ticks = cfg.n_ticks
        tick_s = cfg.tick_s
        sim._wake = self._wake_robot
        sim._wake_batch = self._wake_robots if self.vectorized else None
        sim._enq = self._note_enqueue
        try:
            self._schedule_initial()
            while len(heap) and heap.peek()[0] < n_ticks:
                tick, phase, idx = heap.pop()
                self._cur_tick = tick
                if phase == PH_ROBOT:
                    now = tick * tick_s
                    if self.vectorized:
                        parts = self._wake_buckets.pop(tick, None)
                        if parts is None:
                            continue    # marker raced an emptied bucket
                        idxs = (parts[0] if len(parts) == 1
                                else np.concatenate(parts))
                        idxs = np.sort(idxs)
                        free = now >= sim.next_free[idxs]
                        if not free.all():
                            if self.validate:
                                raise AssertionError(
                                    f"{int((~free).sum())} robots woken "
                                    f"busy at tick {tick}")
                            idxs = idxs[free]   # stale wake: skip
                        if self.validate:
                            assert len(np.unique(idxs)) == len(idxs)
                        if len(idxs):
                            sim._robot_step_batch(idxs, tick, now,
                                                  self.routable)
                        continue
                    if now < sim.next_free[idx]:
                        if self.validate:
                            raise AssertionError(
                                f"robot {idx} woken at tick {tick} while "
                                f"busy until {sim.next_free[idx]}")
                        continue     # stale wake: defensive skip
                    sim.nets[idx].seek(tick)
                    sim._robot_step(idx, now, self.routable)
                elif phase == PH_SERVICE:
                    self._svc_sched.discard((tick, idx))
                    r = self._names_sorted[idx]
                    if r not in self.routable:
                        continue
                    end = tick * tick_s + tick_s   # == the loop's now+tick_s
                    sim._service_replica(r, end, self.routable)
                    if self.validate and cfg.continuous:
                        cb = sim.cbatchers[r]
                        assert len(cb.slots) <= cb.max_slots
                        assert (cb.occupancy_bytes()
                                <= cb.kv_budget_bytes + 1e-6)
                    if cfg.continuous:
                        self._push_service(tick + 1, r)
                    else:
                        q = sim.batchers[r].queue
                        if q:
                            m = self._deadline_tick(q[0].arrival_s, tick)
                            self._push_service(m, r)
                elif phase == PH_ARRIVAL:
                    self._handle_arrival(tick, idx)
                elif phase == PH_POOL:
                    self._pool_sched.discard(tick)
                    self._refresh_pool_view(tick)
                elif phase == PH_REPLICA:
                    ev = self._rev[idx]
                    if ev.kind == "leave":
                        self._apply_leave(ev.replica, tick)
                    else:
                        self._apply_join(ev.replica, tick)
                elif phase == PH_DRAIN:
                    self._drain_sched.discard(tick)
                    sim._drain_dead(tick * tick_s, self.routable)
                    # re-routed work needs a same-tick service pass
                    for r in self.routable:
                        pending = (len(sim.cbatchers[r]) if cfg.continuous
                                   else len(sim.batchers[r].queue))
                        if pending:
                            self._push_service(tick, r)
                else:                # PH_SCALE
                    self._handle_scale(tick)
        finally:
            sim._wake = None
            sim._wake_batch = None
            sim._enq = None
        sim._final_drain()
        if self.validate:
            assert not sim._pending, (
                f"{len(sim._pending)} requests leaked past the horizon")
        return sim._report()
