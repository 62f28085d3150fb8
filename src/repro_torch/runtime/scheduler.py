"""Serving scheduler: request batching, straggler hedging, elastic replicas.

The port's own copy of ``src/repro/runtime/scheduler.py``: the same code
(standard library only), held equal to the reference by
``tests/test_torch_lm_runtime.py``.  ``launch/serve.py`` uses
``MicroBatcher``, ``Request`` and ``StragglerMitigator``; the rest serves
the fleet stack when it is carried.

* ``MicroBatcher`` — admission queue -> fixed-size decode batches with a
  deadline; late requests ride the next batch (continuous batching lite).
* ``StragglerMitigator`` — per-replica latency EWMA + p95; hedges a request
  to the second-best replica when the primary exceeds its hedge deadline
  (tail-at-scale).  The paper's edge/cloud tiers are just two replicas here.
* ``ElasticPool`` — replicas join/leave; on loss of the edge tier the
  RoboECC controller's ``replan()`` degrades to cloud-only (split=0), on
  re-join it re-runs Alg. 1.
* ``ContinuousBatcher`` — vLLM-style continuous batching with KV-budget
  preemption; ``AutoScaler`` — reactive replica autoscaling.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Request:
    rid: int
    arrival_s: float
    prompt_len: int
    max_new: int = 16


@dataclasses.dataclass
class Batch:
    requests: List[Request]
    formed_s: float


class MicroBatcher:
    def __init__(self, batch_size: int, max_wait_s: float):
        self.batch_size = batch_size
        self.max_wait_s = max_wait_s
        self.queue: deque[Request] = deque()

    def add(self, req: Request) -> None:
        self.queue.append(req)

    def maybe_form(self, now_s: float) -> Optional[Batch]:
        if not self.queue:
            return None
        oldest = self.queue[0].arrival_s
        if (len(self.queue) >= self.batch_size
                or now_s - oldest >= self.max_wait_s):
            return self.flush(now_s)
        return None

    def flush(self, now_s: float) -> Optional[Batch]:
        """Drain up to one batch regardless of size/deadline (used at tick
        boundaries and on replica teardown; call repeatedly to empty)."""
        if not self.queue:
            return None
        take = [self.queue.popleft()
                for _ in range(min(self.batch_size, len(self.queue)))]
        return Batch(take, now_s)


class LatencyStats:
    """EWMA mean + streaming p95 over a sliding window."""

    def __init__(self, alpha: float = 0.2, window: int = 64):
        self.alpha = alpha
        self.mean: Optional[float] = None
        self.samples: deque = deque(maxlen=window)

    def observe(self, s: float) -> None:
        self.mean = s if self.mean is None else \
            (1 - self.alpha) * self.mean + self.alpha * s
        self.samples.append(s)

    def p95(self) -> float:
        if not self.samples:
            return float("inf")
        xs = sorted(self.samples)
        return xs[min(len(xs) - 1, int(0.95 * len(xs)))]


@dataclasses.dataclass
class HedgeOutcome:
    replica: str
    latency_s: float
    hedged: bool
    winner: str


class StragglerMitigator:
    def __init__(self, hedge_quantile: float = 0.95):
        self.stats: Dict[str, LatencyStats] = defaultdict(LatencyStats)
        self.hedge_quantile = hedge_quantile

    def pick_primary(self, replicas: List[str]) -> str:
        def key(r):
            m = self.stats[r].mean
            return m if m is not None else 0.0
        return min(replicas, key=key)

    def run(self, replicas: List[str],
            exec_fn: Callable[[str], float]) -> HedgeOutcome:
        """exec_fn(replica) -> latency seconds (simulated or measured).
        Hedge: if primary exceeds its p95, launch on backup; winner = min."""
        primary = self.pick_primary(replicas)
        t_primary = exec_fn(primary)
        deadline = self.stats[primary].p95()
        hedged, winner, lat = False, primary, t_primary
        if t_primary > deadline and len(replicas) > 1:
            backup = self.pick_primary([r for r in replicas if r != primary])
            t_backup_exec = exec_fn(backup)
            t_backup = deadline + t_backup_exec  # hedge fires at deadline
            hedged = True
            # the backup's own service time is a real observation too —
            # without it the backup keeps mean=None (scored 0.0 by
            # pick_primary) and hedge targets are chosen on no data
            self.stats[backup].observe(t_backup_exec)
            if t_backup < t_primary:
                winner, lat = backup, t_backup
        self.stats[primary].observe(t_primary)
        return HedgeOutcome(primary, lat, hedged, winner)


@dataclasses.dataclass
class _ContItem:
    """A queued request: full (re)compute cost + final KV footprint."""
    req: Request
    service_s: float
    kv_bytes: float
    wait_from: float            # queue-delay clock start (arrival/preempt)


@dataclasses.dataclass
class _ContSlot:
    """An in-flight request occupying one batch slot."""
    item: _ContItem
    remaining_s: float          # service-seconds of work left
    admit_s: float
    kv_reserved: float          # bytes pinned at admission


class ContinuousBatcher:
    """Continuous batching with KV-budget preemption (event-driven).

    Requests carry a *service time* (full solo execution cost, seconds)
    and a *KV footprint* (bytes held once the request's cache is fully
    materialized).  The batcher runs an exact event loop:

    * k in-flight slots share the replica; batching efficiency follows
      the fleet's micro-batch cost model — a k-batch costs
      ``eff(k) = 1 + (k - 1) * (1 - batch_overlap)`` times one request,
      so each slot drains ``dt / eff(k)`` service-seconds per wall
      second.
    * A slot's KV occupancy ramps linearly from a reserved fraction
      (``kv_admit_frac * kv_bytes``, pinned at admission) to its full
      footprint as the request progresses — the prefill writes cache as
      it runs.
    * When aggregate occupancy would cross ``kv_budget_bytes``, the
      YOUNGEST preemptable slot (never slot 0 — guaranteed progress) is
      evicted back to the front of the queue with its full service time
      restored (preempt-with-recompute, as in vLLM's recompute policy).
    * Admission is FIFO and happens only at arrival / completion /
      horizon events, never at budget-crossing events, which bounds the
      event count and rules out admit/preempt livelock.

    Counters (``n_admitted`` / ``n_completed`` / ``n_preempted`` /
    ``kv_high_watermark_bytes`` / ``queue_delay_sum_s``) feed the fleet
    report's queue metrics.
    """

    _EPS = 1e-12

    def __init__(self, max_slots: int, kv_budget_bytes: float, *,
                 batch_overlap: float = 0.8, kv_admit_frac: float = 0.25):
        self.max_slots = max(1, int(max_slots))
        self.kv_budget_bytes = float(kv_budget_bytes)
        self.batch_overlap = batch_overlap
        self.kv_admit_frac = min(1.0, max(0.0, kv_admit_frac))
        self.queue: deque[_ContItem] = deque()
        self.slots: List[_ContSlot] = []    # admission order: oldest first
        self.now_s = 0.0
        self.n_admitted = 0
        self.n_completed = 0
        self.n_preempted = 0
        self.kv_high_watermark_bytes = 0.0
        self.queue_delay_sum_s = 0.0
        # optional telemetry observer (core/telemetry.ContObserver):
        # on_admit(rid, wait_s, now_s, kv_reserved) / on_preempt(rid,
        # now_s) fire on admission and KV-budget eviction.  None (the
        # default) costs one attribute check per event and changes no
        # scheduling behavior.
        self.observer = None

    # ------------------------------------------------------------- model
    def _eff(self, k: int) -> float:
        if k <= 1:
            return 1.0
        return 1.0 + (k - 1) * (1.0 - self.batch_overlap)

    def _slot_occupancy(self, s: _ContSlot) -> float:
        frac_done = 1.0 - s.remaining_s / s.item.service_s
        return s.kv_reserved + (s.item.kv_bytes - s.kv_reserved) * frac_done

    def occupancy_bytes(self) -> float:
        return sum(self._slot_occupancy(s) for s in self.slots)

    @property
    def backlog_s(self) -> float:
        """Outstanding service-seconds (in-flight + queued) — the fleet's
        least-loaded routing metric."""
        return (sum(s.remaining_s for s in self.slots)
                + sum(it.service_s for it in self.queue))

    def __len__(self) -> int:
        return len(self.slots) + len(self.queue)

    # ------------------------------------------------------------- input
    def add(self, req: Request, service_s: float, kv_bytes: float) -> None:
        item = _ContItem(req, max(service_s, self._EPS), float(kv_bytes),
                         wait_from=max(req.arrival_s, self.now_s))
        self.queue.append(item)

    def _admit(self) -> None:
        """FIFO admission while a slot and budget headroom exist.  When
        the machine is idle the head is admitted unconditionally — a
        request whose reservation alone exceeds the budget must still
        run (solo) or the queue deadlocks."""
        while self.queue and len(self.slots) < self.max_slots:
            head = self.queue[0]
            if head.req.arrival_s > self.now_s + self._EPS:
                break                        # not here yet (future arrival)
            res = self.kv_admit_frac * head.kv_bytes
            if self.slots and \
                    self.occupancy_bytes() + res > self.kv_budget_bytes + 1e-9:
                break                        # no headroom: FIFO blocks
            self.queue.popleft()
            self.slots.append(_ContSlot(head, head.service_s, self.now_s,
                                        res))
            self.n_admitted += 1
            self.queue_delay_sum_s += self.now_s - head.wait_from
            if self.observer is not None:
                self.observer.on_admit(head.req.rid,
                                       self.now_s - head.wait_from,
                                       self.now_s, res)

    # -------------------------------------------------------------- loop
    def step(self, until_s: Optional[float] = None
             ) -> List[Tuple[Request, float]]:
        """Advance the event loop to ``until_s`` (or to quiescence when
        ``None``).  Returns ``[(request, finish_s)]`` completions."""
        horizon = float("inf") if until_s is None else float(until_s)
        done: List[Tuple[Request, float]] = []
        self._admit()
        while True:
            k = len(self.slots)
            eff = self._eff(k)
            occ = self.occupancy_bytes()
            self.kv_high_watermark_bytes = max(
                self.kv_high_watermark_bytes, occ)

            t_done = min((s.remaining_s for s in self.slots),
                         default=float("inf")) * eff + self.now_s
            t_arr = float("inf")
            if self.queue and self.queue[0].req.arrival_s > self.now_s:
                t_arr = self.queue[0].req.arrival_s
            # budget crossing: occupancy grows at sum((kv-res)/service)/eff
            t_cross = float("inf")
            preemptable = [i for i in range(1, k)
                           if self.slots[i].item.kv_bytes > 0]
            if preemptable:
                rate = sum((s.item.kv_bytes - s.kv_reserved)
                           / s.item.service_s for s in self.slots) / eff
                if occ >= self.kv_budget_bytes - 1e-9:
                    t_cross = self.now_s
                elif rate > 0:
                    t_cross = self.now_s \
                        + (self.kv_budget_bytes - occ) / rate

            t_next = min(t_done, t_arr, t_cross, horizon)
            if t_next == float("inf"):
                break
            dt = t_next - self.now_s
            if dt > 0:
                for s in self.slots:
                    s.remaining_s = max(0.0, s.remaining_s - dt / eff)
                self.now_s = t_next
                self.kv_high_watermark_bytes = max(
                    self.kv_high_watermark_bytes, self.occupancy_bytes())

            finished = [s for s in self.slots if s.remaining_s <= self._EPS]
            if finished:
                for s in finished:
                    self.slots.remove(s)
                    self.n_completed += 1
                    done.append((s.item.req, self.now_s))
                self._admit()                # freed slot + KV headroom
                continue
            if self.now_s >= horizon:
                self._admit()                # same-instant arrivals
                break
            if t_next == t_cross:
                # evict the youngest preemptable slot; its cache is
                # dropped, so the full service time is restored.  NO
                # admission here — re-admission waits for the next
                # arrival/completion event, which bounds the event count
                # (<= k-1 preemptions between admission events).
                victim = self.slots.pop(preemptable[-1])
                victim.item.wait_from = self.now_s
                self.queue.appendleft(victim.item)
                self.n_preempted += 1
                if self.observer is not None:
                    self.observer.on_preempt(victim.item.req.rid,
                                             self.now_s)
                continue
            self._admit()                    # arrival event
        return done

    # ---------------------------------------------------------- teardown
    def drain(self) -> List[Tuple[Request, float, float]]:
        """Evict everything (replica death).  Returns
        ``[(request, service_s, kv_bytes)]`` — in-flight slots first
        (their work is lost; full recompute), then the queue in order."""
        out = [(s.item.req, s.item.service_s, s.item.kv_bytes)
               for s in self.slots]
        out += [(it.req, it.service_s, it.kv_bytes) for it in self.queue]
        self.slots.clear()
        self.queue.clear()
        return out


@dataclasses.dataclass
class AutoScaler:
    """Reactive replica autoscaling on backlog pressure.

    A deliberately simple hysteresis policy (the point of the event
    engine is to make policies like this *measurable* at 10k-robot
    scale, not to bake in a clever one): scale up one replica when the
    mean backlog per routable replica exceeds ``high_s`` seconds, scale
    down one when it falls below ``low_s``, never leaving the
    ``[min_replicas, max_replicas]`` band.  ``decide`` is pure — the
    caller (``runtime/events.EventEngine``) owns the replica set and
    applies the returned delta as synthetic join/leave transitions, so
    the policy composes with scheduled ``ReplicaEvent`` chaos and the
    ``ElasticPool`` heartbeat-timeout view without special cases."""
    min_replicas: int = 1
    max_replicas: int = 8
    high_s: float = 0.25
    low_s: float = 0.02

    def decide(self, n_live: int, mean_backlog_s: float) -> int:
        """Return the replica delta in {-1, 0, +1} for this control step."""
        if n_live < self.min_replicas:
            return 1
        if mean_backlog_s > self.high_s and n_live < self.max_replicas:
            return 1
        if mean_backlog_s < self.low_s and n_live > self.min_replicas:
            return -1
        return 0


class ElasticPool:
    """Tracks live replicas via heartbeats; triggers replan callbacks."""

    def __init__(self, on_change: Optional[Callable[[List[str]], None]] = None,
                 timeout_s: float = 1.0):
        self.last_beat: Dict[str, float] = {}
        self.timeout_s = timeout_s
        self.on_change = on_change
        self._live: List[str] = []

    def heartbeat(self, replica: str, now_s: float) -> None:
        self.last_beat[replica] = now_s
        self._refresh(now_s)

    def _refresh(self, now_s: float) -> None:
        live = sorted(r for r, t in self.last_beat.items()
                      if now_s - t <= self.timeout_s)
        if live != self._live:
            self._live = live
            if self.on_change:
                self.on_change(live)

    def live(self, now_s: float) -> List[str]:
        self._refresh(now_s)
        return list(self._live)
