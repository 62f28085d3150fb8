"""Network bandwidth simulation (paper §III-B setting).

The port's own copy of ``src/repro/core/network.py``: the same code,
importing from ``repro_torch`` only, held equal to the reference by
``tests/test_torch_control.py``.

A Markov-modulated bandwidth process with AR(1) noise, diurnal drift and
random congestion spikes — the "internet bandwidth fluctuations" RoboECC
must adapt to.  Traces are seeded + reproducible; units are BYTES/s.

``generate_trace`` is fully vectorized: all randomness is drawn in bulk
up front (three streams, in a fixed documented order), the rare
regime-flip events are walked directly instead of ticking a Python loop,
and the AR(1) noise is a truncated-kernel convolution (``rho**k`` decays
below double precision after a few hundred lags, so the truncation is
invisible).  Reproducibility contract: same ``(n_steps, cfg, seed)`` →
bit-identical trace, pinned by the seed-0 regression test in
``tests/test_pipeline.py``.

``NetworkSim`` answers two kinds of transfer query: ``transfer_s`` prices
a whole payload at the *current tick's* bandwidth (the historical model —
fine for sub-tick transfers, wrong for transfers spanning hundreds of
ticks at ``tick_s=0.05``), and ``transfer_trace_s`` integrates the trace
tick-by-tick (consume bytes at each tick's rate, clamp to the last sample
past the trace end) — the honest price for long/streamed transfers, used
by ``runtime/fleet.py`` for chunked uplinks.
"""
from __future__ import annotations

import dataclasses
from bisect import bisect_left
from typing import Iterable, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    mean_bps: float = 10e6          # 10 MB/s (paper Fig. 3 "good" regime)
    bad_bps: float = 1e6            # 1 MB/s (paper Fig. 3 degraded regime)
    p_degrade: float = 0.02         # per-step regime transitions
    p_recover: float = 0.15
    ar_rho: float = 0.9             # AR(1) smoothness
    ar_sigma: float = 0.08          # relative noise
    spike_prob: float = 0.01        # sudden congestion dips
    spike_depth: float = 0.25
    diurnal_amp: float = 0.15
    diurnal_period: int = 2_000
    floor_bps: float = 0.05e6


def _regime_chain(u: np.ndarray, p_degrade: float, p_recover: float
                  ) -> np.ndarray:
    """2-state Markov regime from one bulk uniform stream, walked by
    *transition events* instead of per-tick: from the good state the next
    flip is the first draw ``< p_degrade``; from the bad state the first
    draw ``< p_recover`` recovers.  Iterations = number of regime
    switches (a few % of the ticks), each a sorted-list bisect (cheaper
    than a ``np.searchsorted`` call per flip when traces are generated by
    the hundred-thousand for fleet matrices)."""
    n = len(u)
    bad = np.zeros(n, dtype=bool)
    idx_deg = np.flatnonzero(u < p_degrade).tolist()
    idx_rec = np.flatnonzero(u < p_recover).tolist()
    n_deg, n_rec = len(idx_deg), len(idx_rec)
    t, is_bad = 0, False
    while t < n:
        if not is_bad:
            j = bisect_left(idx_deg, t)
            if j == n_deg:
                break                       # good to the end
            tg = idx_deg[j]
            bad[tg] = True                  # flip lands on its own tick
            t, is_bad = tg + 1, True
        else:
            j = bisect_left(idx_rec, t)
            if j == n_rec:
                bad[t:] = True              # bad to the end
                break
            tr = idx_rec[j]
            bad[t:tr] = True                # recovery tick is good again
            t, is_bad = tr + 1, False
    return bad


def generate_trace(n_steps: int, cfg: Optional[TraceConfig] = None,
                   seed: int = 0) -> np.ndarray:
    """Bandwidth (bytes/s) at each control-loop tick.  ``cfg`` defaults to
    a fresh ``TraceConfig()`` per call — a shared default instance would be
    one mutable object across every call site (``TraceConfig`` is frozen
    now, but the default still shouldn't alias).

    Vectorized: the seeded generator draws, in this order, the regime
    uniforms, the AR(1) normals, then the spike uniforms — three bulk
    draws (the draw ORDER is part of the reproducibility contract; the
    historical per-tick loop interleaved them, so traces differ from
    pre-streaming releases at the same seed — summary stats for seed 0
    are pinned in ``tests/test_pipeline.py``)."""
    cfg = cfg if cfg is not None else TraceConfig()
    rng = np.random.default_rng(seed)
    n = int(n_steps)
    if n <= 0:
        return np.empty(0)
    u_reg = rng.random(n)
    eps = rng.normal(0.0, cfg.ar_sigma, n)
    u_spike = rng.random(n)

    bad = _regime_chain(u_reg, cfg.p_degrade, cfg.p_recover)
    # AR(1) x[t] = rho x[t-1] + eps[t] as a convolution with rho**k,
    # truncated where |rho|**k < 1e-18 (below double noise relative to
    # x).  Negative rho (anticorrelated noise) keeps the alternating-sign
    # kernel; |rho| >= 1 falls back to the full-length kernel.
    kernel = _ar1_kernel(cfg.ar_rho, n)
    x = eps if kernel is None else np.convolve(eps, kernel)[:n]

    base = np.where(bad, cfg.bad_bps, cfg.mean_bps)
    v = base * np.exp(x) * _diurnal(cfg, n)
    v = np.where(u_spike < cfg.spike_prob, v * cfg.spike_depth, v)
    return np.maximum(v, cfg.floor_bps)


def _ar1_kernel(rho: float, n: int) -> Optional[np.ndarray]:
    """Truncated ``rho**k`` convolution kernel for the AR(1) recurrence,
    or ``None`` when ``rho == 0`` (noise passes through untouched)."""
    if rho == 0.0:
        return None
    a = abs(rho)
    klen = n if a >= 1.0 else min(
        n, int(np.ceil(np.log(1e-18) / np.log(a))) + 1)
    return rho ** np.arange(klen)


def _diurnal(cfg: TraceConfig, n: int) -> np.ndarray:
    return 1.0 + cfg.diurnal_amp * np.sin(
        2 * np.pi * np.arange(n) / cfg.diurnal_period)


#: Row-block size for ``generate_trace_matrix`` — bounds peak memory of
#: the 2-D tail arithmetic (~65 MB of float64 temporaries per array at
#: 4096 x 2001) without giving up the bulk elementwise work.
_MATRIX_BLOCK_ROWS = 4096


def generate_trace_matrix(n_steps: int, cfg: Optional[TraceConfig] = None,
                          seeds: Iterable[int] = ()) -> np.ndarray:
    """Bulk variant of ``generate_trace``: one ``(len(seeds), n_steps)``
    float64 matrix whose row ``i`` is bit-identical to
    ``generate_trace(n_steps, cfg, seeds[i])``.

    The per-row randomness (three bulk draws in the contract order), the
    regime walk and the AR(1) convolution stay per-row — each is part of
    the bit-reproducibility contract and cheap — while the AR(1) kernel
    and diurnal curve are computed once and the elementwise tail
    (regime base, ``exp``, diurnal, spikes, floor) runs on 2-D row
    blocks of at most ``_MATRIX_BLOCK_ROWS`` rows.  Elementwise numpy
    ufuncs are bitwise identical between the 1-D and 2-D paths, so the
    blocking is invisible.  This is what lets ``runtime/fleet.py`` stand
    up a 100k-robot fleet without 100k trace-array allocations dominating
    setup."""
    cfg = cfg if cfg is not None else TraceConfig()
    seeds = list(seeds)
    m = len(seeds)
    n = int(n_steps)
    out = np.empty((m, max(n, 0)), dtype=np.float64)
    if n <= 0 or m == 0:
        return out
    kernel = _ar1_kernel(cfg.ar_rho, n)
    diurnal = _diurnal(cfg, n)
    for lo in range(0, m, _MATRIX_BLOCK_ROWS):
        hi = min(lo + _MATRIX_BLOCK_ROWS, m)
        rows = hi - lo
        x = np.empty((rows, n), dtype=np.float64)
        bad = np.empty((rows, n), dtype=bool)
        u_spike = np.empty((rows, n), dtype=np.float64)
        for r in range(rows):
            rng = np.random.default_rng(seeds[lo + r])
            u_reg = rng.random(n)
            eps = rng.normal(0.0, cfg.ar_sigma, n)
            u_spike[r] = rng.random(n)
            bad[r] = _regime_chain(u_reg, cfg.p_degrade, cfg.p_recover)
            x[r] = eps if kernel is None else np.convolve(eps, kernel)[:n]
        base = np.where(bad, cfg.bad_bps, cfg.mean_bps)
        v = base * np.exp(x) * diurnal
        v = np.where(u_spike < cfg.spike_prob, v * cfg.spike_depth, v)
        out[lo:hi] = np.maximum(v, cfg.floor_bps)
    return out


class NetworkSim:
    """Replays a trace; answers transfer-time queries at the current tick."""

    def __init__(self, trace: np.ndarray, tick_s: float = 0.05,
                 rtt_s: float = 0.005):
        self.trace = np.asarray(trace, dtype=np.float64)
        self.tick_s = tick_s
        self.rtt_s = rtt_s
        self.t = 0

    @property
    def now_bps(self) -> float:
        return float(self.trace[min(self.t, len(self.trace) - 1)])

    def transfer_s(self, n_bytes: float) -> float:
        """Seconds to ship ``n_bytes`` at the current tick.  Zero bytes
        cost zero — no rtt is paid when nothing crosses the link, matching
        ``segmentation.net_time`` (edge-only splits are transfer-free).

        NOTE: prices the ENTIRE transfer at this tick's bandwidth even
        when it spans many ticks — adequate for sub-tick payloads, wrong
        for long transfers on a moving link; those should use
        ``transfer_trace_s``."""
        if n_bytes <= 0:
            return 0.0
        return n_bytes / self.now_bps + self.rtt_s

    def wire_trace_s(self, n_bytes: float, offset_s: float = 0.0) -> float:
        """Pure wire seconds to ship ``n_bytes`` starting ``offset_s``
        seconds after the current tick boundary, consuming the trace
        tick-by-tick (each tick delivers ``trace[t] * tick_s`` bytes).
        Past the trace end the bandwidth clamps to the last sample.  No
        rtt; zero bytes are free.  The building block for chunked
        streamed uplinks (chunks ship back-to-back, each starting at the
        previous chunk's finish offset)."""
        if n_bytes <= 0:
            return 0.0
        tick = self.tick_s
        pos = self.t + offset_s / tick          # fractional tick index
        i = int(np.floor(pos))
        frac = pos - i
        remaining = float(n_bytes)
        elapsed = 0.0
        last = len(self.trace) - 1
        while True:
            bw = float(self.trace[min(max(i, 0), last)])
            if i >= last:                       # clamped constant tail
                return elapsed + remaining / bw
            avail_s = (1.0 - frac) * tick
            cap = bw * avail_s
            if remaining <= cap:
                return elapsed + remaining / bw
            remaining -= cap
            elapsed += avail_s
            i += 1
            frac = 0.0

    def transfer_trace_s(self, n_bytes: float, offset_s: float = 0.0
                         ) -> float:
        """Trace-integrating variant of ``transfer_s``: wire seconds from
        ``wire_trace_s`` plus one rtt.  Zero bytes stay free."""
        if n_bytes <= 0:
            return 0.0
        return self.wire_trace_s(n_bytes, offset_s) + self.rtt_s

    def step(self, n: int = 1) -> None:
        self.t += n

    def seek(self, tick: int) -> None:
        """Jump the trace cursor to an absolute tick index.

        The tick loop advances every robot's link once per tick
        (``step()``), so at tick ``T`` a robot's net always sits at
        ``t == T``.  The event-driven engine skips the per-tick walk and
        positions the cursor absolutely before pricing — ``seek(T)``
        followed by the same ``now_bps`` / ``wire_trace_s`` reads is
        bit-identical to having stepped ``T`` times."""
        self.t = int(tick)

    def window(self, n: int) -> np.ndarray:
        """Last n observed bandwidth samples (for the predictor)."""
        lo = max(0, self.t - n)
        w = self.trace[lo:self.t]
        if len(w) < n:
            w = np.concatenate([np.full(n - len(w), self.trace[0]), w])
        return w
