"""The bandwidth trace a site's uplink sees, drawn from the seed.

A frozen copy of the program's ``core/network.py::generate_trace`` (a
Markov-modulated good/bad regime, AR(1) noise, diurnal drift and congestion
spikes; bytes per second at each 50 ms control tick), kept here so that a
change to the program cannot change the traffic it is measured on.  The
draw order (regime uniforms, AR(1) normals, spike uniforms) is part of the
copy: the same seed gives the same trace as the original.
"""
from __future__ import annotations

from bisect import bisect_left

import numpy as np

MEAN_BPS = 10e6             # the good regime, 10 MB/s
BAD_BPS = 1e6               # the degraded regime, 1 MB/s
P_DEGRADE = 0.02
P_RECOVER = 0.15
AR_RHO = 0.9
AR_SIGMA = 0.08
SPIKE_PROB = 0.01
SPIKE_DEPTH = 0.25
DIURNAL_AMP = 0.15
DIURNAL_PERIOD = 2_000
FLOOR_BPS = 0.05e6


def _regime(u: np.ndarray) -> np.ndarray:
    """Bad-regime mask from one uniform stream: from good, the next draw
    under ``P_DEGRADE`` flips to bad on its own tick; from bad, the next
    draw under ``P_RECOVER`` is good again."""
    n = len(u)
    bad = np.zeros(n, dtype=bool)
    deg = np.flatnonzero(u < P_DEGRADE).tolist()
    rec = np.flatnonzero(u < P_RECOVER).tolist()
    t, is_bad = 0, False
    while t < n:
        if not is_bad:
            j = bisect_left(deg, t)
            if j == len(deg):
                break
            bad[deg[j]] = True
            t, is_bad = deg[j] + 1, True
        else:
            j = bisect_left(rec, t)
            if j == len(rec):
                bad[t:] = True
                break
            bad[t:rec[j]] = True
            t, is_bad = rec[j] + 1, False
    return bad


def generate_trace(n_steps: int, seed: int) -> np.ndarray:
    """Bandwidth in bytes per second at each of ``n_steps`` ticks."""
    rng = np.random.default_rng(seed)
    n = int(n_steps)
    u_reg = rng.random(n)
    eps = rng.normal(0.0, AR_SIGMA, n)
    u_spike = rng.random(n)
    bad = _regime(u_reg)
    klen = min(n, int(np.ceil(np.log(1e-18) / np.log(AR_RHO))) + 1)
    x = np.convolve(eps, AR_RHO ** np.arange(klen))[:n]
    v = np.where(bad, BAD_BPS, MEAN_BPS) * np.exp(x) * (
        1.0 + DIURNAL_AMP * np.sin(2 * np.pi * np.arange(n) / DIURNAL_PERIOD))
    v = np.where(u_spike < SPIKE_PROB, v * SPIKE_DEPTH, v)
    return np.maximum(v, FLOOR_BPS)
