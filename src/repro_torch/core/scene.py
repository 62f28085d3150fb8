"""Scene-dynamics simulation: per-step token change fractions.

The port's own copy of ``src/repro/core/scene.py``: the same code,
importing from ``repro_torch`` only, held equal to the reference by
``tests/test_torch_scene.py``.

The temporal-delta codec (``codec.DeltaCodec``) ships only the token
rows that changed since the previous step, so its wire bytes depend on
*scene content*, not just the link.  This module is the content axis:
a seeded, reproducible trace of the fraction of token rows that change
at each control-loop tick — near zero for a static tabletop, near one
for a robot driving through a crowd.

The process mirrors ``network.generate_trace``'s shape on purpose: a
log-AR(1) fluctuation around a mean change fraction, plus rare "scene
event" spikes (an object enters the frame, the arm occludes the camera)
that momentarily drive the change fraction to ``event_frac``.  All
randomness is drawn in bulk up front (AR(1) normals then event
uniforms, in that order — the draw ORDER is part of the reproducibility
contract), and the AR(1) recurrence reuses ``network._ar1_kernel``.
Same ``(n_steps, cfg, seed)`` → bit-identical trace.

``generate_scene_matrix`` is the fleet-scale bulk variant, blocked like
``network.generate_trace_matrix`` so row ``i`` is bit-identical to the
1-D call with ``seeds[i]``.

Values are fractions in ``[floor_frac, ceil_frac] ⊆ [0, 1]``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Union

import numpy as np

from .network import _MATRIX_BLOCK_ROWS, _ar1_kernel


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    mean_frac: float = 0.15         # typical fraction of changed token rows
    ar_rho: float = 0.9             # AR(1) smoothness of the fluctuation
    ar_sigma: float = 0.2           # relative (log-space) noise
    event_prob: float = 0.01        # per-step scene-event probability
    event_frac: float = 1.0         # change fraction during an event
    floor_frac: float = 0.005       # sensor noise never lets it hit zero
    ceil_frac: float = 1.0


#: Named scene classes for the benchmarks and the fleet config string
#: axis.  ``static`` is a fixed camera over a mostly-still tabletop,
#: ``slow`` a manipulation scene with steady arm motion, ``dynamic`` a
#: mobile robot in a busy environment where nearly every token changes
#: every step (the honest negative for the delta codec).
SCENES: Dict[str, SceneConfig] = {
    "static": SceneConfig(mean_frac=0.02, event_prob=0.002),
    "slow": SceneConfig(mean_frac=0.15, event_prob=0.01),
    "dynamic": SceneConfig(mean_frac=0.9, ar_sigma=0.1, event_prob=0.05),
}


def scene_config(scene: Union[str, SceneConfig]) -> SceneConfig:
    """Resolve a scene given by name or by config.  ``SceneConfig``
    instances pass through; unknown names raise ``KeyError``."""
    if isinstance(scene, SceneConfig):
        return scene
    try:
        return SCENES[scene]
    except KeyError:
        raise KeyError(f"unknown scene {scene!r}; have {sorted(SCENES)}")


def generate_scene_trace(n_steps: int, cfg: Optional[SceneConfig] = None,
                         seed: int = 0) -> np.ndarray:
    """Change fraction at each control-loop tick.  ``cfg`` defaults to a
    fresh ``SceneConfig()`` per call (same no-aliasing rule as
    ``generate_trace``).

    Vectorized: the seeded generator draws the AR(1) normals then the
    event uniforms — two bulk draws in contract order — and the AR(1)
    noise is the same truncated-kernel convolution the bandwidth trace
    uses."""
    cfg = cfg if cfg is not None else SceneConfig()
    rng = np.random.default_rng(seed)
    n = int(n_steps)
    if n <= 0:
        return np.empty(0)
    eps = rng.normal(0.0, cfg.ar_sigma, n)
    u_event = rng.random(n)

    kernel = _ar1_kernel(cfg.ar_rho, n)
    x = eps if kernel is None else np.convolve(eps, kernel)[:n]

    v = cfg.mean_frac * np.exp(x)
    v = np.where(u_event < cfg.event_prob, cfg.event_frac, v)
    return np.clip(v, cfg.floor_frac, cfg.ceil_frac)


def generate_scene_matrix(n_steps: int, cfg: Optional[SceneConfig] = None,
                          seeds: Iterable[int] = ()) -> np.ndarray:
    """Bulk variant of ``generate_scene_trace``: one
    ``(len(seeds), n_steps)`` float64 matrix whose row ``i`` is
    bit-identical to ``generate_scene_trace(n_steps, cfg, seeds[i])``.
    Per-row randomness and convolution stay per-row (reproducibility);
    the elementwise tail runs on row blocks like
    ``network.generate_trace_matrix``."""
    cfg = cfg if cfg is not None else SceneConfig()
    seeds = list(seeds)
    m = len(seeds)
    n = int(n_steps)
    out = np.empty((m, max(n, 0)), dtype=np.float64)
    if n <= 0 or m == 0:
        return out
    kernel = _ar1_kernel(cfg.ar_rho, n)
    for lo in range(0, m, _MATRIX_BLOCK_ROWS):
        hi = min(lo + _MATRIX_BLOCK_ROWS, m)
        rows = hi - lo
        x = np.empty((rows, n), dtype=np.float64)
        u_event = np.empty((rows, n), dtype=np.float64)
        for r in range(rows):
            rng = np.random.default_rng(seeds[lo + r])
            eps = rng.normal(0.0, cfg.ar_sigma, n)
            u_event[r] = rng.random(n)
            x[r] = eps if kernel is None else np.convolve(eps, kernel)[:n]
        v = cfg.mean_frac * np.exp(x)
        v = np.where(u_event < cfg.event_prob, cfg.event_frac, v)
        out[lo:hi] = np.clip(v, cfg.floor_frac, cfg.ceil_frac)
    return out
