"""Streamed split execution — the chunked 3-stage transfer pipeline.

The port's own copy of ``src/repro/core/pipeline.py``: the same code,
importing from ``repro_torch`` only, held equal to the reference by
``tests/test_torch_control.py``.

RoboECC's Eq. 2 cost model (and every decision layer built on it before
streaming) prices a split as *edge compute + full activation transfer + cloud
compute*, strictly in sequence: at the 0.2–1 MB/s operating points the
link sits idle while a tier computes and vice versa.  ActionFlow
(arXiv 2512.20276) shows that pipelining chunked work across the edge
boundary recovers exactly this dead time, and the XPU characterization
line of PAPERS.md shows transfer — not compute — dominates VLA split
latency on weak links.  This module is the shared *makespan* model for
that streamed execution: the cut activation is sliced into ``n_chunks``
along the token/patch axis and shipped through a 3-stage pipeline

    stage 1  edge encode     (codec encode of chunk i on the edge device)
    stage 2  uplink          (chunk wire bytes / bandwidth + per-chunk rtt)
    stage 3  cloud decode +  (codec decode of chunk i, then prefill of the
             chunked prefill  arrived chunk — exact under causal attention,
                              the vLLM chunked-prefill argument)

so the planner prices ``max``-based pipeline *makespan* instead of a sum.
Chunked prefill is what makes streaming worth anything here: codec
encode/decode is µs-scale, but overlapping the cloud window's compute
with the transfer recovers up to ``min(cloud_s, wire_s)`` per request.

The trade the planner searches: more chunks shrink the fill/drain bubbles
(the first chunk's encode and the last chunk's decode+prefill are exposed)
but every chunk pays its own ``rtt`` on the wire stage — so chunking wins
on slow links where wire time dwarfs the rtt and *loses* on fast links
where the per-chunk rtt is the whole transfer (the honest negative result
recorded in docs/EXPERIMENTS.md §Streaming).  A chunk count picked for
10 MB/s is wrong at 0.2 MB/s — the paper's performance-drift story
replayed on a new axis — which is why ``core/controller.py`` replans
``n_chunks`` from the LSTM bandwidth forecast and ``runtime/fleet.py``
counts ``n_chunk_reconfigs``.

Two implementations of the same model (the scalar-oracle parity rule):

* ``stream_makespan_scalar`` — the literal chunk-by-chunk pipeline
  recurrence (supports non-uniform per-chunk transfer times, which the
  fleet's trace-integrating transfers produce); the property-test oracle.
* ``stream_makespan`` — the closed form for uniform chunks,
  numpy-broadcastable over whole (codec × S1 × S2 × K × bandwidth)
  planner tensors (``segmentation.search_streamed``).

``n_chunks = 1`` is *defined* as the sequential path: every planner and
runtime consumer short-circuits K = 1 cells to the exact non-streamed
expression, so streaming with one chunk reproduces today's numbers
bit-for-bit (DESIGN.md §9).  Streaming applies only where a codec would
(``stream_applies``): mid-graph cuts with traffic — the S = 0 raw
observation upload and the S = n no-transfer extreme never chunk.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np

# Chunk counts every planner searches by default.  Powers of two keep the
# token-axis slices even-ish; 16 is past the point where per-chunk rtt
# dominates at every modeled operating point, so the grid brackets the
# optimum rather than clipping it.
DEFAULT_CHUNK_GRID = (1, 2, 4, 8, 16)

ArrayLike = Union[float, np.ndarray]


def stream_applies(split: int, n: int, wire_raw: float) -> bool:
    """Chunked streaming is meaningful only for mid-graph cuts with
    traffic — the same gate as ``segmentation.codec_applies`` plus a
    non-empty payload.  Extremes (raw-observation upload at S = 0,
    no-transfer at S = n) are forced to ``n_chunks = 1``."""
    return 0 < split < n and wire_raw > 0


def stream_makespan_scalar(enc_s: float, wire_s, comp_s: float,
                           n_chunks: int, rtt_s: float = 0.0) -> float:
    """Chunk-by-chunk 3-stage pipeline recurrence — the scalar oracle.

    ``enc_s`` / ``comp_s`` are the *totals* for stage 1 (edge encode) and
    stage 3 (cloud decode + window prefill), split uniformly across
    chunks.  ``wire_s`` is either the total stage-2 wire seconds (split
    uniformly) or a length-``n_chunks`` sequence of per-chunk wire
    seconds (the fleet's trace-integrated transfers are non-uniform);
    every chunk additionally pays ``rtt_s`` on the wire stage.

    Recurrence (t_* = completion time of chunk i in each stage)::

        t_enc[i] = t_enc[i-1] + a
        t_tx[i]  = max(t_enc[i], t_tx[i-1]) + b_i
        t_out[i] = max(t_tx[i],  t_out[i-1]) + c

    and the makespan is ``t_out[K-1]``.  ``n_chunks = 1`` degenerates to
    the sequential sum ``enc + wire + rtt + comp``.
    """
    K = int(n_chunks)
    if K < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    if np.ndim(wire_s) == 0:
        b = np.full(K, float(wire_s) / K + rtt_s)
    else:
        b = np.asarray(wire_s, dtype=np.float64) + rtt_s
        if len(b) != K:
            raise ValueError(f"need {K} per-chunk wire times, got {len(b)}")
    a = enc_s / K
    c = comp_s / K
    t_enc = t_tx = t_out = 0.0
    for i in range(K):
        t_enc = t_enc + a
        t_tx = max(t_enc, t_tx) + float(b[i])
        t_out = max(t_tx, t_out) + c
    return t_out


def stream_makespan(enc_s: ArrayLike, wire_s: ArrayLike, comp_s: ArrayLike,
                    n_chunks: ArrayLike, rtt_s: ArrayLike = 0.0
                    ) -> np.ndarray:
    """Closed-form makespan for uniform chunks, broadcastable over planner
    tensors.  With per-chunk stage times ``a = enc/K``, ``b = wire/K +
    rtt``, ``c = comp/K`` the 3-stage pipeline finishes at::

        a + b + c + (K - 1) * max(a, b, c)

    (one pass through the pipe plus K-1 repeats of the bottleneck stage —
    the ``max`` term is the steady state, ``a + b + c - max`` the
    fill/drain bubbles).  Agrees with ``stream_makespan_scalar`` to float
    rounding; the planner parity tests pin the two together.
    """
    K = np.asarray(n_chunks, dtype=np.float64)
    a = np.asarray(enc_s, dtype=np.float64) / K
    b = np.asarray(wire_s, dtype=np.float64) / K + rtt_s
    c = np.asarray(comp_s, dtype=np.float64) / K
    return a + b + c + (K - 1.0) * np.maximum(np.maximum(a, b), c)


def stream_bubble_fraction(enc_s: ArrayLike, wire_s: ArrayLike,
                           comp_s: ArrayLike, n_chunks: ArrayLike,
                           rtt_s: ArrayLike = 0.0) -> np.ndarray:
    """Fraction of the makespan NOT covered by the bottleneck stage —
    the fill/drain dead time streaming has not (yet) recovered::

        bubble = (makespan - K * max(a, b, c)) / makespan

    1 chunk (sequential) exposes the two non-bottleneck stages entirely;
    perfect pipelining drives the fraction to 0.  Zero-work pipelines
    report 0.  Used by ``runtime/fleet.py`` for ``FleetReport``'s
    ``mean_bubble_frac`` counter."""
    K = np.asarray(n_chunks, dtype=np.float64)
    a = np.asarray(enc_s, dtype=np.float64) / K
    b = np.asarray(wire_s, dtype=np.float64) / K + rtt_s
    c = np.asarray(comp_s, dtype=np.float64) / K
    peak = np.maximum(np.maximum(a, b), c)
    m = a + b + c + (K - 1.0) * peak
    with np.errstate(invalid="ignore", divide="ignore"):
        frac = np.where(m > 0.0, (m - K * peak) / np.where(m > 0, m, 1.0),
                        0.0)
    return frac


def chunk_sizes(total: int, n_chunks: int) -> Sequence[int]:
    """Token-axis slice sizes for ``total`` rows in ``n_chunks`` chunks —
    ``numpy.array_split`` semantics (first ``total % K`` chunks one row
    longer), shared by the planner's byte accounting and the runtime's
    ``partition.chunk_payload`` so both layers slice identically."""
    K = int(n_chunks)
    if K < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    base, extra = divmod(int(total), K)
    return [base + 1 if i < extra else base for i in range(K)]
