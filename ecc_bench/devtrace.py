"""What the profiler's trace of the traced steps says about the device.

The window is marked on the device itself: the traced steps start after
one marker kernel (``torch.cuda._sleep``'s ``spin_kernel``) issued on an
idle card and end where a second one starts, issued once they are done.
The card is busy where any device operation runs (the union of their
intervals: kernels, copies, fills), idle elsewhere.  User annotations
(``record_function`` ranges and their device-side twins) are no
operations and are dropped, so that they neither count as launches nor
cover idle time.  The idle gaps are named by the innermost range of the
program's stages (``roboecc.<stage>``) at each gap's middle, where one
spans it, else by the innermost host operation there (an ATen operator or
a CUDA runtime call), or "no operation" where the host was running Python
between them.  The profiler slows the host (PERF.md gives by how much), so
the traced window's idle share is higher than an untraced window's.
Kernel time is grouped by name as ``chip_smoke.py``'s
``profile_request`` groups it, copied here so that the benchmark reads
nothing of that script.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from . import stats

MARKER = "spin_kernel"       # torch.cuda._sleep's kernel
MARKER_CYCLES = 1000
NAME_CHARS = 96
STAGE_PREFIX = "roboecc."    # the program's ranges of its stages


@dataclass
class Op:
    name: str
    start_us: float
    end_us: float

    @property
    def dur_s(self) -> float:
        return (self.end_us - self.start_us) * 1e-6


@dataclass
class DeviceTrace:
    start_us: float
    end_us: float
    device_ops: List[Op]            # every CUDA activity in the window
    host_ops: List[Op] = field(default_factory=list)
    steps: list = field(default_factory=list)   # the traced steps' records

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) * 1e-6

    @property
    def kernels(self) -> List[Op]:
        return [o for o in self.device_ops if not _is_copy(o.name)]

    def busy_s(self) -> float:
        return stats.covered((max(o.start_us, self.start_us),
                              min(o.end_us, self.end_us))
                             for o in self.device_ops) * 1e-6

    def seconds(self, pattern: str) -> float:
        """Device time of the kernels whose names match ``pattern``."""
        rx = re.compile(pattern)
        return sum(o.dur_s for o in self.kernels if rx.search(o.name))


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def mark() -> None:
    """Issue one marker kernel."""
    import torch
    torch.cuda._sleep(MARKER_CYCLES)


def window(device: List[Op], host: List[Op]) -> DeviceTrace:
    """The operations between the last two marker kernels: from the end of
    the first to the start of the second."""
    marks = sorted((o for o in device if MARKER in o.name),
                   key=lambda o: o.start_us)
    if len(marks) < 2:
        raise RuntimeError(f"the trace holds {len(marks)} {MARKER!r} "
                           "marker(s), not two")
    lo, hi = marks[-2].end_us, marks[-1].start_us

    def inside(ops):
        return [o for o in ops if MARKER not in o.name
                and o.end_us > lo and o.start_us < hi]
    return DeviceTrace(lo, hi, inside(device), inside(host))


def from_profiler(prof) -> DeviceTrace:
    """The window of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in prof.events():
        if e.is_user_annotation:
            continue
        op = Op(e.name, float(e.time_range.start), float(e.time_range.end))
        (device if e.device_type == DeviceType.CUDA else host).append(op)
    return window(device, host)


def group(name: str) -> str:
    """A kernel's family: the hand-written kernels by name, library
    products, reductions and softmax, copies, elementwise, other."""
    low = name.lower()
    ours = re.search(r"(flash_attention_\w+?|decode_attention_\w+?"
                     r"|decode_(?:split|combine)|\w*quantize_int[48]\w*?"
                     r"|ssd_\w+?)_kernel", name)
    if ours:
        return "hand-written: " + ours.group(1)
    if any(w in low for w in ("nvjet", "gemm", "gemv", "cutlass", "cublas",
                              "xmma")):
        return "matrix products (library)"
    if "reduce_kernel" in low or "softmax" in low:
        return "reductions and softmax"
    if _is_copy(name) or "copy" in low or "cat" in low or "index" in low:
        return "copies, casts, cat, gather"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    return "other"


def top_ops(trace: DeviceTrace, n: int = 10) -> List[List]:
    """The device operations that took most time, summed by name."""
    by: Dict[str, float] = {}
    for o in trace.device_ops:
        key = o.name[:NAME_CHARS]
        by[key] = by.get(key, 0.0) + o.dur_s
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def by_group(trace: DeviceTrace) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for o in trace.device_ops:
        g = group(o.name)
        out[g] = out.get(g, 0.0) + o.dur_s
    return out


def idle_gaps(trace: DeviceTrace, n: int = 10) -> List[List]:
    """Idle time of the device inside the window, summed by what the host
    was doing in the middle of each gap: the shortest of the program's
    stage ranges that spans that instant, else the shortest host call."""
    start = np.array([o.start_us for o in trace.host_ops])
    end = np.array([o.end_us for o in trace.host_ops])
    dur = end - start
    stage = np.array([o.name.startswith(STAGE_PREFIX)
                      for o in trace.host_ops], dtype=bool)
    by: Dict[str, float] = {}
    spans = [(o.start_us, o.end_us) for o in trace.device_ops]
    for lo, hi in stats.gaps(spans, trace.start_us, trace.end_us):
        mid = 0.5 * (lo + hi)
        hit = np.flatnonzero((start <= mid) & (end >= mid))
        if stage[hit].any():
            hit = hit[stage[hit]]
        key = "host: " + (trace.host_ops[hit[np.argmin(dur[hit])]]
                          .name[:NAME_CHARS] if hit.size else "no operation")
        by[key] = by.get(key, 0.0) + (hi - lo) * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
