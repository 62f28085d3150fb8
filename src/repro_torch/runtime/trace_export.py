"""Chrome trace-event JSON export for the flight recorder.

The port's own copy of ``src/repro/runtime/trace_export.py``: the same
code, importing from ``repro_torch`` only, held equal to the reference
by ``tests/test_torch_telemetry.py``.

Renders the span groups a ``core/telemetry.FlightRecorder`` kept into
the Trace Event Format that ``chrome://tracing`` and Perfetto load
directly: one *process* row per lane family (robot cohorts, cloud
replicas, open-loop arrival processes, executor spans), one
*thread* row per lane, ``"X"`` complete events for spans (microsecond
``ts``/``dur``; an executor stage's ``args`` name its ``parent``, on
whose lane it lies) and ``"M"`` metadata events naming the rows.  The
export walks only the reservoir-kept groups, so writing a trace of a
100k-robot run costs the same as a 1k one.
"""
from __future__ import annotations

import json
from typing import Dict, List, Tuple

from ..core.telemetry import FlightRecorder, Span

__all__ = ["chrome_trace", "export_chrome_trace"]

# lane family (the prefix before ":") -> Chrome pid; unknown families
# group under "other".  Perfetto sorts rows by pid, so this fixes the
# top-to-bottom reading order of the trace.
_FAMILY_PIDS = {"robot": 1, "proc": 2, "replica": 3, "executor": 4}
_OTHER_PID = 9
_FAMILY_NAMES = {1: "robot cohorts", 2: "arrival processes",
                 3: "cloud replicas", 4: "executor wall-clock",
                 _OTHER_PID: "other"}


def _lane_pid(lane: str) -> int:
    family = lane.split(":", 1)[0]
    return _FAMILY_PIDS.get(family, _OTHER_PID)


def chrome_trace(recorder: FlightRecorder) -> dict:
    """Build the Chrome trace-event payload dict for the recorder's kept
    span groups.  Deterministic: lanes get thread ids in sorted order, and
    events are emitted sorted by (timestamp, lane)."""
    spans: List[Span] = [s for group in recorder.spans.items for s in group]
    lanes = sorted({s.lane for s in spans})
    tid_of: Dict[str, Tuple[int, int]] = {}
    next_tid: Dict[int, int] = {}
    for lane in lanes:
        pid = _lane_pid(lane)
        tid = next_tid.get(pid, 0)
        next_tid[pid] = tid + 1
        tid_of[lane] = (pid, tid)

    events: List[dict] = []
    for pid in sorted({p for p, _ in tid_of.values()}):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0,
                       "args": {"name": _FAMILY_NAMES.get(pid, "other")}})
    for lane in lanes:
        pid, tid = tid_of[lane]
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": lane}})

    # a stage nested in another lies on its parent's lane, and follows its
    # parent where both start at one instant, so that Perfetto nests it
    for s in sorted(spans, key=lambda s: (s.t0_s, s.lane, s.parent != "",
                                          s.name)):
        pid, tid = tid_of[s.lane]
        args = {"req": s.req, "parent": s.parent} if s.parent \
            else {"req": s.req}
        events.append({"name": s.name, "cat": s.cat, "ph": "X",
                       "ts": s.t0_s * 1e6, "dur": s.dur_s * 1e6,
                       "pid": pid, "tid": tid, "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"spans_kept": len(recorder.spans),
                          "spans_seen": recorder.spans.n_seen,
                          "mode": recorder.mode}}


def export_chrome_trace(recorder: FlightRecorder, path: str) -> str:
    """Write the trace to ``path`` (conventionally ``*.trace.json``) and
    return the path.  Open the file in Perfetto (ui.perfetto.dev) or
    ``chrome://tracing``."""
    with open(path, "w") as f:
        json.dump(chrome_trace(recorder), f)
    return path
