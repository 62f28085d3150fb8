"""One run of one cell: set-up, the measured window, the traced steps, the
comparison, and the result line.

Every metric, end to end or per layer, is read by its own file
``metrics/<name>.py`` from a :class:`Reading` of the run; the inputs and
the comparison come from the configuration's family, the serving from the
traffic's server, the pacing from the traffic's loop (``catalog.py``).  So
a cell, a configuration or a metric is added with files, not by editing
this one.
"""
from __future__ import annotations

import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from . import catalog, check, devtrace, weights
from .seeds import derive


@dataclass
class Step:
    index: int
    t0: float                   # inputs issued to the device (host clock)
    t1: float                   # the answers on the host
    requests: int               # requests the step served
    edge_blocks: Optional[int]  # LLM blocks on the edge, for a split
    codec: str                  # the wire codec, "" for raw
    wire_bytes: int             # every tensor of the step's payloads
    overhead_s: Optional[float]  # the controller's own tick overhead
    issued: Optional[List[float]] = None  # each request's issue, if not t0


@dataclass
class Reading:
    """What the metric readers read."""
    config: Dict                # the configuration file's ``config``
    seq: int                    # positions of one request
    setup_s: float
    window_s: float
    steps: List[Step]
    wire_steps: int             # the window's first steps the wire counts
    spans_ms: Dict[str, List[float]] = field(default_factory=dict)
    trace: Optional[devtrace.DeviceTrace] = None
    power_limit_w: Optional[float] = None

    @property
    def actions(self) -> int:
        return sum(s.requests for s in self.steps)

    @property
    def request_ms(self) -> List[float]:
        """Every request's latency, from its issue to its step's answers on
        the host."""
        return [(s.t1 - t) * 1e3 for s in self.steps
                for t in (s.issued or [s.t0] * s.requests)]


def payload_nbytes(payload) -> int:
    if isinstance(payload, dict):
        return sum(payload_nbytes(v) for v in payload.values())
    return payload.numel() * payload.element_size()


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """The cell's family draws the inputs, its server (from the program)
    serves them, and its loop paces the window."""

    def __init__(self, cell: catalog.Cell, seed: int, device="cuda"):
        from . import program
        self.program = program
        self.cell = cell
        self.device = torch.device(device)
        self.cfg = program.model_config(cell.config)
        self.params = weights.draw(program.param_specs(self.cfg),
                                   derive(seed, "weights"), self.device)
        self.inputs = cell.family.Inputs(cell.config, cell.traffic, seed,
                                         self.device)
        self.server = cell.server.make(self.cfg, cell.traffic, self.device)
        self.sample = check.Sample(int(cell.traffic["check_steps"]), seed)
        self.next_index = 0

    def _serve(self, index: int, d, t0: float, recorder=None,
               keep: bool = False) -> Step:
        answer, payload = self.server.serve(self.params, self.inputs, index,
                                            d, recorder)
        host = answer.float().cpu()
        rec = Step(index, t0, time.perf_counter(), host.shape[0],
                   d.edge_blocks, d.codec, payload_nbytes(payload),
                   d.overhead_s)
        if keep:
            self.sample.offer(lambda: check.Kept(index, d.record(), payload,
                                                 host))
        return rec

    def step(self, recorder=None, keep: bool = False) -> Step:
        """One step: the inputs issued, the server's decision (under a
        controller, its tick), the serving, the answers to the host; with
        ``keep``, offered to the comparison's sample."""
        index = self.next_index
        self.next_index += 1
        t0 = time.perf_counter()
        return self._serve(index, self.server.decide(), t0, recorder, keep)

    def warm(self) -> None:
        """Every executor the traffic can reach at the cell's shapes, then
        the loop's own first steps."""
        for k, d in enumerate(self.server.warm_decisions()):
            self._serve(-1 - k, d, time.perf_counter())
        for _ in range(int(self.cell.traffic["warmup_steps"])):
            self.step()
        _sync(self.device)

    def window(self, seconds: float, recorder=None) -> List[Step]:
        return self.cell.loop.window(self, seconds, recorder)

    def traced(self) -> devtrace.DeviceTrace:
        """``trace_steps`` more steps under the profiler, after one that
        warms it, and more while the server says they miss a path the
        cell exercises (at most three times as many)."""
        from torch.profiler import ProfilerActivity, profile
        n = int(self.cell.traffic["trace_steps"])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            self.step()
            _sync(self.device)
            devtrace.mark()
            steps = []
            while len(steps) < n or (self.server.trace_more(steps)
                                     and len(steps) < 3 * n):
                steps.append(self.step())
            _sync(self.device)
            devtrace.mark()
            _sync(self.device)
        trace = devtrace.from_profiler(prof)
        trace.steps = steps
        return trace

    def close(self) -> None:
        """Free the program's state; the drawn parameters are the
        benchmark's inputs and stay for the reference."""
        self.server.close()
        self.server = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _mix(steps: List[Step]) -> Dict[str, int]:
    mix: Dict[str, int] = {}
    for s in steps:
        key = f"{s.codec or 'raw'}@{s.edge_blocks}"
        mix[key] = mix.get(key, 0) + 1
    return mix


def _describe(steps: List[Step], window_s: float, setup_s: float,
              wire_steps: int) -> None:
    """One line on standard error about the window's steps."""
    ms = sorted((s.t1 - s.t0) * 1e3 for s in steps)
    print(f"window {window_s:.3f} s, setup {setup_s:.3f} s, {len(steps)} "
          f"steps: least {ms[0]:.2f} ms, median {ms[len(ms) // 2]:.2f}, "
          f"most {ms[-1]:.2f}, mean {sum(ms) / len(ms):.2f}; cut and codec "
          f"{_mix(steps)}, of the first {wire_steps} "
          f"{_mix(steps[:wire_steps])}", file=sys.stderr)


def run(cell: catalog.Cell, seed: int, seconds: float, trace: bool,
        device="cuda", t_start: Optional[float] = None) -> Dict:
    """The result line of one run, as a dict."""
    t_start = time.perf_counter() if t_start is None else t_start
    r = Run(cell, seed, device)
    r.warm()
    setup_s = time.perf_counter() - t_start
    rec = r.program.recorder() if trace else None
    steps = r.window(seconds, rec)
    window_s = steps[-1].t1 - steps[0].t0
    wire_steps = int(cell.traffic["wire_steps"])
    _describe(steps, window_s, setup_s, wire_steps)
    dtrace = r.traced() if trace and r.device.type == "cuda" else None
    dev = r.device
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    spans = {} if rec is None else r.program.spans_ms(rec)
    r.close()

    readings = check.judge(cell.family, cell.config["config"], r.params,
                           r.inputs, r.sample)
    table = check.verdict(readings, cell.limits)
    reading = Reading(cell.config["config"], r.inputs.seq,
                      setup_s, window_s, steps, wire_steps, spans, dtrace,
                      power_limit_w() if dev.type == "cuda" else None)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = cell.metric_reader(m["name"]).read(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": peak,
        "power_limit_w": reading.power_limit_w,
    }
    out = {"correct": check.passed(table),
           "attempted": reading.actions, "failed": 0,
           "metrics": metrics, "device": device_info}
    if dtrace is not None:
        print(f"traced {len(dtrace.steps)} steps, {dtrace.window_s:.6f} s: "
              f"device seconds by family {devtrace.by_group(dtrace)}",
              file=sys.stderr)
        device_info["busy_s"] = dtrace.busy_s()
        device_info["window_s"] = dtrace.window_s
        out["breakdown"] = {"device_ops": devtrace.top_ops(dtrace),
                            "idle_gaps": devtrace.idle_gaps(dtrace)}
    out["check"] = table
    return out
