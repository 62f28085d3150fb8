"""RoboECC's network-aware loop (``controller``): one tick a step for the
site's shared uplink, and one executor per wire codec over the same
parameters.

The LSTM is fitted on the first ``fit_ticks`` of the bandwidth trace the
traffic names by its ``trace_seed``, and the ticks replay the rest of it:
every run sees the same network, so every seed serves the same mix of cuts
and codecs, and the run's seed draws the images and the weights."""
from __future__ import annotations

from typing import Dict, List

from repro_torch import core
from repro_torch.runtime.partition import SplitPlan, VLASplitExecutor

from ecc_bench import netrace
from ecc_bench.program import VLAServer

# a codec the controller names -> the executor's wire codec
WIRE = {None: "", "identity": "", "int8": "int8", "int4": "int4"}


class Controlled(VLAServer):
    def __init__(self, cfg, spec: Dict, device):
        self.cfg = cfg
        self.ctl = core.RoboECC(
            cfg, core.DEVICES[spec["edge"]], core.DEVICES[spec["cloud"]],
            workload=core.Workload(s_new=spec["s_new"],
                                   decode_steps=spec["decode_steps"]),
            cloud_budget_bytes=spec["cloud_budget_bytes"],
            thresholds=core.Thresholds(high=spec["thresholds_bps"][0],
                                       low=spec["thresholds_bps"][1]),
            adjust_codecs=spec["codecs"])
        trace = netrace.generate_trace(spec["trace_ticks"],
                                       spec["trace_seed"])
        fit = spec["fit_ticks"]
        self.ctl.fit_predictor(trace[:fit],
                               core.PredictorConfig(epochs=spec["epochs"]),
                               seed=spec["trace_seed"], device=device)
        self.net = core.NetworkSim(trace[fit:])
        self.net.step(self.ctl.predictor.cfg.window)
        lo, hi = (self.executor_cut(s)
                  for s in (self.ctl.pool.start, self.ctl.pool.end))
        self.executors = {w: VLASplitExecutor(cfg, SplitPlan(lo, hi, codec=w),
                                              device=device)
                          for w in sorted({WIRE[c] for c in spec["codecs"]}
                                          | {WIRE[None]})}
        self.pool = (lo, hi)

    def executor_cut(self, split: int) -> int:
        """The planner's graph holds a ``vit.proj`` node after the ViT that
        the executor has no layer for: a graph split in the LLM range puts
        ``split - Lv - 1`` LLM blocks on the edge.  A split outside it is
        clamped into it."""
        Lv, L = self.cfg.vit_layers, self.cfg.n_layers
        on_edge = split - self.ctl.cfg.vit_layers - 1
        return Lv + min(max(on_edge, 0), L)

    def decide(self):
        tick = self.ctl.tick(self.net)
        return self.decision(self.executors[WIRE[tick.codec]],
                             self.executor_cut(tick.split),
                             tick.adjust_overhead_s)

    def warm_decisions(self):
        return [self.decision(ex, self.pool[0])
                for ex in self.executors.values()]

    def trace_more(self, steps: List) -> bool:
        """Until a traced step shipped through a codec."""
        return not any(s.codec for s in steps)

    def close(self) -> None:
        self.executors = {}
        self.ctl = None


def make(cfg, traffic: Dict, device) -> Controlled:
    return Controlled(cfg, traffic["controller"], device)
