"""One split executor at a cut the traffic fixes (``plan``):
``pool_blocks`` is the executor's pool of cuts and ``edge_blocks`` the cut,
both counted in LLM blocks after the ViT; ``codec`` is the wire codec."""
from __future__ import annotations

from typing import Dict

from repro_torch.runtime.partition import SplitPlan, VLASplitExecutor

from ecc_bench.program import VLAServer


class FixedPlan(VLAServer):
    def __init__(self, cfg, plan: Dict, device):
        self.cfg = cfg
        Lv = cfg.vit_layers
        lo, hi = plan["pool_blocks"]
        self.ex = VLASplitExecutor(cfg, SplitPlan(Lv + lo, Lv + hi,
                                                  codec=plan["codec"]),
                                   device=device)
        self.split = Lv + plan["edge_blocks"]

    def decide(self):
        return self.decision(self.ex, self.split)

    def warm_decisions(self):
        return [self.decide()]

    def close(self) -> None:
        self.ex = None


def make(cfg, traffic: Dict, device) -> FixedPlan:
    return FixedPlan(cfg, traffic["plan"], device)
