"""Hardware modeling — paper Eq. 2 (per-layer roofline latency) + Table I.

The port's own copy of ``src/repro/core/hardware.py``: the same code,
importing from ``repro_torch`` only, held equal to the reference by
``tests/test_torch_control.py``.

``T_GPU = Σ_i max(C_compute_i / (P · parallel), C_datamove_i / BW)``

The same functional form serves three roles:
  1. the paper's edge/cloud latency model (Table I devices, calibrated);
  2. the TPU v5e roofline constants for §Roofline of EXPERIMENTS.md;
  3. napkin-math estimates in the §Perf hillclimbing loop.

Calibration: the paper uses measured GPU latencies ("hardware performance
data", Insight ①); lacking the physical devices, we keep Table I peak
numbers and fit a single efficiency factor per device (``eta``) to the
paper's own *-only deployments (Tab. II edge-only / cloud-only rows), then
validate that RoboECC's relative speedups emerge (EXPERIMENTS.md
§Paper-validation).  All absolute milliseconds are model outputs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

from .structure import LayerCost


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    name: str
    peak_flops: float          # FLOP/s at the deployment compute dtype
    hbm_bw: float              # bytes/s
    mem_bytes: float
    eta_compute: float = 1.0   # achieved fraction of peak (calibrated)
    eta_mem: float = 1.0
    # TPU-only: inter-chip interconnect
    ici_bw: float = 0.0        # bytes/s per link
    ici_links: int = 0

    def with_eta(self, eta_compute: float, eta_mem: float) -> "DeviceSpec":
        return dataclasses.replace(self, eta_compute=eta_compute,
                                   eta_mem=eta_mem)


# --------------------------------------------------------- paper Table I
# "Computing Power (4-bit)" entries; memory bandwidth in GB/s.
A100 = DeviceSpec("A100", peak_flops=2496e12, hbm_bw=2039e9,
                  mem_bytes=80e9, eta_compute=0.30, eta_mem=0.75)
ORIN = DeviceSpec("Jetson-Orin", peak_flops=275e12, hbm_bw=204.8e9,
                  mem_bytes=64e9, eta_compute=0.30, eta_mem=0.60)
THOR = DeviceSpec("Jetson-Thor", peak_flops=517.5e12, hbm_bw=273e9,
                  mem_bytes=128e9, eta_compute=0.30, eta_mem=0.60)

# --------------------------------------------------------- TPU target (ours)
TPU_V5E = DeviceSpec("TPU-v5e", peak_flops=197e12, hbm_bw=819e9,
                     mem_bytes=16e9, ici_bw=50e9, ici_links=4)

DEVICES: Dict[str, DeviceSpec] = {
    "a100": A100, "orin": ORIN, "thor": THOR, "tpu-v5e": TPU_V5E,
}


# ------------------------------------------------------------------ Eq. 2
def layer_latency(c: LayerCost, dev: DeviceSpec, *, parallel: float = 1.0
                  ) -> float:
    """max(compute, memory) seconds for one layer on one device (Eq. 2)."""
    t_comp = c.flops / (dev.peak_flops * dev.eta_compute * parallel)
    t_mem = c.datamove_bytes / (dev.hbm_bw * dev.eta_mem)
    return max(t_comp, t_mem)


def stack_latency(costs: Iterable[LayerCost], dev: DeviceSpec) -> float:
    return sum(layer_latency(c, dev) for c in costs)


def fit_eta(costs: Iterable[LayerCost], dev: DeviceSpec, target_s: float,
            ) -> DeviceSpec:
    """One-parameter calibration: scale (eta_compute, eta_mem) jointly so
    the modeled stack latency matches a measured/published number."""
    base = stack_latency(costs, dev)
    scale = base / target_s  # <1 -> device slower than modeled
    return dev.with_eta(dev.eta_compute * scale, dev.eta_mem * scale)


# ------------------------------------------------------------------ roofline
@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline(hlo_flops: float, hlo_bytes: float, collective_bytes: float,
             n_chips: int, dev: DeviceSpec = TPU_V5E,
             links_used: Optional[int] = None) -> RooflineTerms:
    """Assignment formulas (global quantities over the whole step):

      compute    = HLO_FLOPs / (chips * peak)
      memory     = HLO_bytes / (chips * HBM_bw)
      collective = collective_bytes / (chips * link_bw)
    """
    links = dev.ici_bw * (links_used if links_used else 1)
    return RooflineTerms(
        compute_s=hlo_flops / (n_chips * dev.peak_flops),
        memory_s=hlo_bytes / (n_chips * dev.hbm_bw),
        collective_s=collective_bytes / (n_chips * links) if collective_bytes
        else 0.0,
    )
