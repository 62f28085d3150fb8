"""The card the dry run's roofline prices a step on.

``H100_SXM`` is an NVIDIA H100 SXM5 80GB at 700 W from its data sheet:
989 TFLOP/s of dense bf16 on the tensor cores, 3.35 TB/s of HBM3, 80 GB,
and NVLink 4 as 18 links of 25 GB/s each way.  The roofline's collective
term (``core.hardware.roofline``) divides the step's wire bytes by the
cards times one link's rate times the links used; the dry run uses all 18.
These are data-sheet rates, not measurements.

The production mesh's ``model`` axis is 16 wide, which spans two 8-card
NVLink nodes: part of every ``model`` collective crosses the slower
network between nodes, so the collective term here is a lower bound.

It lives here and not in ``core/hardware.py``, which is the reference's
code copied and held to its syntax tree.
"""
from __future__ import annotations

from ..core.hardware import DeviceSpec

H100_SXM = DeviceSpec("H100-SXM5-80GB-700W", peak_flops=989e12,
                      hbm_bw=3.35e12, mem_bytes=80e9, ici_bw=25e9,
                      ici_links=18)
