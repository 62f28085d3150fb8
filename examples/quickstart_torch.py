"""Quickstart: RoboECC in ~60 lines, on the PyTorch/CUDA port.

The port's counterpart of ``examples/quickstart.py``, statement for
statement over ``repro_torch``:

1. Build the OpenVLA layer graph (structure model, Eq. 1).
2. Find the optimal edge/cloud split under a cloud budget (Alg. 1).
3. Build the parameter-sharing pool and react to a bandwidth drop (§IV-B).
4. Execute a REAL co-inference on a reduced model with the split executor,
   on the card (``--device cpu`` runs the plain PyTorch versions instead).

    PYTHONPATH=src python examples/quickstart_torch.py
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import (Thresholds, Workload, adjust, build_graph,
                              build_pool, pool_transfer_profile, search)
from repro_torch.core.hardware import A100, ORIN
from repro_torch.models import build
from repro_torch.runtime.partition import (LMSplitExecutor, SplitPlan,
                                           payload_bytes)

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda",
                help="where the split executor runs (default: the card)")
dev = ap.parse_args().device

# --- 1. structure model -----------------------------------------------------
cfg = get_config("openvla-7b")
graph = build_graph(cfg, Workload())
print(f"{cfg.name}: {len(graph)} layers, "
      f"{sum(c.weight_bytes for c in graph) / 1e9:.1f} GB weights")

# --- 2. Alg. 1 segmentation --------------------------------------------------
seg = search(graph, ORIN, A100, bandwidth_bps=10e6,
             cloud_budget_bytes=12.1e9)
print(f"optimal split: layer {seg.split}/{len(graph)}  "
      f"total={seg.total_s * 1e3:.1f}ms "
      f"(edge {seg.edge_s * 1e3:.1f} + cloud {seg.cloud_s * 1e3:.1f} "
      f"+ net {seg.net_s * 1e3:.1f})")

# --- 3. pool + network-aware adjustment --------------------------------------
pool = build_pool(graph, seg.split, overhead_target=0.03)
print(f"parameter-sharing pool: layers [{pool.start},{pool.end}) "
      f"= {pool.overhead_frac * 100:.2f}% weight overhead")
thr = Thresholds(high=2e6, low=-2e6)
decision = adjust(graph, pool, seg.split, nb_pred_bps=1e6,
                  nb_real_bps=10e6, thr=thr)   # predictor says: dropping!
print(f"bandwidth 10->1 MB/s predicted: move split {seg.split} -> "
      f"{decision.split} ({decision.reason})")

# --- 4. real split execution on a reduced model -------------------------------
small = get_config("llama3.2-3b").reduced().replace(n_layers=8)
model = build(small)
params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
executor = LMSplitExecutor(small, SplitPlan(pool_start=3, pool_end=6,
                                            codec="int8"), device=dev)
tokens = torch.randint(0, small.vocab_size, (1, 17),
                       generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev)
for split in (3, 4, 5):
    logits, payload = executor.run(params, tokens, split)
    print(f"split={split}: edge->cloud payload "
          f"{payload_bytes(payload) / 1e3:.1f} KB, "
          f"logits {tuple(logits.shape)}")
print("OK")
