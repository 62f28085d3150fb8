"""End to end: RoboECC serving a VLA under a fluctuating network, on
the PyTorch/CUDA port.

The port's counterpart of ``examples/serve_vla_ecc.py``, statement for
statement over ``repro_torch``.  Full pipeline: cost models -> Alg.1 ->
pool -> trained LSTM predictor -> per-request ΔNB adjustment, with a
reduced CogACT actually executing split co-inference (ViT+LLM on 'edge',
LLM tail + DiT on 'cloud') and a seeded bandwidth trace clocking every
transfer.  Compares RoboECC against edge-only / cloud-only / fixed-split
and no-adjustment baselines.  The predictor and both tiers run on the card
(``--device cpu`` runs the plain PyTorch versions instead).

The planner's split maps onto the reduced 6-layer data plane by
``map_split``, the proportional mapping of the reference script, not the
executor cut of the full-depth model.

    PYTHONPATH=src python examples/serve_vla_ecc_torch.py
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (NetworkSim, PredictorConfig, RoboECC,
                              Thresholds, Workload, evaluate_split,
                              fixed_split, generate_trace)
from repro_torch.core.hardware import A100, ORIN
from repro_torch.models import build
from repro_torch.runtime.partition import (SplitPlan, VLASplitExecutor,
                                           payload_bytes)

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda",
                help="where the predictor and both tiers run "
                     "(default: the card)")
dev = ap.parse_args().device

N_REQUESTS = 60

# ---- control plane on the full-size CogACT ---------------------------------
cfg_full = get_config("cogact-7b")
workload = Workload(s_new=17, decode_steps=0)
ctl = RoboECC(cfg_full, ORIN, A100, workload=workload,
              cloud_budget_bytes=12.0e9,
              thresholds=Thresholds(high=1.5e6, low=-1.5e6))
trace = generate_trace(4000, seed=11)
t0 = time.time()
ctl.fit_predictor(trace[:3000], PredictorConfig(epochs=120), device=dev)
print(f"LSTM predictor trained in {time.time() - t0:.1f}s "
      f"({ctl.predictor.n_bytes() / 1e3:.0f} KB)")
net = NetworkSim(trace[3000:])
net.step(ctl.predictor.cfg.window)
ctl.predictor.predict(net.window(ctl.predictor.cfg.window))  # warm-up
print(f"Alg.1: split {ctl.seg.split}/{len(ctl.graph)}, "
      f"pool [{ctl.pool.start},{ctl.pool.end}) "
      f"({ctl.pool.overhead_frac * 100:.2f}% overhead)")

# ---- data plane on a reduced CogACT ----------------------------------------
cfg = get_config("cogact-7b").reduced().replace(n_layers=6)
model = build(cfg)
params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
Lv = cfg.vit_layers
executor = VLASplitExecutor(cfg, SplitPlan(Lv + 1, Lv + 5, codec="int8"),
                            device=dev)

def map_split(s):
    return executor.plan.clamp(Lv + round((s / len(ctl.graph)) * cfg.n_layers))

key = 1         # one seed for every request's inputs and DiT noise
lat_ecc, lat_noadj, wire = [], [], []
ctl_static = RoboECC(cfg_full, ORIN, A100, workload=workload,
                     cloud_budget_bytes=12.0e9)
net2 = NetworkSim(trace[3000:])
net2.step(ctl.predictor.cfg.window)
for rid in range(N_REQUESTS):
    tick = ctl.tick(net)
    lat_ecc.append(tick.total_s)
    lat_noadj.append(ctl_static.tick(net2, adjust_enabled=False).total_s)
    g = torch.Generator(device=dev).manual_seed(key)
    patches = torch.randn((1, cfg.n_patches, cfg.vit_dim), generator=g,
                          device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, 17), generator=g,
                           device=dev)
    action, payload = executor.run(
        params, patches, tokens, map_split(tick.split),
        generator=torch.Generator(device=dev).manual_seed(key))
    wire.append(payload_bytes(payload))
    if rid % 20 == 0:
        print(f"  req {rid:3d}: bw {tick.bw_real_bps / 1e6:5.2f} MB/s "
              f"pred {tick.bw_pred_bps / 1e6:5.2f}  split {tick.split} "
              f"total {tick.total_s * 1e3:6.1f} ms "
              f"action {tuple(action.shape)}")

# ---- baselines (modeled, same trace) ----------------------------------------
g, edge, cloud = ctl.graph, ctl.edge_dev, ctl.cloud_dev
eo = evaluate_split(g, len(g), edge, cloud, 10e6)[0]
co = sum(evaluate_split(g, 0, edge, cloud, 10e6,
                        input_bytes=workload.input_bytes)[1:])
fx = sum(evaluate_split(g, fixed_split(g), edge, cloud, 10e6)[:3])
warm_ecc = np.mean(lat_ecc[3:])      # skip warm-up ticks
warm_noadj = np.mean(lat_noadj[3:])
print(f"\nedge-only {eo * 1e3:7.1f} ms   cloud-only {co * 1e3:7.1f} ms   "
      f"fixed-split {fx * 1e3:7.1f} ms")
print(f"RoboECC     {warm_ecc * 1e3:7.1f} ms (p95 "
      f"{np.percentile(lat_ecc[3:], 95) * 1e3:.1f})   "
      f"no-adjustment {warm_noadj * 1e3:7.1f} ms")
print(f"speedup vs edge-only: x{eo / warm_ecc:.2f}   "
      f"cut payload {np.mean(wire) / 1e3:.1f} KB (int8 codec)")
assert warm_ecc <= warm_noadj * 1.25   # overhead stays small vs baseline
print("OK")
