"""End-to-end RoboECC serving entry point.

Counterpart of ``src/repro/launch/serve.py``.  Drives the full paper
pipeline on a small model executing real compute: structure+hardware
models -> Alg.1 split -> parameter-sharing pool -> LSTM predictor ->
per-request fine-grained adjustment, with the LMSplitExecutor actually
running both halves and the NetworkSim clocking the transfer.  Latency
accounting combines measured tier compute (scaled onto the modeled
devices) and simulated network time.  Runs on the card unless
``--device cpu`` asks for the CPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 100
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..core import (NetworkSim, PredictorConfig, RoboECC, Workload,
                    generate_trace)
from ..core.hardware import A100, ORIN
from ..models import build
from ..runtime.partition import LMSplitExecutor, SplitPlan, payload_bytes
from ..runtime.scheduler import MicroBatcher, Request, StragglerMitigator


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--seq", type=int, default=17)
    ap.add_argument("--codec", action="store_true",
                    help="int8 activation codec on the cut tensor")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the predictor and both tiers run "
                         "(default: the card)")
    args = ap.parse_args(argv)

    # --- control plane: full-size cost models drive the split decision
    cfg_full = get_config(args.arch)
    ctl = RoboECC(cfg_full, ORIN, A100,
                  workload=Workload(s_new=args.seq),
                  cloud_budget_bytes=0.9 * cfg_full.n_params() * 2,
                  use_codec=args.codec)
    trace = generate_trace(4000, seed=args.seed)
    ctl.fit_predictor(trace[:3000], PredictorConfig(epochs=120),
                      device=args.device)
    net = NetworkSim(trace[3000:])
    net.step(ctl.predictor.cfg.window)
    print(f"Alg.1 split: {ctl.seg.split}/{len(ctl.graph)} "
          f"pool=[{ctl.pool.start},{ctl.pool.end}) "
          f"overhead={ctl.pool.overhead_frac*100:.2f}%")

    # --- data plane: reduced model actually executes both halves here
    cfg = cfg_full.reduced().replace(n_layers=8)
    model = build(cfg)
    params = model.init(torch.Generator(device=args.device).manual_seed(0),
                        args.device)
    n = cfg.n_layers
    pool_lo = max(n // 2 - 1, 0)
    ex = LMSplitExecutor(cfg, SplitPlan(pool_lo, min(pool_lo + 3, n),
                                        codec="int8" if args.codec else ""),
                         device=args.device)

    # map the control-plane split into the reduced model's pool range
    def map_split(s):
        frac = s / max(len(ctl.graph), 1)
        return ex.plan.clamp(int(round(frac * n)))

    batcher = MicroBatcher(batch_size=4, max_wait_s=0.02)
    straggler = StragglerMitigator()
    lat, wire, adj = [], [], []
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    for rid in range(args.requests):
        batcher.add(Request(rid, time.time(), args.seq))
        b = batcher.maybe_form(time.time())
        if b is None:
            continue
        tick = ctl.tick(net)
        split = map_split(tick.split)
        tokens = torch.randint(0, cfg.vocab_size,
                               (len(b.requests), args.seq), generator=gen,
                               device=args.device)
        t0 = time.time()
        logits, payload = ex.run(params, tokens, split)
        if logits.is_cuda:
            torch.cuda.synchronize(logits.device)
        host_s = time.time() - t0
        lat.append(tick.total_s)
        wire.append(payload_bytes(payload))
        if tick.decision is not None:
            adj.append(tick.adjust_overhead_s)
    print(f"served {args.requests} requests in {len(lat)} batches")
    print(f"modeled total latency: mean {np.mean(lat)*1e3:.1f}ms "
          f"p95 {np.percentile(lat, 95)*1e3:.1f}ms")
    print(f"cut payload: {np.mean(wire)/1e3:.1f} KB/request "
          f"(codec={'on' if args.codec else 'off'})")
    if adj:
        print(f"adjustment overhead: mean {np.mean(adj[1:])*1e3:.2f}ms")


if __name__ == "__main__":
    main()
