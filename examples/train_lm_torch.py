"""Train a ~100M-param llama-family model for a few hundred steps, with a
mid-run injected failure to demonstrate checkpoint/restart, on the
PyTorch port (the twin of ``examples/train_lm.py``).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--device cpu]
"""
import argparse
import tempfile
import time

import torch

from repro_torch import require_device
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.launch.train import reduce_to_100m, step_generator
from repro_torch.models import build
from repro_torch.runtime.fault import FaultPlan, Supervisor
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_loop import init_state, make_train_step

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--seq", type=int, default=256)
ap.add_argument("--d-model", type=int, default=512)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = require_device(args.device)

cfg = reduce_to_100m(get_config("llama3.2-3b")).replace(
    d_model=args.d_model)
model = build(cfg)
print(f"model: {cfg.n_params() / 1e6:.1f}M params "
      f"({cfg.n_layers}L d{cfg.d_model})")

state = init_state(model.init(torch.Generator(device=dev).manual_seed(0),
                              dev))
step_fn = make_train_step(
    model, OptConfig(lr=6e-4, warmup_steps=args.steps // 10),
    n_microbatches=2)
stream = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    global_batch=args.batch, seed=1))

t0 = time.time()
logged = {"last": t0}


def logging_step(state, batch, generator):
    state, m = step_fn(state, batch, generator)
    s = int(m["step"])
    if s % 20 == 0:
        now = time.time()
        print(f"  step {s:4d}  loss {float(m['loss']):7.4f}  "
              f"gnorm {float(m['grad_norm']):6.2f}  "
              f"{20 / (now - logged['last'] + 1e-9):.2f} steps/s", flush=True)
        logged["last"] = now
    return state, m


with tempfile.TemporaryDirectory() as ckpt_dir:
    sup = Supervisor(ckpt_dir, ckpt_every=50)
    report = sup.run(state, stream, logging_step, args.steps,
                     key_fn=step_generator(dev),
                     fault_plan=FaultPlan(fail_at=(args.steps // 2,)))

dt = time.time() - t0
tok_s = report.steps_done * args.batch * args.seq / dt
print(f"\n{report.steps_done} steps in {dt:.0f}s ({tok_s:,.0f} tok/s), "
      f"{report.restarts} restart(s) survived")
print(f"loss: {report.losses[0]:.3f} -> {report.losses[-1]:.3f}")
assert report.losses[-1] < report.losses[0] * 0.7, "training must converge"
print("OK")
