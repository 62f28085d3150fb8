"""End-to-end training entry point of the port, on one device.

Counterpart of ``src/repro/launch/train.py``: builds the model, trains it
with AdamW under ``runtime.fault.Supervisor`` (checkpoint/restart, failures
injected with ``--fail-at`` for drills) on ``SyntheticStream`` batches,
and prints the loss curve.  Runs on the card unless ``--device cpu`` is
given, and raises when there is no card.

Example (the ~100M-parameter run of ``examples/train_lm_torch.py``):
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch llama3.2-3b --reduce 100m --steps 300 --batch 16 --seq 512
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from .. import require_device
from ..configs import get_config
from ..data.pipeline import DataConfig, SyntheticStream
from ..models import build
from ..runtime.fault import FaultPlan, Supervisor
from ..train.optimizer import OptConfig
from ..train.train_loop import init_state, make_train_step


def reduce_to_100m(cfg):
    """A ~100M-param member of the same family (for the e2e example)."""
    kw = dict(n_layers=8, d_model=512, n_heads=8, n_kv_heads=min(
        cfg.n_kv_heads, 8) or 0, head_dim=64, d_ff=2048,
        vocab_size=32768, scan_layers=True, remat=False)
    if cfg.n_experts:
        kw.update(n_experts=8, moe_top_k=2, moe_d_ff=512,
                  first_dense_layers=min(cfg.first_dense_layers, 1))
    if cfg.use_mla:
        kw.update(kv_lora_rank=128, qk_nope_dim=32, qk_rope_dim=16,
                  v_head_dim=32)
    if cfg.ssm_state:
        kw.update(ssm_state=64, ssm_headdim=64, ssm_chunk=128)
    return cfg.replace(**kw)


def step_generator(device):
    """key_fn of the supervisor: the step's generator, seeded from the
    step, on ``device``."""
    return lambda step: torch.Generator(device=device).manual_seed(step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--reduce", default="smoke", choices=["smoke", "100m",
                                                          "none"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", default="",
                    help="comma list of steps to inject failures (drill)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    cfg = get_config(args.arch)
    if args.reduce == "smoke":
        cfg = cfg.reduced()
    elif args.reduce == "100m":
        cfg = reduce_to_100m(cfg)
    model = build(cfg)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params={cfg.n_params()/1e6:.1f}M device={dev}")

    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    state = init_state(params)
    opt = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1))
    step_fn = make_train_step(model, opt, n_microbatches=args.microbatches)

    stream = SyntheticStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, family=cfg.family, d_model=cfg.d_model,
        n_vision_tokens=cfg.n_vision_tokens, n_patches=cfg.n_patches,
        vit_dim=cfg.vit_dim, action_dim=cfg.action_dim,
        action_horizon=cfg.action_horizon))

    fail_at = tuple(int(s) for s in args.fail_at.split(",") if s)
    with tempfile.TemporaryDirectory() as tmp:
        sup = Supervisor(args.ckpt_dir or os.path.join(tmp, "ckpt"),
                         ckpt_every=args.ckpt_every)
        t0 = time.time()
        rep = sup.run(state, stream,
                      _wrap_logging(step_fn, args.log_every, t0), args.steps,
                      key_fn=step_generator(dev),
                      fault_plan=FaultPlan(fail_at=fail_at) if fail_at
                      else None)
        dt = time.time() - t0
    print(f"done: {rep.steps_done} steps, {rep.restarts} restarts, "
          f"final loss {rep.final_loss:.4f}, {dt:.1f}s "
          f"({rep.steps_done / dt:.2f} steps/s)")
    print(f"loss curve: first={rep.losses[0]:.3f} "
          f"min={min(rep.losses):.3f} last={rep.losses[-1]:.3f}")
    return rep


def _wrap_logging(step_fn, every, t0):
    def run(state, batch, generator):
        state, metrics = step_fn(state, batch, generator)
        s = int(metrics["step"])
        if s % every == 0:
            print(f"  step {s:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"t+{time.time() - t0:.0f}s", flush=True)
        return state, metrics
    return run


if __name__ == "__main__":
    main()
