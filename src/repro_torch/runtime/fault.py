"""Fault tolerance: checkpoint/restart training supervisor with failure
injection.

Counterpart of ``src/repro/runtime/fault.py``: ``Supervisor.run`` drives a
train loop that survives injected step failures: on one it restores the
latest checkpoint — parameters, moments and the data stream's position —
into the live tensors and replays from there.  Batches go to the device of
the parameters; ``key_fn(step)`` gives the step's ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Optional

from ..checkpoint.ckpt import (AsyncCheckpointer, latest_step,
                               load_checkpoint, restore_into)
from ..data.pipeline import to_device
from ..models.sharding import tree_leaves

log = logging.getLogger("repro_torch.fault")

Tree = Any


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FaultPlan:
    """Deterministic failure schedule for tests: fail at these step indices
    (each fires once)."""
    fail_at: tuple = ()

    def check(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at = tuple(s for s in self.fail_at if s != step)
            raise InjectedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class RunReport:
    steps_done: int
    restarts: int
    final_loss: float
    losses: list


class Supervisor:
    def __init__(self, ckpt_dir: str, ckpt_every: int = 10,
                 max_restarts: int = 5):
        self.ckpt = AsyncCheckpointer(ckpt_dir)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts

    def run(self, state, stream, train_step: Callable, n_steps: int,
            key_fn: Callable[[int], Any],
            fault_plan: Optional[FaultPlan] = None) -> RunReport:
        device = tree_leaves(state.params)[0].device
        restarts = 0
        losses = []
        step = int(state.step)
        while step < n_steps:
            try:
                batch = to_device(stream.next(), device)
                if fault_plan is not None:
                    fault_plan.check(step)
                state, metrics = train_step(state, batch, key_fn(step))
                losses.append(float(metrics["loss"]))
                step = int(state.step)
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, {"params": state.params,
                                          "m": state.m, "v": state.v},
                                   extra={"data": stream.state(),
                                          "step": step})
            except InjectedFailure as e:
                restarts += 1
                log.warning("step %d failed (%s); restart %d", step, e,
                            restarts)
                if restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                last = latest_step(self.ckpt_dir)
                if last is None:            # no checkpoint yet: restart fresh
                    continue
                _, loaded, extra = load_checkpoint(self.ckpt_dir, last)
                restore_into(state.params, loaded["params"])
                restore_into(state.m, loaded["m"])
                restore_into(state.v, loaded["v"])
                state.step = int(extra["step"])
                stream.restore(extra["data"])
                step = int(extra["step"])
        self.ckpt.wait()
        return RunReport(steps_done=step, restarts=restarts,
                         final_loss=losses[-1] if losses else float("nan"),
                         losses=losses)
