"""Run one function on N ranks of a ``torch.distributed`` group.

The ranks are ``torch.multiprocessing`` spawn children.  Each initialises
its process group explicitly, through a ``file://`` store in a directory
the caller owns (no TCP port to collide with another run on the same
machine), sets its device, calls ``fn(rank, *args)`` and saves what it
returns; the parent returns the N results in rank order.  A child that
raises makes :func:`run_ranks` raise.

Several ranks may share one card: each calls ``torch.cuda.set_device(0)``
and the group's backend is named by the caller (``gloo`` where NCCL would
refuse two ranks on one device).
"""
from __future__ import annotations

import datetime
import os
from typing import Any, Callable, List

import torch


def _child(rank: int, fn: Callable, world: int, backend: str, device: str,
           workdir: str, timeout_s: float, args: tuple) -> None:
    import torch.distributed as dist
    if backend == "hostgloo":
        from .host_group import register
        register()
    if device == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(1 if device == "cpu" else torch.get_num_threads())
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(workdir, "store"),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    out = fn(rank, *args)               # a raise ends this child non-zero
    if device == "cuda":
        torch.cuda.synchronize()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, workdir: str, *args,
              backend: str = "gloo", device: str = "cpu",
              timeout_s: float = 300.0) -> List[Any]:
    """``fn(rank, *args)`` on ``world`` spawned ranks; returns the results in
    rank order.  ``fn`` must be importable (a module-level function);
    ``workdir`` must be a fresh directory the caller owns."""
    import torch.multiprocessing as mp
    os.makedirs(workdir, exist_ok=True)
    mp.spawn(_child, args=(fn, world, backend, device, workdir, timeout_s,
                           args), nprocs=world, join=True)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]
