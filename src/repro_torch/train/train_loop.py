"""The train step on one device.

Counterpart of ``src/repro/train/train_loop.py``: ``make_train_step``
builds ``train_step(state, batch, generator=None) -> (state, metrics)``,
which takes the loss's gradient with autograd, averages it over
``n_microbatches`` in float32, optionally passes it through the int8 ring
(``grad_compression="int8_ring"``) and applies AdamW.  The state's
tensors are updated in place and the state is returned.

The gradients are those of ``Model.loss_fn`` as written: on the card,
flash attention (B5) and the SSD scan (B7) launch their kernels in the
forward and differentiate their plain versions in the backward
(``FlashAttentionFn``, ``SSDScanFn``); with ``cfg.remat`` each layer is
recomputed in the backward, so those kernels launch twice a layer a step.

A VLA's loss draws from ``generator``; every microbatch starts from the
generator's state at the start of the step, as every microbatch of the
JAX package takes the step's one key.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..models.sharding import tree_leaves, tree_map
from .optimizer import OptConfig, adamw_update

Tree = Any


@dataclasses.dataclass
class TrainState:
    step: int
    params: Tree
    m: Tree
    v: Tree


def init_state(params: Tree) -> TrainState:
    """Step 0 with float32 moments at zero, beside ``params``."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    return TrainState(0, params, zeros, tree_map(torch.clone, zeros))


def _split_micro(batch: Dict, n: int) -> List[Dict]:
    return [{k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
             for k, v in batch.items()} for i in range(n)]


def loss_and_grads(model, params: Tree, batch: Dict,
                   generator: Optional[torch.Generator] = None, **inject
                   ) -> Tuple[torch.Tensor, Tree]:
    """(loss, gradient tree): each gradient in its parameter's dtype, zeros
    where the loss does not reach a parameter (as ``jax.grad`` gives).
    ``inject`` goes to a VLA's ``loss_fn`` (its ``t`` / ``noise``)."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss_fn(params, batch, generator, **inject)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(model, opt: OptConfig, *, n_microbatches: int = 1,
                    grad_compression: Optional[str] = None) -> Callable:
    """Returns train_step(state, batch, generator=None) -> (state,
    metrics) with ``metrics`` = {"loss", "grad_norm"} (0-dim float32
    tensors on the device) and "step" (the step before this one)."""
    if grad_compression not in (None, "int8_ring"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}")

    def train_step(state: TrainState, batch: Dict,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict]:
        n = n_microbatches
        if n > 1:
            start = None if generator is None else generator.get_state()
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            losses = []
            for mb in _split_micro(batch, n):
                if start is not None:
                    generator.set_state(start)
                l, g = loss_and_grads(model, state.params, mb, generator)
                for a, b in zip(tree_leaves(grads), tree_leaves(g)):
                    a.add_(b)
                losses.append(l)
            for a in tree_leaves(grads):
                a.div_(n)
            loss = sum(losses) / n
        else:
            loss, grads = loss_and_grads(model, state.params, batch,
                                         generator)
        if grad_compression == "int8_ring":
            grads = _compressed_sync(grads)
        _, _, _, gnorm = adamw_update(opt, state.params, grads, state.m,
                                      state.v, state.step)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": state.step}
        state.step += 1
        return state, metrics

    return train_step


def _compressed_sync(grads: Tree) -> Tree:
    """The int8 ring all-reduce over the data-parallel ranks.  With no
    process group (one device) there is nothing to reduce and the
    gradients come back unchanged, as the JAX package returns them with no
    mesh; across ranks it is not ported yet."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return grads
    raise NotImplementedError("the int8 ring all-reduce across ranks comes "
                              "with the port's SPMD slice")
