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

On a mesh (``models/sharding.py``: the parameters ``DTensor`` s, the
batch placed by ``data/pipeline.py::shard_batch``, the step run under
``use_mesh``) the loss is the global batch's, and autograd leaves each
gradient as a sum still pending over the ranks that saw other tokens
(``Partial``).  Without compression the gradients are reduced to their
parameters' placements; with ``grad_compression="int8_ring"`` the pending
sum over the data axes is the int8 ring's (:func:`_compressed_sync`), under
the ``fsdp`` rules too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..models.sharding import current_mesh, is_dtensor, tree_leaves, tree_map
from .compression import ring_allreduce_int8
from .optimizer import OptConfig, adamw_update

Tree = Any


@dataclasses.dataclass
class TrainState:
    step: int
    params: Tree
    m: Tree
    v: Tree


def init_state(params: Tree) -> TrainState:
    """Step 0 with float32 moments at zero, beside ``params`` (with their
    placements on a mesh)."""
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
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
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), state.params)
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
            grads = _compressed_sync(grads, state.params)
        else:
            grads = _reduce_to_params(grads, state.params)
        if is_dtensor(loss):
            loss = loss.full_tensor()
        _, _, _, gnorm = adamw_update(opt, state.params, grads, state.m,
                                      state.v, state.step)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": state.step}
        state.step += 1
        return state, metrics

    return train_step


def _reduce_to_params(grads: Tree, params: Tree) -> Tree:
    """Each DTensor gradient redistributed to its parameter's placements
    (its pending sums reduced); plain gradients as they are."""
    return tree_map(lambda g, p: g.redistribute(p.device_mesh, p.placements)
                    if is_dtensor(g) else g, grads, params)


def _data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _compressed_sync(grads: Tree, params: Tree) -> Tree:
    """The int8 ring all-reduce over the data axes.

    With no mesh, or plain tensors, there is nothing to reduce and the
    gradients come back unchanged, as the JAX package returns them with no
    mesh.  The JAX package rings every gradient whole: a ``shard_map``
    whose specs are ``P()`` gathers each one, replicated on every device,
    rings it over each data axis and places the result back as its
    parameter.  So does this, leaf by leaf, for every gradient still
    pending (``Partial``) over a data axis: it is gathered over the data
    axes (the ``fsdp`` rules shard it there); its pending sums over the
    other mesh axes are reduced, by ``redistribute``, and it keeps its
    parameter's placements there; each data axis that still holds a
    pending sum is rung; the sum is then placed as the parameter.  A
    gradient already summed over every data axis (replicated there, or
    sharded: under ``fsdp`` autograd reduce-scatters the gradient of a
    weight that a product gathered) has nothing for the ring and is placed
    as its parameter exact, where the JAX package rings that sum too.

    The semantics differ from the JAX package's on purpose: under pjit its
    gradients are already averaged over the data axes, so it rings N equal
    copies and divides by N; a DTensor gradient is still a pending sum
    over the data axes, and ring-summing those partials gives the global
    gradient without a division.  Both give the global gradient plus the
    ring's noise."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = current_mesh()
    if mesh is None or mesh.device_mesh is None:
        return grads
    names = mesh.axis_names
    data = [i for i, ax in enumerate(names)
            if ax in _data_axes(mesh) and mesh.shape[ax] > 1]

    def one(g, p):
        if not is_dtensor(g):
            return g
        dm = p.device_mesh
        if not any(g.placements[i].is_partial() for i in data):
            # summed over data already (sharded or replicated there):
            # nothing for the ring
            return g.redistribute(dm, p.placements)
        mid = [(Replicate() if g.placements[i].is_shard() else
                g.placements[i]) if i in data else p.placements[i]
               for i in range(len(names))]
        # (a data axis sharded here, beside one that is pending, is
        # gathered: the ring sums whole tensors over each data axis)
        local = g.redistribute(dm, mid).to_local()
        for i in data:
            if mid[i].is_partial():
                local = ring_allreduce_int8(local, names[i])
        summed = [Replicate() if i in data else mid[i]
                  for i in range(len(names))]
        return DTensor.from_local(local, dm, summed, shape=p.shape,
                                  stride=p.stride()).redistribute(
            dm, p.placements)

    return tree_map(one, grads, params)
