"""Gradient compression: per-tensor int8 with error feedback.

Counterpart of the single-device part of ``src/repro/train/compression.py``
(``_quant``, ``_dequant``, ``ef_compress``): one float32 scale a tensor,
``amax / 127``, in plain PyTorch, as the JAX package writes it (it uses no
codec kernel here).  The int8 ring all-reduce itself
(``ring_allreduce_int8``, ``compressed_psum_tree``) runs across ranks and
comes with the port's SPMD slice.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..models.sharding import tree_leaves, tree_map

Tree = Any


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), \
        scale


def _dequant(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.float() * s


def ef_compress(grads: Tree, ef: Tree) -> Tuple[Tree, Tree]:
    """One-shot int8 quantisation with error feedback: returns (the
    dequantised gradients to feed the ring, the new residual)."""
    pairs = []
    for g, e in zip(tree_leaves(grads), tree_leaves(ef)):
        tgt = g.float() + e
        deq = _dequant(*_quant(tgt))
        pairs.append((deq.to(g.dtype), tgt - deq))
    it1, it2 = iter(pairs), iter(pairs)
    return (tree_map(lambda _: next(it1)[0], grads),
            tree_map(lambda _: next(it2)[1], ef))
