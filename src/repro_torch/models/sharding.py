"""ParamSpec trees and random initialisation.

Counterpart of ``src/repro/models/sharding.py`` without the mesh rules:
every parameter is declared once as a :class:`ParamSpec` that carries its
shape, its dtype and its *logical* axis names.  The axis names are kept as
data — nothing here resolves them to devices yet; the only one the port
reads today is ``"layers"``, the stacked leading dim.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from .. import require_device

Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis names
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                     # normal | zeros | ones
    scale: Optional[float] = None            # None -> 1/sqrt(fan_in)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def spec(shape, axes, dtype=torch.bfloat16, init="normal", scale=None
         ) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), dtype, init, scale)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Map ``fn`` over the leaves of nested dicts with equal keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _draw(shape, scale: float, dtype, generator, device) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def init_params(specs: Tree, generator: torch.Generator,
                device="cuda") -> Tree:
    """Materialise a random parameter tree from a ParamSpec tree.

    Drawn in float32 and cast to the spec dtype, as the JAX package does.
    Leaves are made one at a time on ``device`` and a stacked leaf one
    layer at a time, so the float32 temporary is never larger than one
    layer's weight."""
    dev = require_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator lives on {generator.device}, "
                         f"parameters are asked for on {dev}")

    def one(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=dev)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else max(s.shape[-1], 1)
        scale = s.scale if s.scale is not None else fan_in ** -0.5
        if s.axes and s.axes[0] == "layers":
            out = torch.empty(s.shape, dtype=s.dtype, device=dev)
            for i in range(s.shape[0]):
                out[i] = _draw(s.shape[1:], scale, s.dtype, generator, dev)
            return out
        return _draw(s.shape, scale, s.dtype, generator, dev)

    return tree_map(one, specs)
