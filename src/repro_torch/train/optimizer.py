"""AdamW on one device.

Counterpart of ``src/repro/train/optimizer.py``: parameters keep their
dtype (bf16 as the specs make them), the moments are float32, the global
gradient norm is clipped in float32 and every update is computed in
float32 and cast back to the parameter's dtype.  Where the JAX package
returns new trees, the port updates each leaf in place, one leaf at a
time: a stacked leaf of Llama-3.2-3B holds 704.6 M elements (2.82 GB per
float32 temporary), so a chain of temporaries per leaf would add several
times that on top of the state.  The step's scalars (learning rate, bias
corrections) are float32 on the host; the clip's scale is read back from
the card, the step's one wait, before the first update.

On a mesh (``models/sharding.py``) parameters, gradients and moments are
``DTensor`` s with the parameters' placements, and every update runs on
each rank's local shard in place (the update is elementwise); the norm
sums each rank's local squares and reduces them over the mesh dims the
leaves are sharded on.  The moments follow the parameters' placements, as
the JAX train step keeps them (``init_state``), or those of
:func:`opt_state_specs` under :func:`zero_rules` (the JAX package's ZeRO-1
specs, copied: sharded over the data axes on their largest replicated
dim), as the dry run places them: each rank then updates its part of a
parameter and the parts are gathered (:func:`_zero1_update`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.sharding import (ParamSpec, is_dtensor, resolve, spec,
                               tree_leaves, tree_map_specs)

Tree = Any


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def opt_state_specs(param_specs: Tree, mesh=None, rules: Optional[Dict] = None,
                    zero1: bool = True) -> Tree:
    """fp32 moment ParamSpecs; with zero1, shard the largest currently-
    replicated dim over the data axes."""
    data_axes = tuple(a for a in ("pod", "data")
                      if mesh is not None and a in mesh.axis_names)
    data_size = 1
    if mesh is not None:
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        for a in data_axes:
            data_size *= sizes[a]

    def one(s: ParamSpec) -> ParamSpec:
        axes = list(s.axes)
        if zero1 and mesh is not None and data_size > 1:
            pspec = resolve(s.axes, rules)
            # don't double-map mesh axes the param sharding already uses
            # (FSDP params already consume `data`)
            used = set()
            for e in pspec:
                for a in ((e,) if isinstance(e, str) else (e or ())):
                    used.add(a)
            if not used.intersection(data_axes):
                cands = [(dim, i) for i, dim in enumerate(s.shape)
                         if pspec[i] is None and dim % data_size == 0]
                if cands:
                    _, i = max(cands)
                    axes[i] = "__zero__"
        return spec(s.shape, tuple(axes), dtype=torch.float32, init="zeros")

    return tree_map_specs(one, param_specs)


def zero_rules(rules: Dict, mesh) -> Dict:
    """Extend model rules with the ZeRO axis mapping."""
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    out = dict(rules)
    out["__zero__"] = data_axes if data_axes else None
    return out


def lr_at(cfg: OptConfig, step: int) -> float:
    """Linear warm-up to ``cfg.lr``, in float32 as the JAX package has it."""
    f32 = np.float32
    warm = np.minimum((f32(step) + f32(1.0)) / f32(max(cfg.warmup_steps, 1)),
                      f32(1.0))
    return float(f32(cfg.lr) * warm)


# elements a float32 temporary of the norm holds at most
_NORM_CHUNK = 1 << 24


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    """sum(g**2) in float32, a chunk of the flattened leaf at a time (each
    chunk's sum is the library's pairwise one; ``torch.linalg.vector_norm``
    on the CPU sums a 10^8-element float32 leaf 3 % low)."""
    flat = g.reshape(-1)
    return sum(flat[i:i + _NORM_CHUNK].float().square().sum()
               for i in range(0, flat.numel(), _NORM_CHUNK))


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (its storage: in-place updates land in the
    DTensor), or the tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def _global_square_sum(leaves) -> torch.Tensor:
    """sum(g**2) over all leaves, float32.  A DTensor leaf adds its local
    shard's squares; the leaves sharded over the same mesh dims are summed
    first and each such group is reduced once over those dims."""
    plain = [g for g in leaves if not is_dtensor(g)]
    total = sum(_square_sum(g) for g in plain) if plain else None
    groups: Dict[tuple, torch.Tensor] = {}
    for g in leaves:
        if is_dtensor(g):
            key = (g.device_mesh, tuple(i for i, pl in enumerate(g.placements)
                                        if pl.is_shard()))
            part = _square_sum(g.to_local())
            groups[key] = part if key not in groups else groups[key] + part
    if groups:
        from torch.distributed.tensor import DTensor, Partial, Replicate
        for (dm, dims), part in groups.items():
            pl = [Partial() if i in dims else Replicate()
                  for i in range(dm.ndim)]
            full = DTensor.from_local(part, dm, pl).full_tensor()
            total = full if total is None else total + full
    return total


@torch.no_grad()
def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale every gradient in place by ``min(1, max_norm / (norm +
    1e-9))``, in float32 and cast back to the gradient's dtype; returns
    (grads, the float32 norm before clipping)."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(_global_square_sum(leaves))
    # read back as a Python number: a Python scale multiplies each element
    # in float32 (the operation's compute type for bf16) and rounds once to
    # the gradient's dtype, where a 0-dim float32 tensor would itself be
    # rounded to bf16 on the card first; a scale of 1 changes nothing
    scale = float(torch.clamp(max_norm / (gn + 1e-9), max=1.0))
    if not scale >= 1.0:
        for g in leaves:
            _local(g).mul_(scale)
    return grads, gn


def _bias_corrections(cfg: OptConfig, step: int) -> Tuple[float, float]:
    f32 = np.float32
    t = f32(step) + f32(1.0)
    return (float(f32(1.0) - f32(cfg.b1) ** t),
            float(f32(1.0) - f32(cfg.b2) ** t))


@torch.no_grad()
def _update_leaf(cfg: OptConfig, p, g, m, v, lr: float, bc1: float,
                 bc2: float) -> None:
    """The JAX package's ``upd`` for one leaf, in its order of operations,
    with at most two float32 temporaries of the leaf's size alive; ``g``
    is left as it came."""
    g32 = g.float()                                 # g itself if float32
    t = g32 * (1 - cfg.b1)
    m.mul_(cfg.b1).add_(t)
    torch.mul(g32, 1 - cfg.b2, out=t).mul_(g32)
    v.mul_(cfg.b2).add_(t)
    del g32
    torch.div(m, bc1, out=t)                        # m_hat
    w = torch.div(v, bc2).sqrt_().add_(cfg.eps)     # sqrt(v_hat) + eps
    t.div_(w)
    p32 = p if p.dtype == torch.float32 else w.copy_(p)
    t.add_(torch.mul(p32, cfg.weight_decay, out=w)).mul_(lr)
    if p.dtype == torch.float32:
        p.sub_(t)
    else:
        p.copy_(w.copy_(p).sub_(t))                 # float32, then p's dtype


@torch.no_grad()
def adamw_update(cfg: OptConfig, params: Tree, grads: Tree, m: Tree, v: Tree,
                 step: int) -> Tuple[Tree, Tree, Tree, torch.Tensor]:
    """One AdamW step at ``step`` (0-based): clips ``grads`` and updates
    ``params``, ``m`` and ``v`` in place; returns them with the gradient
    norm before clipping.  On a mesh all four trees are DTensors with the
    same placements leaf by leaf (the gradients reduced to the
    parameters' placements)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    lr = lr_at(cfg, step)
    bc1, bc2 = _bias_corrections(cfg, step)
    for p, g, m_, v_ in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(m), tree_leaves(v)):
        if is_dtensor(m_) and tuple(m_.placements) != tuple(p.placements):
            _zero1_update(cfg, p, g, m_, v_, lr, bc1, bc2)
            continue
        _update_leaf(cfg, _local(p), _local(g), _local(m_), _local(v_), lr,
                     bc1, bc2)
    return params, m, v, gnorm


def _zero1_update(cfg: OptConfig, p, g, m, v, lr: float, bc1: float,
                  bc2: float) -> None:
    """A leaf whose moments are sharded further than the parameter (ZeRO-1,
    ``opt_state_specs``: over the data axes): each rank updates its part of
    the parameter against its part of the moments, and the parts are
    gathered back into every rank's copy."""
    dm, pl = m.device_mesh, m.placements
    part = p.redistribute(dm, pl)
    _update_leaf(cfg, part.to_local(), g.redistribute(dm, pl).to_local(),
                 m.to_local(), v.to_local(), lr, bc1, bc2)
    p.to_local().copy_(part.redistribute(dm, p.placements).to_local())
