"""Device meshes.

Counterpart of ``src/repro/launch/mesh.py``.  A :class:`Mesh` names its
axes and their sizes, as a JAX ``Mesh`` does: ``axis_names`` and
``devices`` (here an array of rank ids of the mesh's shape, so that
``dict(zip(mesh.axis_names, mesh.devices.shape))`` reads the sizes as it
does in the JAX package).  An *unbound* mesh is only that: the spec
arithmetic (``make_rules``, ``opt_state_specs``, ``spec_bytes`` per
device) runs on it and no process exists for it.  A *bound* mesh also
holds the ``torch.distributed`` ``DeviceMesh`` of the calling process's
group, with the same dimension names; parameters and activations are then
``DTensor`` s on it (``models/sharding.py``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


class Mesh:
    """Axis names and sizes, optionally bound to a ``DeviceMesh``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device_mesh=None):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names "
                             f"{axis_names} differ in length")
        self.axis_names: Tuple[str, ...] = axis_names
        self.devices = np.arange(int(np.prod(shape))).reshape(shape)
        self.device_mesh = device_mesh

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def bound(self) -> bool:
        return self.device_mesh is not None

    def local_rank(self, name: str) -> int:
        """This process's index along axis ``name`` (0 on an unbound
        mesh or an axis the mesh lacks)."""
        if self.device_mesh is None or name not in self.axis_names:
            return 0
        return self.device_mesh.get_local_rank(name)

    def __repr__(self) -> str:
        dims = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        return f"Mesh({dims}{', bound' if self.bound else ''})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's production mesh, (16, 16) or (2, 16, 16), unbound:
    for spec arithmetic only."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_host_mesh() -> Mesh:
    """The (1, 1) mesh of the calling process (same axis names)."""
    return Mesh((1, 1), ("data", "model"))


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device: Optional[str] = None) -> Mesh:
    """A mesh bound to the calling process group, which must already be
    initialised with ``prod(shape)`` ranks.  ``device`` is the ranks'
    device type ("cuda" or "cpu"; default: the card when there is one).
    Ranks fill the mesh in row-major order, as JAX fills its devices."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised process group")
    n = int(np.prod(shape))
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the group "
                         f"has {dist.get_world_size()}")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    # DeviceMesh(...) and not init_device_mesh: the latter would also pick
    # the card for each rank by its local rank, where several ranks may
    # share one card (each rank has set its device already)
    dm = DeviceMesh(device, torch.arange(n).reshape(tuple(shape)),
                    mesh_dim_names=tuple(axis_names))
    return Mesh(shape, axis_names, dm)
