"""Parameters drawn from the seed, on the device, in the type they are
served in.

The program describes its parameter tree (shapes, dtypes, how each leaf is
initialised); the benchmark draws the values itself, so that the program
and the reference read the same tensors.  One standard-normal buffer per
dtype is drawn in a few large calls and cut into the leaves, which are
views of it, each scaled in place:

- ``normal``: by the leaf's own scale, else ``fan_in ** -0.5`` (a vector:
  0.02);
- ``zeros`` (the DiT's adaLN modulation and output, biases): drawn like a
  ``normal`` leaf, so that no part of the model multiplies by zero and
  hides from the comparison;
- ``ones`` (norm weights): ``1 + 0.1 z``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

CHUNK = 1 << 28             # elements drawn by one call


def _leaves(tree, path=()) -> List[Tuple[tuple, object]]:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


def _scale(spec) -> float:
    if spec.scale is not None:
        return float(spec.scale)
    if len(spec.shape) < 2:
        return 0.02
    return float(spec.shape[-2]) ** -0.5


def draw(specs: Dict, seed: int, device) -> Dict:
    """The parameter tree of ``specs`` drawn from ``seed`` on ``device``."""
    leaves = _leaves(specs)
    out: Dict = {}
    by_dtype: Dict[torch.dtype, list] = {}
    for path, spec in leaves:
        by_dtype.setdefault(spec.dtype, []).append((path, spec))
    for k, (dtype, group) in enumerate(sorted(by_dtype.items(),
                                              key=lambda kv: str(kv[0]))):
        total = sum(_numel(s.shape) for _, s in group)
        gen = torch.Generator(device=device)
        gen.manual_seed((seed + k) % (1 << 63))
        buf = torch.empty(total, dtype=dtype, device=device)
        for off in range(0, total, CHUNK):
            buf[off:off + CHUNK].normal_(generator=gen)
        off = 0
        for path, spec in group:
            n = _numel(spec.shape)
            leaf = buf[off:off + n].view(spec.shape)
            off += n
            if spec.init == "ones":
                leaf.mul_(0.1).add_(1.0)
            else:
                leaf.mul_(_scale(spec))
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n
