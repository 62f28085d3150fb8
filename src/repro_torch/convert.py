"""Carry parameter trees of the JAX package across as numpy arrays.

The parity tests initialise on the JAX side, turn every leaf into a numpy
array and hand the tree to :func:`from_numpy_tree`; both packages then run
on identical weights.  numpy has no bfloat16, so a bf16 leaf travels as
float32 (exact: every bf16 value is a float32 value) and is cast back to
the spec dtype here (exact again).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from . import require_device
from .models.sharding import is_spec

Tree = Any


def from_numpy_tree(tree: Tree, device="cuda",
                    dtype: Optional[torch.dtype] = None,
                    specs: Optional[Tree] = None) -> Tree:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``.

    Same nesting, same shapes, weights stay ``(d_in, d_out)`` and stacked
    leaves keep their leading ``(layers, ...)`` dim.  With ``specs`` (a
    ParamSpec tree) the nesting and shapes are checked against it — a
    missing key, an extra key or a wrong shape raises — and each leaf is
    cast to its spec dtype.  Otherwise floating leaves are cast to
    ``dtype`` when one is given."""
    dev = require_device(device)
    return _convert(tree, specs, dev, dtype, "")


def _convert(tree, specs, dev, dtype, path):
    if isinstance(tree, dict):
        if specs is not None:
            if not isinstance(specs, dict):
                raise KeyError(f"{path or '<root>'}: tree has a dict where "
                               "the specs have a leaf")
            missing = sorted(set(specs) - set(tree))
            extra = sorted(set(tree) - set(specs))
            if missing or extra:
                raise KeyError(f"{path or '<root>'}: missing keys {missing}, "
                               f"extra keys {extra}")
        return {k: _convert(v, None if specs is None else specs[k], dev,
                            dtype, f"{path}/{k}") for k, v in tree.items()}
    if specs is not None and not is_spec(specs):
        raise KeyError(f"{path}: tree has a leaf where the specs have a dict")
    t = torch.from_numpy(np.array(tree, copy=True)).to(dev)    # own memory
    if specs is not None:
        if tuple(t.shape) != tuple(specs.shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)} != spec "
                             f"{tuple(specs.shape)}")
        return t.to(specs.dtype)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


LSTM_KEYS = ("wx", "wh", "b", "head")


def lstm_params_from_numpy(tree: dict, device="cuda") -> dict:
    """The JAX package's LSTM predictor parameters (``init_lstm`` or a
    trained ``Predictor.params``, as numpy) -> the port's, so that
    ``repro_torch.core.predictor.lstm_forward`` computes what the JAX
    ``lstm_forward`` does.  Both keep the same keys and layouts: ``wx``
    ``(1, 4H)``, ``wh`` ``(H, 4H)``, ``b`` ``(4H,)``, ``head`` ``(H, 1)``,
    the gates ``i, f, o, u`` in that order along the ``4H`` axis."""
    if set(tree) != set(LSTM_KEYS):
        raise KeyError(f"LSTM parameters have keys {sorted(tree)}, "
                       f"expected {sorted(LSTM_KEYS)}")
    H = np.shape(tree["wh"])[0]
    want = {"wx": (1, 4 * H), "wh": (H, 4 * H), "b": (4 * H,),
            "head": (H, 1)}
    for k, shape in want.items():
        if tuple(np.shape(tree[k])) != shape:
            raise ValueError(f"LSTM parameter {k}: shape "
                             f"{tuple(np.shape(tree[k]))} != {shape}")
    return from_numpy_tree(tree, device, dtype=torch.float32)
