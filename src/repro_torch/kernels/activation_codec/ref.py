"""Plain PyTorch versions of the activation codecs (int8 and packed int4).

Counterpart of ``src/repro/kernels/activation_codec/ref.py``.  What ships
on the wire in the JAX package is the *jitted* ``ops.quantize``, and under
``jit`` XLA turns ``amax / 127.0`` into ``amax * (1/127)``; so the scale
here is the constant multiply (float32) and the value a true division
``x / scale`` — which reproduces the jitted payload, scales and
dequantised output bit for bit, for float32 and bfloat16 input.

int4 packing layout: elements are quantised to [-7, 7], biased to [0, 14],
and within each 256-column tile byte ``j`` holds element ``j`` (low
nibble) and element ``j + 128`` (high nibble), stored as int8 with a -128
offset.  The layout is part of the wire format.
"""
from __future__ import annotations

from typing import Tuple

import torch

BLOCK = 128
PAIR = 2 * BLOCK


def _scales(xb: torch.Tensor, qmax: int) -> torch.Tensor:
    amax = xb.abs().amax(dim=-1, keepdim=True)
    return torch.where(amax > 0, amax * (1.0 / qmax), torch.ones_like(amax))


def quantize_int8(x: torch.Tensor, block: int = BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., D) with D % block == 0 -> (int8 (..., D), f32 scales (..., D/block))."""
    *lead, D = x.shape
    if D % block != 0:
        raise ValueError(f"last dim {D} is not a multiple of block {block}")
    xb = x.float().reshape(*lead, D // block, block)
    scale = _scales(xb, 127)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q.reshape(*lead, D), scale[..., 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.bfloat16, block: int = BLOCK) -> torch.Tensor:
    *lead, D = q.shape
    xb = q.reshape(*lead, D // block, block).float()
    out = xb * scale[..., None]
    return out.reshape(*lead, D).to(dtype)


def wire_bytes(shape, block: int = BLOCK) -> int:
    """Bytes on the network for an int8-quantised activation of `shape`."""
    n = 1
    for d in shape:
        n *= d
    return n + (n // block) * 4


# ------------------------------------------------------------------- int4
def quantize_int4(x: torch.Tensor, block: int = BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., D) with D % (2*block) == 0 -> (int8 packed (..., D/2),
    f32 scales (..., D/block))."""
    *lead, D = x.shape
    if D % (2 * block) != 0:
        raise ValueError(f"last dim {D} is not a multiple of 2 * {block}")
    xb = x.float().reshape(*lead, D // block, block)
    scale = _scales(xb, 7)
    q = torch.clamp(torch.round(xb / scale), -7, 7).to(torch.int32) + 7
    q = q.reshape(*lead, D // (2 * block), 2, block)   # pair of blocks
    packed = q[..., 0, :] + 16 * q[..., 1, :] - 128    # in [-128, 110]
    return packed.to(torch.int8).reshape(*lead, D // 2), scale[..., 0]


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.bfloat16, block: int = BLOCK) -> torch.Tensor:
    *lead, Dh = packed.shape
    D = 2 * Dh
    p = packed.reshape(*lead, D // (2 * block), block).to(torch.int32) + 128
    lo = p % 16 - 7
    hi = torch.div(p, 16, rounding_mode="floor") - 7
    q = torch.stack([lo, hi], dim=-2)                  # (..., pairs, 2, block)
    sb = scale.reshape(*lead, D // (2 * block), 2, 1).float()
    out = q.float() * sb
    return out.reshape(*lead, D).to(dtype)


def wire_bytes_int4(shape, block: int = BLOCK) -> int:
    """Bytes on the network for a packed-int4 activation of `shape`."""
    n = 1
    for d in shape:
        n *= d
    return n // 2 + (n // block) * 4
