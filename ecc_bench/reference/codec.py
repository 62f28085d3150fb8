"""A frozen plain copy of the activation codecs' wire arithmetic.

int8: per (row, 128-column block) scale ``amax * (1 / 127)`` in float32
(1 where the block is all zero), codes ``round(x / scale)`` clamped to
[-127, 127].  int4: the same with 7, codes biased to [0, 14] and packed two
to a byte, element ``j`` of a 256-column tile in the low nibble and
``j + 128`` in the high one, stored with a -128 offset.  Dequantizing
multiplies the codes by their block's scale.  Everything here computes in
float32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

BLOCK = 128


def block_of(D: int) -> int:
    """The int8 block the wire format uses for rows of width ``D``."""
    return BLOCK if D % BLOCK == 0 else D


def _scales(xb: torch.Tensor, qmax: int) -> torch.Tensor:
    amax = xb.abs().amax(dim=-1, keepdim=True)
    return torch.where(amax > 0, amax * (1.0 / qmax), torch.ones_like(amax))


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    *lead, D = x.shape
    blk = block_of(D)
    xb = x.float().reshape(*lead, D // blk, blk)
    s = _scales(xb, 127)
    q = torch.clamp(torch.round(xb / s), -127, 127).to(torch.int8)
    return q.reshape(*lead, D), s[..., 0]


def dequantize_int8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    *lead, D = q.shape
    blk = D // s.shape[-1]
    out = q.reshape(*lead, D // blk, blk).float() * s[..., None].float()
    return out.reshape(*lead, D)


def quantize_int4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    *lead, D = x.shape
    if D % (2 * BLOCK):
        raise ValueError(f"int4 needs rows of a multiple of {2 * BLOCK}, "
                         f"got {D}")
    xb = x.float().reshape(*lead, D // BLOCK, BLOCK)
    s = _scales(xb, 7)
    q = torch.clamp(torch.round(xb / s), -7, 7).to(torch.int32) + 7
    q = q.reshape(*lead, D // (2 * BLOCK), 2, BLOCK)
    packed = q[..., 0, :] + 16 * q[..., 1, :] - 128
    return packed.to(torch.int8).reshape(*lead, D // 2), s[..., 0]


def dequantize_int4(packed: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    *lead, Dh = packed.shape
    D = 2 * Dh
    p = packed.reshape(*lead, D // (2 * BLOCK), BLOCK).to(torch.int32) + 128
    q = torch.stack([p % 16 - 7, torch.div(p, 16, rounding_mode="floor") - 7],
                    dim=-2)
    out = q.float() * s.reshape(*lead, D // (2 * BLOCK), 2, 1).float()
    return out.reshape(*lead, D)


def roundtrip(x: torch.Tensor, codec: str) -> torch.Tensor:
    """What the cloud reads of ``x`` after the wire: float32."""
    if not codec:
        return x.float()
    if codec == "int8":
        return dequantize_int8(*quantize_int8(x))
    if codec == "int4":
        return dequantize_int4(*quantize_int4(x))
    raise ValueError(f"no codec {codec!r}")


def decode_payload(payload: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The activation a shipped payload carries, in float32: ``x`` raw,
    ``q`` and ``s`` int8, ``q4`` and ``s`` packed int4."""
    if "x" in payload:
        return payload["x"].float()
    if "q4" in payload:
        return dequantize_int4(payload["q4"], payload["s"])
    return dequantize_int8(payload["q"], payload["s"])
