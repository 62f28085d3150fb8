"""Public wrappers for the activation codecs (int8 + packed int4).

Counterpart of ``src/repro/kernels/activation_codec/ops.py``.  Arbitrary
rank is flattened to ``(rows, D)``.

``quantize`` / ``dequantize`` replace the TPU kernels
``quantize_int8_pallas`` / ``dequantize_int8_pallas``, and
``quantize_int4`` / ``dequantize_int4`` replace ``quantize_int4_pallas`` /
``dequantize_int4_pallas``, of ``src/repro/kernels/activation_codec/
kernel.py``, with the CUDA kernels of ``csrc/activation_codec.cu``.  All
four are bound by bytes on the card (each element read once and written
once, a handful of operations each), and at the served size (273 x 4096,
a few megabytes already in L2) a call lasts about as long as the card
takes to start and drain a grid.  Both codecs (redesigned for Hopper):
one warp per (row, 128-column block) for int8 and per (row, 256-column
tile) for int4, launched as programmatic dependent launches so that the
grid is resident while the kernel ahead finishes, the block abs-max by one
warp reduction over the float bits, no conversion instruction per element,
and the rounding by a reciprocal product that takes the IEEE division only
within a margin of a half-integer (2^-15 for int8, 2^-18 for int4), where
a scale lies below FLT_MIN or in a block holding a NaN, which keeps it
bit-equal to ``torch.round(x / s)`` for finite inputs (the argument, and
what the kernels give for NaN and Inf, are in the source's header).  On
the host a call allocates its outputs with ``new_empty`` (cheaper than
``torch.empty`` with a device) and reads the stream's raw handle
(``_stream``): on the H100 machine the allocations and the ``Stream``
object were the largest shares of a call's host time.

Dispatch is by where the tensor lies, nothing else: a CPU tensor takes the
plain version (``quantize_plain`` / ``dequantize_plain`` /
``quantize_int4_plain`` / ``dequantize_int4_plain``), a CUDA tensor
launches the kernel or the call raises.  int8 takes any block width that
divides the row: 128 columns by its own kernel, another width (the JAX
package's rule for widths such as the reduced ``d_model = 64``, where one
block spans the row) by a general one.  int4 is written for 128-column
blocks, two to a 256-column tile; another block width raises on a CUDA
tensor.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from ..flash_attention.ops import _on_device
from . import ref

quantize_plain = ref.quantize_int8
dequantize_plain = ref.dequantize_int8
quantize_int4_plain = ref.quantize_int4
dequantize_int4_plain = ref.dequantize_int4


def _device_kind(t: torch.Tensor) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"activation codec: no implementation for a tensor "
                         f"on {t.device}; have cpu (plain) and cuda (kernel)")
    return kind


def _other_block_on_card(block: int) -> NotImplementedError:
    return NotImplementedError(
        f"the int4 codec's CUDA kernels take blocks of {ref.BLOCK} columns, "
        f"not {block}; other block widths run on CPU tensors only")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


_DTYPE_CODE = {torch.float32: _build.DTYPE_CODES["float32"],
               torch.bfloat16: _build.DTYPE_CODES["bfloat16"]}


def _stream(device: torch.device) -> int:
    """The handle of the current stream on ``device`` (a card), as
    ``torch.cuda.current_stream(device).cuda_stream`` gives it but without
    building a ``Stream`` object, which took a fifth of a call's host time
    on the H100 machine."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def _launch(wrapper, entry: str, tensors, units, dtype) -> None:
    """Launch the C entry ``entry`` on the current stream of the card the
    tensors lie on, raise if the launch was refused, and count it on
    ``wrapper``.  Every codec entry takes three pointers, ``units`` (the
    number of blocks or tiles, and for int8 the block's width), the
    floating type's code and the stream."""
    a, b, c = tensors
    with _on_device(a.device):
        rc = getattr(_build.lib(), entry)(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), *units,
            _DTYPE_CODE[dtype], _stream(a.device))
    _build.check_launch(entry[len("rt_"):], rc)
    wrapper.launches += 1


def quantize(x: torch.Tensor, block: int = ref.BLOCK
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) -> (int8 (..., D), f32 scales (..., D/block))."""
    if _device_kind(x) == "cpu":
        return quantize_plain(x, block)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    D = x.shape[-1]
    if block < 1 or D % block != 0:
        raise ValueError(f"last dim {D} is not a multiple of {block}")
    q = x.new_empty(x.shape, dtype=torch.int8)
    s = x.new_empty((*x.shape[:-1], D // block), dtype=torch.float32)
    if x.numel() == 0:
        return q, s
    x = _aligned(x)
    _launch(quantize, "rt_quantize_int8", (x, q, s),
            (x.numel() // block, block), x.dtype)
    return q, s


quantize.launches = 0


def dequantize(q: torch.Tensor, s: torch.Tensor, dtype=torch.bfloat16,
               block: int = ref.BLOCK) -> torch.Tensor:
    if _device_kind(q) == "cpu":
        return dequantize_plain(q, s, dtype, block)
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"dequantize kernel takes int8 values and float32 "
                        f"scales, got {q.dtype}, {s.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dequantize kernel writes float32 or bfloat16, "
                        f"got {dtype}")
    D = q.shape[-1]
    if block < 1 or D % block != 0 \
            or tuple(s.shape) != (*q.shape[:-1], D // block) \
            or s.device != q.device:
        raise ValueError(f"payload {tuple(q.shape)} on {q.device} and scales "
                         f"{tuple(s.shape)} on {s.device} do not belong "
                         f"together at block {block}")
    out = q.new_empty(q.shape, dtype=dtype)
    if q.numel() == 0:
        return out
    q, s = _aligned(q), _aligned(s)
    _launch(dequantize, "rt_dequantize_int8", (q, s, out),
            (q.numel() // block, block), dtype)
    return out


dequantize.launches = 0


def quantize_int4(x: torch.Tensor, block: int = ref.BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) with D % (2*block) == 0 -> (packed int8 (..., D/2),
    f32 scales (..., D/block))."""
    if _device_kind(x) == "cpu":
        return quantize_int4_plain(x, block)
    if block != ref.BLOCK:
        raise _other_block_on_card(block)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_int4 kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    D = x.shape[-1]
    if D % (2 * block) != 0:
        raise ValueError(f"last dim {D} is not a multiple of 2 * {block}")
    p = x.new_empty((*x.shape[:-1], D // 2), dtype=torch.int8)
    s = x.new_empty((*x.shape[:-1], D // block), dtype=torch.float32)
    if x.numel() == 0:
        return p, s
    x = _aligned(x)
    _launch(quantize_int4, "rt_quantize_int4", (x, p, s),
            (x.numel() // (2 * block),), x.dtype)
    return p, s


quantize_int4.launches = 0


def dequantize_int4(p: torch.Tensor, s: torch.Tensor, dtype=torch.bfloat16,
                    block: int = ref.BLOCK) -> torch.Tensor:
    """(packed int8 (..., D/2), f32 scales (..., D/block)) -> (..., D)."""
    if _device_kind(p) == "cpu":
        return dequantize_int4_plain(p, s, dtype, block)
    if block != ref.BLOCK:
        raise _other_block_on_card(block)
    if p.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"dequantize_int4 kernel takes int8 packed values "
                        f"and float32 scales, got {p.dtype}, {s.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dequantize_int4 kernel writes float32 or bfloat16, "
                        f"got {dtype}")
    D = 2 * p.shape[-1]
    if D % (2 * block) != 0 \
            or tuple(s.shape) != (*p.shape[:-1], D // block) \
            or s.device != p.device:
        raise ValueError(f"packed payload {tuple(p.shape)} on {p.device} and "
                         f"scales {tuple(s.shape)} on {s.device} do not "
                         f"belong together at block {block}")
    out = p.new_empty((*p.shape[:-1], D), dtype=dtype)
    if p.numel() == 0:
        return out
    p, s = _aligned(p), _aligned(s)
    _launch(dequantize_int4, "rt_dequantize_int4", (p, s, out),
            (p.numel() // block,), dtype)
    return out


dequantize_int4.launches = 0
