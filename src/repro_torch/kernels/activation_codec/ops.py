"""Public wrappers for the activation codecs (int8 + packed int4).

Counterpart of ``src/repro/kernels/activation_codec/ops.py``.  Arbitrary
rank is flattened to ``(rows, D)``.

``quantize`` / ``dequantize`` replace the TPU kernels
``quantize_int8_pallas`` / ``dequantize_int8_pallas`` of
``src/repro/kernels/activation_codec/kernel.py`` with the CUDA kernels of
``csrc/activation_codec.cu``.  Both are bound by bytes on the card (each
element read once and written once, a handful of operations each), so the
kernels make one pass with one warp per (row, 128-column block), vector
loads and stores, and nothing kept in device memory between the abs-max and
the rounding.  At the served size (273 x 4096) the traffic is a few
megabytes, so the launch itself is most of the time.

Dispatch is by where the tensor lies, nothing else: a CPU tensor takes the
plain version (``quantize_plain`` / ``dequantize_plain``), a CUDA tensor
launches the kernel or the call raises.  The kernels are written for
128-column blocks; another block width (the JAX package's rule for widths
such as the reduced ``d_model = 64``, where one block spans the row) runs
the plain version on a CPU tensor and raises on a CUDA tensor.

The int4 functions are plain PyTorch only so far: on a CUDA tensor they
raise until their kernels are ported (ROADMAP.md queue B, items B3 and B4).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
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
        f"the int8 codec's CUDA kernels take blocks of {ref.BLOCK} columns, "
        f"not {block}; other block widths run on CPU tensors only")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def quantize(x: torch.Tensor, block: int = ref.BLOCK
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) -> (int8 (..., D), f32 scales (..., D/block))."""
    if _device_kind(x) == "cpu":
        return quantize_plain(x, block)
    if block != ref.BLOCK:
        raise _other_block_on_card(block)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    D = x.shape[-1]
    if D % block != 0:
        raise ValueError(f"last dim {D} is not a multiple of {block}")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((*x.shape[:-1], D // block), dtype=torch.float32,
                    device=x.device)
    if x.numel() == 0:
        return q, s
    x = _aligned(x)
    with torch.cuda.device(x.device):
        rc = _build.lib().rt_quantize_int8(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), x.numel() // block,
            _build.DTYPE_CODES[str(x.dtype).split(".")[-1]],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("quantize_int8", rc)
    quantize.launches += 1
    return q, s


quantize.launches = 0


def dequantize(q: torch.Tensor, s: torch.Tensor, dtype=torch.bfloat16,
               block: int = ref.BLOCK) -> torch.Tensor:
    if _device_kind(q) == "cpu":
        return dequantize_plain(q, s, dtype, block)
    if block != ref.BLOCK:
        raise _other_block_on_card(block)
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"dequantize kernel takes int8 values and float32 "
                        f"scales, got {q.dtype}, {s.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dequantize kernel writes float32 or bfloat16, "
                        f"got {dtype}")
    D = q.shape[-1]
    if D % block != 0 or tuple(s.shape) != (*q.shape[:-1], D // block) \
            or s.device != q.device:
        raise ValueError(f"payload {tuple(q.shape)} on {q.device} and scales "
                         f"{tuple(s.shape)} on {s.device} do not belong "
                         f"together at block {block}")
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    if q.numel() == 0:
        return out
    q, s = _aligned(q), _aligned(s)
    with torch.cuda.device(q.device):
        rc = _build.lib().rt_dequantize_int8(
            q.data_ptr(), s.data_ptr(), out.data_ptr(), q.numel() // block,
            _build.DTYPE_CODES[str(dtype).split(".")[-1]],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("dequantize_int8", rc)
    dequantize.launches += 1
    return out


dequantize.launches = 0


def _int4_on_card() -> NotImplementedError:
    return NotImplementedError(
        "the packed-int4 codec has no CUDA kernel yet (ROADMAP.md queue B, "
        "items B3 and B4); it runs on CPU tensors only")


def quantize_int4(x: torch.Tensor, block: int = ref.BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) with D % (2*block) == 0 -> (packed int8 (..., D/2),
    f32 scales (..., D/block))."""
    if _device_kind(x) == "cuda":
        raise _int4_on_card()
    return quantize_int4_plain(x, block)


def dequantize_int4(p: torch.Tensor, s: torch.Tensor, dtype=torch.bfloat16,
                    block: int = ref.BLOCK) -> torch.Tensor:
    if _device_kind(p) == "cuda":
        raise _int4_on_card()
    return dequantize_int4_plain(p, s, dtype, block)
