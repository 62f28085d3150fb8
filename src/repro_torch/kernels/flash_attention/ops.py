"""Wrapper: (B,S,H,D) / (B,T,KV,D) layout -> the flash attention kernel.

Counterpart of ``src/repro/kernels/flash_attention/ops.py``.

``flash_attention`` replaces the TPU kernel ``flash_attention_pallas`` of
``src/repro/kernels/flash_attention/kernel.py`` with the CUDA kernel of
``csrc/flash_attention.cu``.  At the served shape (273 tokens, 32 heads of
128, causal) the card's bound is the bytes of q, k, v and the output — a
few microseconds — so the kernel is bound by latency and by the
instructions of each step, not by traffic: it runs one block of four
warps per (batch * head, 64-row query tile), two blocks to an SM, walks
64-row K/V tiles up to the diagonal while the next tile is already on
its way (a two-stage ring of asynchronous copies), reads the model's
layout in place through strides (no transposes, no K/V repeat for grouped
heads) and masks ragged tails in S and T itself.  Head dims 16, 32, 64, 96
and 128 are built; another one raises.  bfloat16 inputs run both products on
the tensor cores (``mma.sync``) with scores and probabilities kept in
registers and the softmax in exp2; float32 inputs run scalar FMAs, which
hold the 2e-5 their callers are given.

Dispatch is by where the tensors lie: CPU tensors take the plain version
(``flash_attention_plain``), CUDA tensors launch the kernel or the call
raises.
"""
from __future__ import annotations

import contextlib

import torch

from .. import _build
from . import ref

flash_attention_plain = ref.attention
HEAD_DIMS = (16, 32, 64, 96, 128)  # the instantiations in the CUDA source
DTYPE_CODE = {torch.float32: _build.DTYPE_CODES["float32"],
              torch.bfloat16: _build.DTYPE_CODES["bfloat16"]}


def _strided(t: torch.Tensor) -> torch.Tensor:
    """A view the kernel can read in place — innermost stride 1 and every
    row on a 16-byte boundary — or an aligned contiguous copy."""
    size = t.element_size()
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(st * size % 16 == 0 for st in t.stride()[:-1]))
    if ok:
        return t
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _device_kind(tensors, name: str) -> str:
    """"cpu" or "cuda", where all of ``tensors`` lie; raises elsewhere."""
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"{name}: no implementation for tensors on "
                         f"{[str(t.device) for t in tensors]}; have cpu "
                         "(plain) and cuda (kernel)")
    return kinds.pop()


def _on_device(device: torch.device):
    """Make ``device`` the current card for a launch, unless it already is
    (entering ``torch.cuda.device`` costs host time on every call); a device
    with no index names the current card."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, KV, D) -> (B, S, H, D)."""
    if _device_kind((q, k, v), "flash_attention") == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} are not (B,S,H,D)/(B,T,KV,D)")
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % KV != 0:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "belong together")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernel is built for "
                         f"{HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"throughout, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v lie on different cards")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if T == 0:
        return out.zero_()
    q, k, v = _strided(q), _strided(k), _strided(v)
    with _on_device(q.device):
        rc = _build.lib().rt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, KV, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            D ** -0.5, int(bool(causal)), DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("flash_attention", rc)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
