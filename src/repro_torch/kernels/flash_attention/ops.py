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
heads) and masks ragged tails in S and T itself.  The (q/k, v) head dims built are
the equal pairs 16, 32, 64, 96 and 128, (192, 128), the multi-head
latent attention prefill of DeepSeek-V2, and (24, 16), the same at the
reduced width the serving driver runs (``HEAD_DIM_PAIRS``); another pair
raises.  bfloat16 inputs run both products on
the tensor cores (``mma.sync``) with scores and probabilities kept in
registers and the softmax in exp2; float32 inputs run scalar FMAs, which
hold the 2e-5 their callers are given.

Dispatch is by where the tensors lie: CPU tensors take the plain version
(``flash_attention_plain``), CUDA tensors launch the kernel or the call
raises.

Training differentiates through the kernel: where autograd records (grad
mode on and q, k or v requiring a gradient) the call goes through
``FlashAttentionFn``, whose forward is the kernel and whose backward
recomputes the plain version on the saved inputs and differentiates it
(``flash_attention_vjp_plain``), as the JAX package trains through the
plain attention.  There is no backward kernel.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from .. import _build
from . import ref

flash_attention_plain = ref.attention
# (q/k head dim, v head dim): the instantiations in the CUDA source
HEAD_DIM_PAIRS = ((16, 16), (32, 32), (64, 64), (96, 96), (128, 128),
                  (192, 128), (24, 16))
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
    """q: (B, S, H, D); k: (B, T, KV, D); v: (B, T, KV, Dv) -> (B, S, H,
    Dv).  The scale is ``D ** -0.5``."""
    if _device_kind((q, k, v), "flash_attention") == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal)
    return _launch(q, k, v, causal)


def _check(q, k, v) -> None:
    """Raise for what the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} are not (B,S,H,D)/(B,T,KV,D)/"
                         "(B,T,KV,Dv)")
    B, S, H, D = q.shape
    KV, Dv = k.shape[2], v.shape[3]
    if k.shape[0] != B or k.shape[3] != D or H % KV != 0:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "belong together")
    if (D, Dv) not in HEAD_DIM_PAIRS:
        raise ValueError(f"head dim {D} (v: {Dv}): the kernel is built for "
                         f"{HEAD_DIM_PAIRS}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"throughout, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v lie on different cards")


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    """One launch of the kernel on checked CUDA tensors."""
    B, S, H, D = q.shape
    T, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((B, S, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if T == 0:
        return out.zero_()
    q, k, v = _strided(q), _strided(k), _strided(v)
    with _on_device(q.device):
        rc = _build.lib().rt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, KV, D, Dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            D ** -0.5, int(bool(causal)), DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("flash_attention", rc)
    flash_attention.launches += 1
    return out


def flash_attention_vjp_plain(q, k, v, do, *, causal: bool = True):
    """(dq, dk, dv): the plain version's gradients at (q, k, v) against the
    output gradient ``do``, each in its input's dtype."""
    with torch.enable_grad():
        ins = tuple(t.detach().requires_grad_(True) for t in (q, k, v))
        out = flash_attention_plain(*ins, causal=causal)
        return torch.autograd.grad(out, ins, do)


class FlashAttentionFn(torch.autograd.Function):
    """The kernel forward, the plain version's gradients backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_vjp_plain(q, k, v, do, causal=ctx.causal),
                None)


flash_attention.launches = 0


def occupancy(D: int, Dv: int) -> int:
    """Blocks of the bf16 kernel at head dims (D, Dv) that one SM of the
    current card holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    with the kernel's shared memory)."""
    blocks = ctypes.c_int(0)
    rc = _build.lib().rt_flash_attention_occupancy(D, Dv, ctypes.byref(blocks))
    _build.check_launch("flash_attention occupancy", rc)
    return blocks.value
