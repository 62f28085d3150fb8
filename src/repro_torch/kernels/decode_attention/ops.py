"""Wrapper: single-token decode attention over a (B, KV, T, D) cache view
-> the flash-decode kernel.

Counterpart of ``src/repro/kernels/decode_attention/ops.py``.

``decode_attention`` replaces the TPU kernel ``decode_attention_pallas`` of
``src/repro/kernels/decode_attention/kernel.py`` with the CUDA kernel of
``csrc/decode_attention.cu``.  A decode step reads the live K/V prefix
once and does little arithmetic on it, so the kernel is bound by bytes: it
reads the model's flat cache in place through strides, serves a whole GQA
group from one read of each K/V row, splits the KV axis across blocks
(``split_plan``: from the buffer length, never from ``kv_len``) and
streams each split's 64-key tiles through a ring of asynchronous copies.
The splits merge inside the same launch: the last live split of each
(batch, kv head) combines the others' partial softmax states, kept in a
scratch that is allocated once per card (``_scratch``) and left clean by
the kernel.  Blocks past ``kv_len`` read nothing.  ``kv_len`` is a Python
int or a 0-dim integer tensor; a CUDA tensor is read by the kernel itself,
so nothing waits for the card.  Head dims 16, 32, 64, 96 and 128 are
built, and bfloat16 takes GQA groups of up to 16 query heads; another one
raises.

Dispatch is by where the tensors lie: CPU tensors take the plain version
(``decode_attention_plain``), CUDA tensors launch the kernel or the call
raises.  One call is one CUDA kernel launch.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Tuple

import torch

from .. import _build
from ..flash_attention.ops import DTYPE_CODE, _on_device, _strided
from ..flash_attention.ops import _device_kind as _fa_device_kind
from . import ref

decode_attention_plain = ref.decode_attention
HEAD_DIMS = (16, 32, 64, 96, 128)  # the instantiations in the CUDA source
TILE = 64                          # keys per stage of the kernel's ring
# what the bf16 kernel's shared memory allows at every head dim (106 KB a
# block at 128, 81 KB at 96)
BLOCKS_PER_SM = 2
MAX_GROUP = 16                     # bf16: a GQA group is one 16-row mma tile


@lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the CUDA card ``device`` (132 on an
    H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_plan(T: int, n_bkv: int, n_sm: int) -> Tuple[int, int]:
    """(keys per split, number of splits) for a cache of ``T`` positions
    and ``n_bkv`` (batch, kv head) pairs on a card of ``n_sm`` SMs: as many
    splits as one wave holds (``BLOCKS_PER_SM`` blocks on every SM, never
    more, since a second wave would pay the whole latency again), each a
    whole number of 64-key tiles; where the buffer has fewer tiles than
    that, one tile per split."""
    n_tiles = -(-T // TILE)
    want = max(1, BLOCKS_PER_SM * n_sm // n_bkv)
    chunk = -(-n_tiles // want) * TILE
    return chunk, -(-T // chunk)


_SCRATCH: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device: torch.device, n_part: int,
             n_ticket: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The splits' partial (acc, m, l) rows (float32) and one ticket per
    (batch, kv head) (int32, zero), allocated once per card and grown when a
    call needs more, so that the pointers stay put from call to call.  The
    kernel leaves every ticket at 0.  Calls that share it run in stream
    order (one stream per card)."""
    part, ticket = _SCRATCH.get(device, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    if ticket is None or ticket.numel() < n_ticket:
        ticket = torch.zeros(n_ticket, dtype=torch.int32, device=device)
    _SCRATCH[device] = (part, ticket)
    return part, ticket


def _device_kind(tensors) -> str:
    return _fa_device_kind(tensors, "decode_attention")


def _check_len(kv_len) -> None:
    if isinstance(kv_len, torch.Tensor):
        if kv_len.numel() != 1 or kv_len.is_floating_point():
            raise TypeError(f"kv_len must be one integer, got a tensor of "
                            f"shape {tuple(kv_len.shape)} and {kv_len.dtype}")
    elif int(kv_len) < 1:
        raise ValueError(f"kv_len {kv_len}: an empty cache has no softmax")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len) -> torch.Tensor:
    """q: (B, 1, H, D) or (B, H, D); k, v: (B, KV, T, D) -> (B, 1, H, D).

    Keys at index >= ``kv_len`` are masked; ``kv_len`` past ``T`` means
    the whole cache."""
    if q.dim() == 4:
        q = q[:, 0]
    kind = _device_kind((q, k, v))
    _check_len(kv_len)
    if kind == "cpu":
        return decode_attention_plain(q, k, v, kv_len)
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} are not (B,H,D)/(B,KV,T,D)")
    B, H, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % KV != 0:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "belong together")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernel is built for {HEAD_DIMS}")
    if q.dtype == torch.bfloat16 and H // KV > MAX_GROUP:
        raise ValueError(f"a group of {H // KV} query heads: the bfloat16 "
                         f"kernel takes up to {MAX_GROUP}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention kernel takes float32 or bfloat16 "
                        f"throughout, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v lie on different cards")
    len_dev, len_int = None, 0
    if isinstance(kv_len, torch.Tensor) and kv_len.device.type == "cuda":
        if kv_len.device != q.device:
            raise ValueError("kv_len lies on another card than q")
        len_dev = kv_len.reshape(()).to(torch.int32)   # queued, not awaited
    else:
        len_int = int(kv_len)
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    if T == 0 or B == 0:
        return out.zero_()
    chunk, n_split = split_plan(T, B * KV, sm_count(q.device))
    part, ticket = _scratch(q.device, B * H * n_split * (D + 2), B * KV)
    q, k, v = _strided(q), _strided(k), _strided(v)
    o = out[:, 0]
    with _on_device(q.device):
        rc = _build.lib().rt_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            part.data_ptr(), ticket.data_ptr(),
            B, H, KV, T, D, min(len_int, T),
            None if len_dev is None else len_dev.data_ptr(), chunk, n_split,
            *q.stride()[:2], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:2], D ** -0.5, DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("decode_attention", rc)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
