"""Plain PyTorch version of single-token GQA decode attention with a
length mask.

Counterpart of ``src/repro/kernels/decode_attention/ref.py``."""
from __future__ import annotations

import torch


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len) -> torch.Tensor:
    """q: (B, H, D); k, v: (B, KV, T, D); positions >= kv_len are masked.

    Returns (B, 1, H, D) — matching the serve-step layout.  fp32 softmax,
    GQA by repeat, the weights cast to ``v``'s type before the product.
    """
    B, H, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    if KV != H:
        g = H // KV
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    logits = torch.einsum("bhd,bhtd->bht", q.float(), k.float()) * (D ** -0.5)
    mask = torch.arange(T, device=q.device)[None, None, :] < kv_len
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bht,bhtd->bhd", w, v)
    return out[:, None]
