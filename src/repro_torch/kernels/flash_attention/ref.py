"""Plain PyTorch version of causal attention (grouped-query aware).

Counterpart of ``src/repro/kernels/flash_attention/ref.py``; the value head
dim may differ from the query/key one (multi-head latent attention)."""
from __future__ import annotations

import torch


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, D); k: (B, T, KV, D); v: (B, T, KV, Dv) -> (B, S, H,
    Dv).  fp32 softmax, GQA by repeat, scale ``D ** -0.5``."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if KV != H:
        g = H // KV
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * (D ** -0.5)
    if causal:
        idx_s = torch.arange(S, device=q.device)[:, None]
        idx_t = torch.arange(T, device=q.device)[None, :]
        logits = torch.where(idx_s >= idx_t, logits,
                             torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthe->bshe", w, v)
