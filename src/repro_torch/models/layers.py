"""Shared building blocks: RMSNorm, RoPE, SwiGLU MLP, embeddings.

Counterpart of ``src/repro/models/layers.py``, with the training loss
(:func:`softmax_xent`).  Parameters may be stored in
another dtype than the activations (the specs default to bfloat16 whatever
``cfg.dtype`` says); a product then runs in the wider of the two types, as
JAX's promotion has it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .sharding import ParamSpec, spec


# ------------------------------------------------------------------- norms
def rmsnorm_spec(d: int, layers: Optional[int] = None) -> ParamSpec:
    if layers is None:
        return spec((d,), ("d_model",), init="ones")
    return spec((layers, d), ("layers", "d_model"), init="ones")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """fp32 variance accumulation; the full-size tensor math stays in the
    input dtype (``inv`` is cast before the multiply)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return (x * inv) * w.to(x.dtype)


# -------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    idx = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (idx / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, D) or (B, S, D); positions: (S,).  Split-halves
    convention, float32 angles."""
    dt = x.dtype
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)            # (D/2,)
    ang = positions[:, None].float() * freqs                 # (S, D/2)
    if x.dim() == 4:
        ang = ang[None, :, None, :]
    else:
        ang = ang[None, :, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


# ------------------------------------------------------------------- linear
def linear_spec(d_in: int, d_out: int, axes=("d_model", "ff"),
                layers: Optional[int] = None, **kw) -> ParamSpec:
    if layers is None:
        return spec((d_in, d_out), axes, **kw)
    return spec((layers, d_in, d_out), ("layers",) + tuple(axes), **kw)


def _common(x: torch.Tensor, w: torch.Tensor):
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt), w.to(dt)
    return x, w


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., d) @ (d, f): a plain matrix product, left to the library as the
    JAX package leaves it to XLA."""
    x, w = _common(x, w)
    return torch.matmul(x, w)


# -------------------------------------------------------------------- mlp
def mlp_specs(d: int, ff: int, layers: Optional[int] = None) -> dict:
    return {
        "wg": linear_spec(d, ff, ("d_model", "ff"), layers),
        "wu": linear_spec(d, ff, ("d_model", "ff"), layers),
        "wd": linear_spec(ff, d, ("ff", "d_model"), layers),
    }


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(dense(x, p["wg"])) * dense(x, p["wu"])
    return dense(h, p["wd"])


# -------------------------------------------------------------- embeddings
VOCAB_PAD = 16   # embedding tables pad to a multiple of 16 rows


def padded_vocab(vocab: int) -> int:
    return ((vocab + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def embed_spec(vocab: int, d: int) -> ParamSpec:
    """Table padded to a multiple of 16 rows, as the JAX package pads it so
    that the vocab dim shards evenly; pad rows are masked out of the logits
    in :func:`unembed`."""
    return spec((padded_vocab(vocab), d), ("vocab", "d_model"), scale=1.0)


def embed(w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return w[tokens]


def unembed(w: torch.Tensor, x: torch.Tensor, vocab: Optional[int] = None
            ) -> torch.Tensor:
    """x @ w.T -> logits; pad slots masked to -1e30."""
    x, w = _common(x, w)
    logits = torch.matmul(x, w.t())
    V_pad = w.shape[0]
    if vocab is not None and vocab != V_pad:
        ids = torch.arange(V_pad, device=logits.device)
        logits = torch.where(ids < vocab, logits,
                             torch.full_like(logits, -1e30))
    return logits


# ---------------------------------------------------------------- softmax xent
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy, float32 accumulation: the log-sum-exp of
    each row minus its label's logit, picked with ``gather`` (the JAX
    package's iota mask picks the same element; both are exact)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (lse - ll).mean()
