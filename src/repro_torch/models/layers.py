"""Shared building blocks: RMSNorm, RoPE, SwiGLU MLP, embeddings.

Counterpart of ``src/repro/models/layers.py``, with the training loss
(:func:`softmax_xent`).  Parameters may be stored in
another dtype than the activations (the specs default to bfloat16 whatever
``cfg.dtype`` says); a product then runs in the wider of the two types, as
JAX's promotion has it.

On a mesh the activation constraints sit where the JAX package has them
(:func:`~.sharding.shard`, a no-op off a mesh), and with
``cfg.tp_collective="int8_ring"`` (the rules' ``__tp_int8__`` flag) a
row-parallel projection combines its partial products over an int8 ring
(:func:`int8_ring_proj`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .sharding import ParamSpec, is_dtensor, shard, spec


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


def int8_ring_proj(h: torch.Tensor, w: torch.Tensor, act: str
                   ) -> torch.Tensor:
    """Row-parallel projection whose TP combine runs as an int8 ring
    all-reduce (inference only, ``cfg.tp_collective="int8_ring"``): each
    rank of the mesh axis the rules give the activation axis ``act``
    computes its partial (..., d) product and the partials are summed with
    int8 + scale chunks on the wire.

    h: (..., F) sharded on F over that axis; w: (F, d) sharded on F.  The
    leading (batch) dim keeps its data sharding."""
    from ..train.compression import ring_allreduce_int8
    from .sharding import P, act_axis, local_region, resolve
    b, ax = resolve(("batch",))[0], act_axis(act)
    lead = (b,) + (None,) * (h.dim() - 2)

    def local(h_, w_):
        return ring_allreduce_int8(dense(h_, w_), ax)

    return local_region(local, P(*lead, None),
                        (P(*lead, ax), P(ax, None)))(h, w)


def _use_int8_ring(act: str) -> bool:
    """Whether a row-parallel projection over the activation axis ``act``
    combines on the int8 ring: the rules' ``__tp_int8__`` flag, on a bound
    mesh whose rules shard ``act`` (under ``fsdp`` they keep it whole, and
    there is no combine)."""
    from .sharding import act_axis, bound_mesh, rule_flag
    m = bound_mesh()
    return bool(rule_flag("__tp_int8__")) and m is not None \
        and act_axis(act) in m.axis_names


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(dense(x, p["wg"])) * dense(x, p["wu"])
    h = shard(h, "batch", "seq", "act_ff")
    if _use_int8_ring("act_ff"):
        return int8_ring_proj(h, p["wd"], "act_ff")
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
    if is_dtensor(w):
        return shard(_embed_vocab_sharded(w, tokens), "batch", "seq", None)
    return w[tokens]


def _embed_vocab_sharded(w: torch.Tensor, tokens: torch.Tensor
                         ) -> torch.Tensor:
    """The lookup in a table sharded on its rows over the mesh axis the
    rules give ``act_vocab``: each rank looks up the tokens its rows hold
    and zeroes the rest, and the ranks' rows sum to the lookup (left
    pending for :func:`shard`).  Where the rules keep ``act_vocab`` whole
    (``fsdp``) the table is gathered and each rank looks up its own batch
    rows in all of it.  Written out as a region, not left to DTensor's
    masked embedding, whose gradient cannot meet the tied output head's in
    one sum (torch 2.11)."""
    from .sharding import (P, act_axis, act_shards, axis_rank, batch_axes,
                           local_region, pending, resolve)
    ax = act_axis("act_vocab")
    rows = -(-w.shape[0] // act_shards("act_vocab"))  # torch.chunk's split
    b = resolve(("batch",))[0]

    def local(w_, t_):
        idx = t_.long() - axis_rank(ax) * rows
        keep = (idx >= 0) & (idx < w_.shape[0])
        out = F.embedding(idx.clamp(0, w_.shape[0] - 1), w_)
        return out * keep[..., None].to(out.dtype)

    return local_region(local, P(b, None, None),
                        (P(ax, None), P(b, None)),
                        partial_grad=batch_axes(),
                        partial_out=pending(ax))(w, tokens)


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
    return shard(logits, "batch", "seq", "act_vocab")


# ---------------------------------------------------------------- softmax xent
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy, float32 accumulation: the log-sum-exp of
    each row minus its label's logit, picked with ``gather`` (the JAX
    package's iota mask picks the same element; both are exact).

    On a mesh (vocab-sharded ``DTensor`` logits) each rank sums its own
    columns (:func:`_xent_parts`), so that only (B, S) statistics cross the
    ranks, as in the JAX package."""
    logits = logits.float()
    if is_dtensor(logits):
        # the rows' maxima: a constant shift of the log-sum-exp
        mx = shard(logits.detach().amax(dim=-1, keepdim=True),
                   "batch", "seq", None)
        ll, se = _xent_parts(logits, labels, mx)
        loss = (se.log() + mx[..., 0] - ll).mean()   # pending over ranks
        from torch.distributed.tensor import Replicate
        return loss.redistribute(loss.device_mesh,
                                 [Replicate()] * loss.device_mesh.ndim)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (lse - ll).mean()


def _xent_parts(logits, labels, mx):
    """(the label's logit, sum(exp(logit - mx))) of every row, each the sum
    of the ranks' own columns over the mesh axis the rules give
    ``act_vocab`` (all columns on each rank where they keep it whole).  A
    region with its sums left to :func:`shard`: DTensor's own propagation
    through these reductions gave wrong gradients on a 2-D mesh of CUDA
    ranks (torch 2.11), where this form's gradients are the local ones."""
    from .sharding import (P, act_axis, act_shards, axis_rank, local_region,
                           pending, resolve)
    ax = act_axis("act_vocab")
    cols = -(-logits.shape[-1] // act_shards("act_vocab"))
    b = resolve(("batch",))[0]

    def local(lg, lab, mx_):
        idx = lab.long() - axis_rank(ax) * cols
        keep = (idx >= 0) & (idx < lg.shape[-1])
        ll = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])
        return torch.stack([ll[..., 0] * keep, (lg - mx_).exp().sum(-1)])

    parts = local_region(local, P(None, b, None),
                         (P(b, None, ax), P(b, None), P(b, None, None)),
                         partial_out=pending(ax))(logits, labels, mx)
    parts = shard(parts, None, "batch", "seq")
    return parts[0], parts[1]
