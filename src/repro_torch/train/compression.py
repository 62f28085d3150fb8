"""Gradient compression: the int8 ring all-reduce with per-chunk scales, and
per-tensor int8 with error feedback.

Counterpart of ``src/repro/train/compression.py``.  The ring moves int8
chunks and one float32 scale a chunk instead of float gradients: the
tensor is flattened to float32, zero-padded to a multiple of the ring's N
ranks and cut into N chunks; N-1 reduce-scatter hops (send chunk
``(r - k) % N``, add the received one into ``(r - k - 1) % N``,
requantised at every hop), after which rank r owns chunk ``(r + 1) % N``;
then N-1 all-gather hops circulate the finished chunks, int8 on the wire.
``_quant`` is the JAX package's: one scale ``amax / 127`` a chunk, round
half to even.  No codec kernel runs here, as in the JAX package.

:func:`ring_allreduce_int8` runs across the ranks of one axis of the bound
mesh (``models/sharding.py``), each hop a ``batch_isend_irecv`` to the
ring's neighbours in that axis's group.  A backend that carries no
point-to-point op for a CUDA tensor (gloo) gets the hop's bytes through
host memory: the copy is the wire, and :data:`WIRE` counts it.
:func:`ring_allreduce_int8_plain` runs the same hops of all N ranks in one
process over a stacked ``(N, ...)`` tensor; it is what the ranks are held
against.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..models.sharding import bound_mesh, tree_leaves, tree_map

Tree = Any

# hops, payload bytes (int8 + scale) and bytes staged through host memory
# by ring_allreduce_int8 in this process
WIRE: Dict[str, int] = {"hops": 0, "bytes": 0, "host_bytes": 0}


def reset_wire() -> None:
    for k in WIRE:
        WIRE[k] = 0


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), \
        scale


def _dequant(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.float() * s


def _chunks(x: torch.Tensor, N: int) -> Tuple[torch.Tensor, int]:
    """(N, c) float32 chunks of ``x`` flattened and zero-padded, and the
    pad."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % N
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(N, -1).clone(), pad


def _unchunk(chunks: torch.Tensor, pad: int, like: torch.Tensor
             ) -> torch.Tensor:
    out = chunks.reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(like.shape).to(like.dtype)


def p2p_through_host(group, device: torch.device) -> bool:
    """Whether a ring hop of ``group`` on ``device`` goes through host
    memory: gloo (and the port's ``hostgloo``, gloo on host copies) carries
    point-to-point ops for CPU tensors only."""
    import torch.distributed as dist
    return device.type == "cuda" and \
        dist.get_backend(group) in ("gloo", "hostgloo")


def _hop(q: torch.Tensor, s: torch.Tensor, nxt: int, prv: int, group,
         host: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Send (int8 chunk, float32 scale) to global rank ``nxt`` and receive
    the same from ``prv``, as one message of bytes: the scale, then the
    chunk."""
    import torch.distributed as dist
    msg = torch.cat([s.reshape(1).view(torch.uint8), q.view(torch.uint8)])
    if host:
        msg = msg.cpu()
    buf = torch.empty_like(msg)
    for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, msg, nxt, group),
                                     dist.P2POp(dist.irecv, buf, prv, group)]):
        w.wait()
    WIRE["hops"] += 1
    WIRE["bytes"] += msg.numel()
    if host:
        WIRE["host_bytes"] += 2 * msg.numel()
        buf = buf.to(q.device)
    return buf[4:].view(torch.int8), buf[:4].view(torch.float32)[0]


def ring_allreduce_int8(x: torch.Tensor, axis: str, rank=None
                        ) -> torch.Tensor:
    """Sum ``x`` (the same shape on every rank of ``axis``) over ``axis`` of
    the installed bound mesh, int8 on the wire.  ``x`` is this rank's local
    tensor; the result has its shape and dtype.  ``rank`` is this rank's
    index along ``axis`` (default: the mesh's)."""
    import torch.distributed as dist
    m = bound_mesh()
    N = 1 if m is None or axis not in m.axis_names else m.shape[axis]
    if N == 1:
        return x
    group = m.device_mesh.get_group(axis)
    r = m.local_rank(axis) if rank is None else int(rank)
    nxt = dist.get_global_rank(group, (r + 1) % N)
    prv = dist.get_global_rank(group, (r - 1) % N)
    host = p2p_through_host(group, x.device)
    chunks, pad = _chunks(x, N)
    # ---- reduce-scatter: after N-1 hops, rank r owns chunk (r+1) % N
    for k in range(N - 1):
        q, s = _hop(*_quant(chunks[(r - k) % N]), nxt, prv, group, host)
        chunks[(r - k - 1) % N] += _dequant(q, s)
    # ---- all-gather: circulate completed chunks (int8 on the wire)
    for k in range(N - 1):
        q, s = _hop(*_quant(chunks[(r + 1 - k) % N]), nxt, prv, group, host)
        chunks[(r - k) % N] = _dequant(q, s)
    return _unchunk(chunks, pad, x)


def ring_allreduce_int8_plain(xs: torch.Tensor) -> torch.Tensor:
    """The ring's hops for all N ranks in one process: ``xs`` stacks the N
    ranks' inputs ``(N, ...)``; returns the N ranks' outputs, stacked.
    Rank r sends to rank r+1 at every hop, as in
    :func:`ring_allreduce_int8`."""
    N = xs.shape[0]
    if N == 1:
        return xs.clone()
    per = [_chunks(xs[r], N) for r in range(N)]
    chunks, pad = [c for c, _ in per], per[0][1]
    for k in range(N - 1):
        sent = [_quant(chunks[r][(r - k) % N]) for r in range(N)]
        for r in range(N):
            q, s = sent[(r - 1) % N]
            chunks[r][(r - k - 1) % N] += _dequant(q, s)
    for k in range(N - 1):
        sent = [_quant(chunks[r][(r + 1 - k) % N]) for r in range(N)]
        for r in range(N):
            q, s = sent[(r - 1) % N]
            chunks[r][(r - k) % N] = _dequant(q, s)
    return torch.stack([_unchunk(chunks[r], pad, xs[r]) for r in range(N)])


def compressed_psum_tree(tree: Tree, axis: str) -> Tree:
    return tree_map(lambda g: ring_allreduce_int8(g, axis), tree)


# ------------------------------------------------------- error feedback (EF)
def ef_compress(grads: Tree, ef: Tree) -> Tuple[Tree, Tree]:
    """One-shot int8 quantisation with error feedback: returns (the
    dequantised gradients to feed the ring, the new residual)."""
    pairs = []
    for g, e in zip(tree_leaves(grads), tree_leaves(ef)):
        tgt = g.float() + e
        deq = _dequant(*_quant(tgt))
        pairs.append((deq.to(g.dtype), tgt - deq))
    it1, it2 = iter(pairs), iter(pairs)
    return (tree_map(lambda _: next(it1)[0], grads),
            tree_map(lambda _: next(it2)[1], ef))
