"""Attention: grouped-query / multi-head / multi-head latent (MLA) self
attention, prefill and decode.

Counterpart of ``src/repro/models/attention.py``, cross attention
included (the VLM's gated cross blocks and the encoder-decoder's decoder).

Routing, as the JAX package routes with ``attn_impl="pallas"``: causal
attention over more than one position goes to
``kernels.flash_attention.ops.flash_attention``, and one decode token
against the cache to ``kernels.decode_attention.ops.decode_attention`` —
each the hand-written kernel for a CUDA tensor, its plain version for a
CPU tensor — with K/V *not* expanded (the kernels map query heads to their
K/V head by index).  Everything else (the ViT's and the DiT's non-causal
attention) goes through :func:`_sdpa`, written out as two matrix products
around a float32 softmax; those products are the ones the JAX package
leaves to XLA.  Cross attention (no RoPE, no mask) and the encoder's
non-causal self attention take that path too, as in the JAX package,
which sends only causal attention over more than one position to its
kernel.  ``cfg.attn_impl`` is kept as a field and not consulted.

Decode caches are stored flat as ``(B, S_max, KV*hd)``, as in the JAX
package.  :func:`attn_decode` writes the new token's K/V into the cache
**in place** (the JAX package returns an updated copy, which its serving
step donates) and hands the kernel a strided ``(B, KV, T, hd)`` view of
it, so no step copies the cache.

On a mesh (``models/sharding.py``) the activation constraints sit where
the JAX package has them, and the kernels run in ``local_map`` regions on
each rank's heads (:func:`_flash_local`, :func:`_tp_decode`), as do the
plain products of non-causal and cross attention (:func:`_sdpa_local`;
cross K/V and their caches sharded on the KV heads as the self caches
are): q is
``(B, S, H/n, hd)`` over the rules' head axis (``model`` under ``tp``)
of n ranks, K/V ``(B, S, KV/n, hd)`` where n divides KV — the kernels'
query head h then reads K/V head ``h // (H/KV)`` locally too — and
otherwise each rank is handed the K/V heads its own query heads read (the
JAX package pads instead).  Under ``fsdp`` the rules keep the heads whole
and each rank runs all of them on its batch rows.
``cfg.decode_attn="sp"`` shards the cache on the sequence over the rules'
``cache_seq_sp`` axis
(:func:`_sp_flash_decode`: local plain products, one ``pmax`` and two
``psum`` s a layer, as in the JAX package, which has no kernel there).

MLA (DeepSeek-V2) keeps the compressed ``(c_kv, k_pe)`` cache.  Its
prefill decompresses K/V per head and runs causal attention with q/k head
dim ``qk_nope + qk_rope`` and v head dim ``v_head_dim`` — (192, 128) in
deepseek-v2-lite-16b — through the flash attention kernel; its decode
stays in the absorbed form of the JAX package, attention in the latent
space as plain products (the JAX package has no kernel there either),
writing the new latent and RoPE key into the cache in place.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import to_dtype
from ..kernels.decode_attention import ops as da_ops
from ..kernels.flash_attention import ops as fa_ops
from .layers import (_common, _use_int8_ring, apply_rope, dense,
                     int8_ring_proj, linear_spec, rmsnorm)
from .sharding import (P, act_axis, act_shards, axis_rank, axis_size,
                       bound_mesh, check_placements, contiguous_grad,
                       is_dtensor, local_region, pending, placements, pmax,
                       psum, resolve, shard, shard_both, spec)


# ============================================================== specs
def attn_specs(cfg, layers: Optional[int] = None, cross: bool = False) -> Dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    out = {
        "wq": linear_spec(d, H * hd, ("d_model", "q_heads"), layers),
        "wk": linear_spec(d, KV * hd, ("d_model", "kv_heads"), layers),
        "wv": linear_spec(d, KV * hd, ("d_model", "kv_heads"), layers),
        "wo": linear_spec(H * hd, d, ("q_heads", "d_model"), layers),
    }
    if cfg.qkv_bias and not cross:
        out["bq"] = _bias(H * hd, "q_heads", layers)
        out["bk"] = _bias(KV * hd, "kv_heads", layers)
        out["bv"] = _bias(KV * hd, "kv_heads", layers)
    return out


def _bias(n, axis, layers):
    if layers is None:
        return spec((n,), (axis,), init="zeros")
    return spec((layers, n), ("layers", axis), init="zeros")


def mla_specs(cfg, layers: Optional[int] = None) -> Dict:
    d, H = cfg.d_model, cfg.n_heads
    r, qk_n, qk_r, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                         cfg.v_head_dim)
    return {
        "wq": linear_spec(d, H * (qk_n + qk_r), ("d_model", "q_heads"),
                          layers),
        "wkv_a": linear_spec(d, r + qk_r, ("d_model", "lora"), layers),
        "kv_norm": spec((r,) if layers is None else (layers, r),
                        ("lora",) if layers is None else ("layers", "lora"),
                        init="ones"),
        "wk_b": linear_spec(r, H * qk_n, ("lora", "q_heads"), layers),
        "wv_b": linear_spec(r, H * vd, ("lora", "q_heads"), layers),
        "wo": linear_spec(H * vd, d, ("q_heads", "d_model"), layers),
    }


# ============================================================== core attention
# Above this many score elements (S*T) the written-out path switches to the
# blocked online-softmax formulation, which never materialises the full
# (S, T) score matrix.
_BLOCK_THRESHOLD = 2048 * 2048
_BQ, _BK = 2048, 8192
_NEG = -1e30


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool, q_pos: Optional[torch.Tensor] = None,
          kv_len=None) -> torch.Tensor:
    """q: (B,S,H,D); k,v: (B,H,T,D) (already GQA-expanded). fp32 softmax."""
    B, S, H, D = q.shape
    T = k.shape[2]
    if S * T > _BLOCK_THRESHOLD and S > 1:
        return _blocked_sdpa(q, k, v, causal=causal, kv_len=kv_len)
    scale = D ** -0.5
    logits = torch.einsum("bshd,bhtd->bhst", q.float(), k.float()) * scale
    mask = None
    if causal and S > 1:
        qp = q_pos if q_pos is not None else torch.arange(S, device=q.device)
        mask = qp[:, None] >= torch.arange(T, device=q.device)[None, :]
    if kv_len is not None:
        lm = torch.arange(T, device=q.device)[None, :] < kv_len
        mask = lm if mask is None else (mask & lm)
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bhtd->bshd", w, v)


def _blocked_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, kv_len=None,
                  bq: int = _BQ, bk: int = _BK) -> torch.Tensor:
    """Flash-style attention in Python loops: per (q-chunk, kv-block) online
    softmax; causally dead blocks are skipped.  Peak memory per step is
    O(bq*bk) scores instead of O(S*T)."""
    B, S, H, D = q.shape
    T = k.shape[2]
    Dv = v.shape[-1]
    scale = D ** -0.5
    bq = min(bq, S)
    bk = min(bk, T)
    dev = q.device
    outs = []
    for qi in range(0, S, bq):
        nq = min(bq, S - qi)
        qc = q[:, qi:qi + nq]                            # (B,nq,H,D)
        m = torch.full((B, H, nq, 1), _NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, nq, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, nq, H, Dv), dtype=torch.float32, device=dev)
        for ki in range(0, T, bk):
            if causal and ki > qi + nq - 1:
                continue                                  # dead block
            nk = min(bk, T - ki)
            kc = k[:, :, ki:ki + nk]
            vc = v[:, :, ki:ki + nk]
            s = torch.einsum("bshd,bhtd->bhst", qc.float(), kc.float()) * scale
            kpos = ki + torch.arange(nk, device=dev)
            if causal:
                qpos = qi + torch.arange(nq, device=dev)
                s = torch.where(qpos[:, None] >= kpos[None, :], s,
                                torch.full_like(s, _NEG))
            if kv_len is not None:
                s = torch.where(kpos[None, :] < kv_len, s,
                                torch.full_like(s, _NEG))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.where(m_new <= _NEG / 2, torch.zeros_like(s),
                            torch.exp(s - m_new))
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            pv = torch.einsum("bhst,bhtd->bshd", p.to(v.dtype), vc).float()
            acc = acc * alpha.permute(0, 2, 1, 3) + pv
            m = m_new
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        outs.append((acc / l.permute(0, 2, 1, 3)).to(q.dtype))
    return torch.cat(outs, dim=1)


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,KV,T,D) -> (B,H,T,D)."""
    KV = k.shape[1]
    if KV == n_heads:
        return k
    return k.repeat_interleave(n_heads // KV, dim=1)


# ============================================================== GQA forward
def _qkv(cfg, p, x):
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = dense(x, p["wq"])
    k = dense(x, p["wk"])
    v = dense(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    # K/V on the query heads' axis where it divides them; where it does
    # not, a rank's columns are not whole heads: replicate them
    ax = "act_heads" if _heads_divide(KV) else None
    return (_split_heads(q, H, hd), _to_heads(k, KV, hd, ax),
            _to_heads(v, KV, hd, ax))


def _to_heads(t: torch.Tensor, n: int, hd: int, ax: Optional[str]
              ) -> torch.Tensor:
    """(B, S, n*hd) -> (B, S, n, hd), the heads on the rules' activation
    axis ``ax`` (``None``: whole).  The columns are placed before the
    reshape and the gradient after it: a reshape cannot split a shard that
    is not whole heads, and under ``fsdp`` a product may leave its columns,
    or its gradient, sharded over every rank."""
    B, S = t.shape[:2]
    t = shard(t, "batch", "seq", ax)
    return shard_both(t.reshape(B, S, n, hd), "batch", "seq", ax, None)


def _uneven_heads(H: int) -> bool:
    return bound_mesh() is not None and H % act_shards("act_heads") != 0


def _split_heads(t: torch.Tensor, H: int, hd: int) -> torch.Tensor:
    """(B, S, H*hd) -> (B, S, H, hd), sharded on heads over the rules'
    ``act_heads`` axis.  Where that axis does not divide H a rank's columns
    are not whole heads: the columns are gathered, and the heads padded
    with zero heads to a multiple of the shards, as the JAX package's
    partitioner pads them (:func:`_merge_heads` drops the pad)."""
    B, S = t.shape[:2]
    if is_dtensor(t) and _uneven_heads(H):
        t = shard(t, "batch", "seq", None).reshape(B, S, H, hd)
        n = act_shards("act_heads")
        pad = torch.zeros((B, S, -(-H // n) * n - H, hd), dtype=t.dtype,
                          device=t.device)
        t = torch.cat([t, pad], dim=2)
        return shard(t, "batch", "seq", "act_heads", None)
    return _to_heads(t, H, hd, "act_heads")


def _merge_heads(out: torch.Tensor, H: int) -> torch.Tensor:
    """(B, S, H', hd) -> (B, S, H*hd) for the output projection: heads
    padded by :func:`_split_heads` are gathered and the pad dropped."""
    B, S, _, hd = out.shape
    if is_dtensor(out) and _uneven_heads(H):
        # the pad dropped after the flatten: the flatten's gradient then
        # meets whole padded heads, which divide over the ranks
        out = shard(out, "batch", "seq", None, None)
        return out.reshape(B, S, -1)[:, :, :H * hd]
    out = shard(out, "batch", "seq", "act_heads", None)
    # placed after the flatten too, so that its gradient reaches the
    # flatten in whole heads (the output projection's may come back
    # sharded over every rank under ``fsdp``)
    return shard_both(out.reshape(B, S, -1), "batch", "seq", "act_heads")


def _out_proj(out2d: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """Attention output projection; int8-ring TP combine when enabled."""
    if _use_int8_ring("act_heads"):
        return int8_ring_proj(out2d, wo, "act_heads")
    return dense(out2d, wo)


def _batch_rule():
    return resolve(("batch",))[0]


def _local_kv_heads(k: torch.Tensor, H: int, KV: int, Hl: int
                    ) -> torch.Tensor:
    """The K/V heads (dim 2 of a full-head ``(B, T, KV, hd)`` tensor) that
    this rank's ``Hl`` query heads read, one per query head (a pad head,
    past the ``H`` real ones, reads the last)."""
    start = axis_rank(act_axis("act_heads")) * Hl
    idx = (start + torch.arange(Hl, device=k.device)) // (H // KV)
    return k.index_select(2, idx.clamp(max=KV - 1))


def _heads_divide(n_heads: int, name: str = "act_heads") -> bool:
    """Whether the rules' mesh axis for ``name`` divides ``n_heads``."""
    return n_heads % act_shards(name) == 0


def _attend(q, k, v, *, causal=False, q_pos=None):
    """:func:`_sdpa` of q (B, S, H, D) against k/v (B, T, KV, D) not yet
    expanded to the query heads."""
    H = q.shape[2]
    kt = k.permute(0, 2, 1, 3)   # (B,KV,T,D)
    vt = v.permute(0, 2, 1, 3)
    return _sdpa(q, _expand_kv(kt, H), _expand_kv(vt, H), causal=causal,
                 q_pos=q_pos)


def _sdpa_local(q, k, v, H, *, causal=False, q_pos=None):
    """:func:`_attend` (plain products: the non-causal self attention of
    the ViT and the encoder, and cross attention) in a region on each
    rank's query heads, as :func:`_flash_local` runs B5: q (B, S, H, D)
    and k/v (B, T, KV, D) DTensors -> (B, S, H, Dv) sharded on heads over
    the rules' ``act_heads`` axis (``H`` the real heads, q's padded as
    :func:`_split_heads` pads them).  Where that axis does not divide KV
    each rank is handed the K/V heads its own query heads read.  Softmax,
    masking and the K/V expansion run on local tensors: DTensor's own
    propagation through them is where a 2 x 2 mesh of CUDA ranks gave
    wrong gradients with the right forward (``ROADMAP.md`` C7)."""
    KV = k.shape[2]
    ax, n = act_axis("act_heads"), act_shards("act_heads")
    b = _batch_rule()
    even = KV % n == 0
    kv_spec = P(b, None, ax if even else None, None)

    def local(q_, k_, v_):
        q_, k_, v_ = (contiguous_grad(t) for t in (q_, k_, v_))
        if not even:
            k_ = _local_kv_heads(k_, H, KV, q_.shape[2])
            v_ = _local_kv_heads(v_, H, KV, q_.shape[2])
        return _attend(q_, k_, v_, causal=causal, q_pos=q_pos).contiguous()

    qs = P(b, None, ax, None)
    return local_region(local, qs, (qs, kv_spec, kv_spec),
                        partial_grad=() if even else (ax,))(q, k, v)


def _flash_local(cfg, q, k, v):
    """Causal flash attention (B5) on each rank's heads: q (B, S, H, D), k/v
    (B, S, KV, D) DTensors -> (B, S, H, Dv) sharded on heads over the
    rules' ``act_heads`` axis (q's heads padded by :func:`_split_heads`
    where it does not divide H).  Where the rules keep the heads whole
    (``fsdp``) each rank runs all of them on its own batch rows."""
    H, KV = cfg.n_heads, k.shape[2]
    ax, b = act_axis("act_heads"), _batch_rule()
    even = _heads_divide(KV)
    kv_spec = P(b, None, ax if even else None, None)

    def local(q_, k_, v_):
        q_, k_, v_ = (contiguous_grad(t) for t in (q_, k_, v_))
        if not even:
            k_ = _local_kv_heads(k_, H, KV, q_.shape[2])
            v_ = _local_kv_heads(v_, H, KV, q_.shape[2])
        # contiguous: DTensor takes the local shard's strides as its own
        return fa_ops.flash_attention(q_, k_, v_, causal=True).contiguous()

    qs = P(b, None, ax, None)
    return local_region(local, qs, (qs, kv_spec, kv_spec),
                        partial_grad=() if even else pending(ax))(q, k, v)


def attn_forward(cfg, p, x, positions, *, causal=True, rope=True,
                 return_kv=False, impl=None):
    """Full-sequence self attention (prefill).  ``impl`` is accepted for
    signature parity and ignored: the device of ``x`` decides."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    on_mesh = is_dtensor(q) and bound_mesh() is not None
    if causal and S > 1:
        if on_mesh:
            out = _flash_local(cfg, q, k, v)
        else:
            out = fa_ops.flash_attention(q, k, v, causal=True)
    else:
        q_pos = positions[0] if positions.dim() == 2 else positions
        if on_mesh:
            out = _sdpa_local(q, k, v, cfg.n_heads, causal=causal,
                              q_pos=q_pos)
        else:
            out = _attend(q, k, v, causal=causal, q_pos=q_pos)
    y = _out_proj(_merge_heads(out, cfg.n_heads), p["wo"])
    if return_kv:
        cax = "cache_seq_sp" if cfg.decode_attn == "sp" else None
        kax = None if cax else "cache_kv_heads"
        return y, {"k": shard(k.reshape(B, S, -1), "batch", cax, kax),
                   "v": shard(v.reshape(B, S, -1), "batch", cax, kax)}
    return y


def _position(pos, device) -> torch.Tensor:
    """The decode position as a (1,) int64 tensor on ``device``: an int
    becomes a fill on the device (no copy from the host), a tensor is
    moved there as it is."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64).reshape(1)
    return torch.full((1,), int(pos), dtype=torch.int64, device=device)


def attn_decode(cfg, p, x, pos, cache: Dict):
    """One-token decode. cache: {"k","v"}: (B, S_max, KV*hd); pos: the
    token's position (int or 0-dim tensor).  The new K/V are written into
    ``cache`` in place and the same tensors are returned."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"attn_decode takes one token, got {S}")
    hd, KV = cfg.resolved_head_dim, cfg.n_kv_heads
    q, k, v = _qkv(cfg, p, x)
    positions = _position(pos, x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kc, vc = cache["k"], cache["v"]
    if is_dtensor(kc) and bound_mesh() is not None:
        step = _sp_flash_decode if cfg.decode_attn == "sp" else _tp_decode
        out = step(cfg, q, kc, vc, k.reshape(B, 1, KV * hd),
                   v.reshape(B, 1, KV * hd), positions)
        return _out_proj(_merge_heads(out, cfg.n_heads), p["wo"]), \
            {"k": kc, "v": vc}
    kc.index_copy_(1, positions, k.reshape(B, 1, KV * hd).to(kc.dtype))
    vc.index_copy_(1, positions, v.reshape(B, 1, KV * hd).to(vc.dtype))
    T = kc.shape[1]
    k4 = kc.view(B, T, KV, hd).permute(0, 2, 1, 3)      # (B,KV,T,hd) views
    v4 = vc.view(B, T, KV, hd).permute(0, 2, 1, 3)
    out = da_ops.decode_attention(q[:, 0], k4, v4, pos + 1)
    y = dense(out.reshape(B, 1, -1), p["wo"])
    return y, {"k": kc, "v": vc}


def _tp_decode(cfg, q, kc, vc, k_new, v_new, positions):
    """One token against a cache sharded on its flat KV*hd dim over the
    rules' ``cache_kv_heads`` axis (``decode_attn="tp"``): each rank writes
    its columns of the new K/V into its shard in place and runs
    flash-decode (B6) on its query heads (the rules' ``act_heads``).
    Where that axis does not divide KV a rank's columns are not whole
    heads: the shards are gathered over it and each rank takes the K/V
    heads its query heads read.  Where the rules keep both whole
    (``fsdp``) each rank runs all heads on its own batch rows."""
    B, hd = q.shape[0], q.shape[3]
    H, KV = cfg.n_heads, cfg.n_kv_heads
    m = bound_mesh()
    b, cax = _batch_rule(), act_axis("cache_kv_heads")
    cs, qs = P(b, None, cax), P(b, None, act_axis("act_heads"), None)
    check_placements(kc, placements(cs, m), "cache")
    check_placements(vc, placements(cs, m), "cache")
    even = _heads_divide(KV, "cache_kv_heads")

    def local(q_, kn, vn, kc_, vc_):
        Bl, T, Hl = kc_.shape[0], kc_.shape[1], q_.shape[2]
        kc_.index_copy_(1, positions, kn.to(kc_.dtype))
        vc_.index_copy_(1, positions, vn.to(vc_.dtype))
        if even:
            KVl = kc_.shape[2] // hd
            k4 = kc_.view(Bl, T, KVl, hd).permute(0, 2, 1, 3)
            v4 = vc_.view(Bl, T, KVl, hd).permute(0, 2, 1, 3)
        else:
            from .sharding import all_gather
            kf = all_gather(kc_, 2, cax).view(Bl, T, KV, hd)
            vf = all_gather(vc_, 2, cax).view(Bl, T, KV, hd)
            k4 = _local_kv_heads(kf, H, KV, Hl).permute(0, 2, 1, 3)
            v4 = _local_kv_heads(vf, H, KV, Hl).permute(0, 2, 1, 3)
        return da_ops.decode_attention(q_[:, 0], k4, v4, positions + 1)

    return local_region(local, qs, (qs, cs, cs, cs, cs))(
        q, k_new, v_new, kc, vc)


def _sp_flash_decode(cfg, q, kc, vc, k_new, v_new, positions):
    """Sequence-parallel flash-decode (``cfg.decode_attn == "sp"``).

    The cache is sharded along the SEQUENCE dim over the rules'
    ``cache_seq_sp`` axis; each rank writes the new token into its own
    slice if the position falls there, computes complete attention scores
    for its slice (all heads local, as plain products) and the ranks
    combine with an online-softmax reduction: one ``pmax`` and two
    ``psum`` s of (B, H)-sized statistics and outputs a layer (none where
    the rules keep the sequence whole)."""
    B, hd = q.shape[0], q.shape[3]
    H, KV = cfg.n_heads, cfg.n_kv_heads
    m = bound_mesh()
    b, sax = _batch_rule(), act_axis("cache_seq_sp")
    cs = P(b, sax, None)
    check_placements(kc, placements(cs, m), "cache")
    check_placements(vc, placements(cs, m), "cache")

    # a sequence that does not divide over the ranks is split as
    # torch.chunk splits it, the last rank short
    T_rank = -(-kc.shape[1] // axis_size(sax))

    def local(q_, kn, vn, kc_, vc_):
        q_ = q_[:, :, :H]                   # without _split_heads' pad
        Bl, Tl = kc_.shape[0], kc_.shape[1]
        t0 = axis_rank(sax) * T_rank
        tglob = t0 + torch.arange(Tl, device=kc_.device)
        mine = (positions >= t0) & (positions < t0 + Tl)
        # only the owning rank lands the write (an empty index elsewhere)
        idx = (positions - t0)[mine]
        kc_.index_copy_(1, idx, kn[:, :idx.numel()].to(kc_.dtype))
        vc_.index_copy_(1, idx, vn[:, :idx.numel()].to(vc_.dtype))
        k4 = _expand_kv(kc_.view(Bl, Tl, KV, hd).permute(0, 2, 1, 3), H)
        v4 = _expand_kv(vc_.view(Bl, Tl, KV, hd).permute(0, 2, 1, 3), H)
        s = torch.einsum("bshd,bhtd->bhst", q_.float(), k4.float()) \
            * (hd ** -0.5)
        s = torch.where(tglob[None, None, None, :] < positions + 1, s,
                        torch.full_like(s, _NEG))
        m_ = pmax(s.amax(dim=-1, keepdim=True), sax)         # (B,H,1,1)
        p_ = torch.where(m_ <= -1e29, torch.zeros_like(s), torch.exp(s - m_))
        l = psum(p_.sum(-1, keepdim=True), sax)
        o = psum(torch.einsum("bhst,bhtd->bshd", p_.to(v4.dtype), v4), sax)
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        return (o / l.permute(0, 2, 1, 3).to(o.dtype)).to(q_.dtype)

    qs = P(b, None, None, None)
    ks = P(b, None, None)
    return local_region(local, qs, (qs, ks, ks, cs, cs))(
        q, k_new, v_new, kc, vc)


def kv_cache_specs(cfg, batch: int, max_len: int) -> Dict:
    hd, KV = cfg.resolved_head_dim, cfg.n_kv_heads
    if cfg.decode_attn == "sp":
        ax = ("batch", "cache_seq_sp", None)
    else:
        ax = ("batch", None, "kv_heads")
    dt = to_dtype(cfg.dtype)
    return {
        "k": spec((batch, max_len, KV * hd), ax, dtype=dt, init="zeros"),
        "v": spec((batch, max_len, KV * hd), ax, dtype=dt, init="zeros"),
    }


# ============================================================== cross attention
def cross_attn_forward(cfg, p, x, kv_x=None, kv_cache: Optional[Dict] = None):
    """Cross attention; pass ``kv_x`` once (prefill) or a precomputed
    ``kv_cache`` stored flat as (B, T, KV*hd).  Returns (y, kv_cache): the
    cache it was given, or the one made from ``kv_x``."""
    B, S, _ = x.shape
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = _split_heads(dense(x, p["wq"]), H, hd)
    if kv_cache is None:
        kv_cache = {n: shard(dense(kv_x, p[w]), "batch", None,
                             "cache_kv_heads")
                    for n, w in (("k", "wk"), ("v", "wv"))}
    T = kv_cache["k"].shape[1]
    kc, vc = kv_cache["k"], kv_cache["v"]
    if is_dtensor(q) and bound_mesh() is not None:
        if is_dtensor(kc) and KV % act_shards("act_heads"):
            # a rank's columns of K/V are not whole heads: replicate them
            kc, vc = (shard(t, "batch", None, None) for t in (kc, vc))
        out = _sdpa_local(q, kc.reshape(B, T, KV, hd),
                          vc.reshape(B, T, KV, hd), H)
    else:
        out = _attend(q, kc.reshape(B, T, KV, hd), vc.reshape(B, T, KV, hd))
    return dense(_merge_heads(out, H), p["wo"]), kv_cache


# ============================================================== MLA (deepseek)
def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A product of two operands in the wider of their types, as JAX
    promotes them."""
    a, b = _common(a, b)
    return torch.einsum(eq, a, b)


def _mla_q(cfg, p, x, positions):
    B, S, _ = x.shape
    H = cfg.n_heads
    qn, qr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = _split_heads(dense(x, p["wq"]), H, qn + qr)
    q_nope, q_pe = q[..., :qn], q[..., qn:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    return q_nope, q_pe


def _mla_latent(cfg, p, x, positions):
    r = cfg.kv_lora_rank
    kv_a = dense(x, p["wkv_a"])                    # (B,S,r+qr)
    c_kv = rmsnorm(kv_a[..., :r], p["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(kv_a[..., r:], positions, cfg.rope_theta)  # (B,S,qr)
    return c_kv, k_pe


def mla_forward(cfg, p, x, positions, *, causal=True, return_kv=False):
    """Prefill MLA: decompress K/V per head (naive form).  Causal
    attention over more than one position goes to the flash attention
    kernel at head dims (qk_nope + qk_rope, v_head_dim), the RoPE key
    broadcast over the heads; the rest to :func:`_sdpa`."""
    B, S, _ = x.shape
    H = cfg.n_heads
    qn, vd = cfg.qk_nope_dim, cfg.v_head_dim
    q_nope, q_pe = _mla_q(cfg, p, x, positions)
    c_kv, k_pe = _mla_latent(cfg, p, x, positions)
    k_nope = _split_heads(dense(c_kv, p["wk_b"]), H, qn)
    v = _split_heads(dense(c_kv, p["wv_b"]), H, vd)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, shard(k_pe[:, :, None, :].expand(
        B, S, H, cfg.qk_rope_dim), "batch", "seq", "act_heads", None)],
        dim=-1)
    on_mesh = is_dtensor(q) and bound_mesh() is not None
    if causal and S > 1:
        if on_mesh:
            out = _flash_local(cfg, q, k, v)
        else:
            out = fa_ops.flash_attention(q, k, v, causal=True)
    elif on_mesh:
        out = _sdpa_local(q, k, v, H, causal=causal, q_pos=positions)
    else:
        out = _sdpa(q, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                    causal=causal,
                    q_pos=positions[0] if positions.dim() == 2 else positions)
    y = dense(_merge_heads(out, H), p["wo"])
    if return_kv:
        return y, {"c_kv": c_kv, "k_pe": k_pe}
    return y


def _mla_attend(cfg, q_nope, q_pe, c_new, kpe_new, ckv, kpe, wk_b, wv_b,
                positions):
    """The absorbed MLA step over the heads it is given (all, or one
    rank's): the new latent and RoPE key written into ``ckv`` / ``kpe`` in
    place, attention in the latent space -> (B, 1, H, v_head_dim)."""
    qn, qr, vd, r = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    H = q_nope.shape[2]
    ckv.index_copy_(1, positions, c_new.to(ckv.dtype))
    kpe.index_copy_(1, positions, kpe_new.to(kpe.dtype))
    # absorb W_kb into q: q_lat (B,1,H,r)
    q_lat = _einsum("bshn,rhn->bshr", q_nope, wk_b.reshape(r, H, qn))
    logits = (torch.einsum("bshr,btr->bhst", q_lat.float(), ckv.float())
              + torch.einsum("bshr,btr->bhst", q_pe.float(), kpe.float()))
    logits = logits * ((qn + qr) ** -0.5)
    mask = torch.arange(ckv.shape[1], device=ckv.device) < positions + 1
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG))
    w = torch.softmax(logits, dim=-1).to(q_nope.dtype)
    ctx = _einsum("bhst,btr->bshr", w, ckv)               # (B,1,H,r)
    return _einsum("bshr,rhv->bshv", ctx, wv_b.reshape(r, H, vd))


def mla_decode(cfg, p, x, pos, cache: Dict):
    """Absorbed-form MLA decode: attention in the compressed latent space.
    The new latent and RoPE key are written into ``cache`` in place and
    the same tensors are returned.  On a mesh the step runs in a region on
    each rank's heads, the (replicated) latent cache written through each
    rank's local copy."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"mla_decode takes one token, got {S}")
    positions = _position(pos, x.device)
    q_nope, q_pe = _mla_q(cfg, p, x, positions)          # (B,1,H,qn),(B,1,H,qr)
    c_new, kpe_new = _mla_latent(cfg, p, x, positions)   # (B,1,r),(B,1,qr)
    ckv, kpe = cache["c_kv"], cache["k_pe"]
    args = (q_nope, q_pe, c_new, kpe_new, ckv, kpe, p["wk_b"], p["wv_b"])
    if is_dtensor(ckv) and bound_mesh() is not None:
        if _uneven_heads(cfg.n_heads):
            raise ValueError(f"{cfg.n_heads} MLA heads do not shard over "
                             f"{act_axis('act_heads')}")
        m, b, ax = bound_mesh(), _batch_rule(), act_axis("act_heads")
        cs = P(b, None, None)
        check_placements(ckv, placements(cs, m), "cache")
        check_placements(kpe, placements(cs, m), "cache")
        qs, ws = P(b, None, ax, None), P(None, ax)
        out = local_region(
            lambda *a: _mla_attend(cfg, *a, positions), qs,
            (qs, qs, cs, cs, cs, cs, ws, ws))(*args)
    else:
        out = _mla_attend(cfg, *args, positions)
    y = dense(_merge_heads(out, cfg.n_heads), p["wo"])
    return y, {"c_kv": ckv, "k_pe": kpe}


def mla_cache_specs(cfg, batch: int, max_len: int) -> Dict:
    dt = to_dtype(cfg.dtype)
    return {
        "c_kv": spec((batch, max_len, cfg.kv_lora_rank),
                     ("batch", None, None), dtype=dt, init="zeros"),
        "k_pe": spec((batch, max_len, cfg.qk_rope_dim),
                     ("batch", None, None), dtype=dt, init="zeros"),
    }
