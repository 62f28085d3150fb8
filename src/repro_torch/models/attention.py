"""Attention: grouped-query / multi-head / multi-head latent (MLA) self
attention, prefill and decode.

Counterpart of ``src/repro/models/attention.py`` but for cross attention,
which follows with the path that needs it.

Routing, as the JAX package routes with ``attn_impl="pallas"``: causal
attention over more than one position goes to
``kernels.flash_attention.ops.flash_attention``, and one decode token
against the cache to ``kernels.decode_attention.ops.decode_attention`` —
each the hand-written kernel for a CUDA tensor, its plain version for a
CPU tensor — with K/V *not* expanded (the kernels map query heads to their
K/V head by index).  Everything else (the ViT's and the DiT's non-causal
attention) goes through :func:`_sdpa`, written out as two matrix products
around a float32 softmax; those products are the ones the JAX package
leaves to XLA.  ``cfg.attn_impl`` is kept as a field and not consulted.

Decode caches are stored flat as ``(B, S_max, KV*hd)``, as in the JAX
package.  :func:`attn_decode` writes the new token's K/V into the cache
**in place** (the JAX package returns an updated copy, which its serving
step donates) and hands the kernel a strided ``(B, KV, T, hd)`` view of
it, so no step copies the cache.

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
from .layers import _common, apply_rope, dense, linear_spec, rmsnorm
from .sharding import spec


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
    B, S = x.shape[:2]
    return (q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd),
            v.reshape(B, S, KV, hd))


def attn_forward(cfg, p, x, positions, *, causal=True, rope=True,
                 return_kv=False, impl=None):
    """Full-sequence self attention (prefill).  ``impl`` is accepted for
    signature parity and ignored: the device of ``x`` decides."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if causal and S > 1:
        out = fa_ops.flash_attention(q, k, v, causal=True)
    else:
        kt = k.permute(0, 2, 1, 3)   # (B,KV,T,D)
        vt = v.permute(0, 2, 1, 3)
        out = _sdpa(q, _expand_kv(kt, cfg.n_heads),
                    _expand_kv(vt, cfg.n_heads), causal=causal,
                    q_pos=positions[0] if positions.dim() == 2 else positions)
    y = dense(out.reshape(B, S, -1), p["wo"])
    if return_kv:
        return y, {"k": k.reshape(B, S, -1), "v": v.reshape(B, S, -1)}
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
    kc.index_copy_(1, positions, k.reshape(B, 1, KV * hd).to(kc.dtype))
    vc.index_copy_(1, positions, v.reshape(B, 1, KV * hd).to(vc.dtype))
    T = kc.shape[1]
    k4 = kc.view(B, T, KV, hd).permute(0, 2, 1, 3)      # (B,KV,T,hd) views
    v4 = vc.view(B, T, KV, hd).permute(0, 2, 1, 3)
    out = da_ops.decode_attention(q[:, 0], k4, v4, pos + 1)
    y = dense(out.reshape(B, 1, -1), p["wo"])
    return y, {"k": kc, "v": vc}


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
    q = dense(x, p["wq"]).reshape(B, S, H, qn + qr)
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
    k_nope = dense(c_kv, p["wk_b"]).reshape(B, S, H, qn)
    v = dense(c_kv, p["wv_b"]).reshape(B, S, H, vd)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(
        B, S, H, cfg.qk_rope_dim)], dim=-1)
    if causal and S > 1:
        out = fa_ops.flash_attention(q, k, v, causal=True)
    else:
        out = _sdpa(q, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                    causal=causal,
                    q_pos=positions[0] if positions.dim() == 2 else positions)
    y = dense(out.reshape(B, S, -1), p["wo"])
    if return_kv:
        return y, {"c_kv": c_kv, "k_pe": k_pe}
    return y


def mla_decode(cfg, p, x, pos, cache: Dict):
    """Absorbed-form MLA decode: attention in the compressed latent space.
    The new latent and RoPE key are written into ``cache`` in place and
    the same tensors are returned."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"mla_decode takes one token, got {S}")
    H = cfg.n_heads
    qn, qr, vd, r = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    positions = _position(pos, x.device)
    q_nope, q_pe = _mla_q(cfg, p, x, positions)          # (B,1,H,qn),(B,1,H,qr)
    c_new, kpe_new = _mla_latent(cfg, p, x, positions)   # (B,1,r),(B,1,qr)
    ckv, kpe = cache["c_kv"], cache["k_pe"]
    ckv.index_copy_(1, positions, c_new.to(ckv.dtype))
    kpe.index_copy_(1, positions, kpe_new.to(kpe.dtype))
    # absorb W_kb into q: q_lat (B,1,H,r)
    q_lat = _einsum("bshn,rhn->bshr", q_nope, p["wk_b"].reshape(r, H, qn))
    logits = (torch.einsum("bshr,btr->bhst", q_lat.float(), ckv.float())
              + torch.einsum("bshr,btr->bhst", q_pe.float(), kpe.float()))
    logits = logits * ((qn + qr) ** -0.5)
    mask = torch.arange(ckv.shape[1], device=x.device) < positions + 1
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG))
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx = _einsum("bhst,btr->bshr", w, ckv)               # (B,1,H,r)
    out = _einsum("bshr,rhv->bshv", ctx, p["wv_b"].reshape(r, H, vd))
    y = dense(out.reshape(B, 1, -1), p["wo"])
    return y, {"c_kv": ckv, "k_pe": kpe}


def mla_cache_specs(cfg, batch: int, max_len: int) -> Dict:
    dt = to_dtype(cfg.dtype)
    return {
        "c_kv": spec((batch, max_len, cfg.kv_lora_rank),
                     ("batch", None, None), dtype=dt, init="zeros"),
        "k_pe": spec((batch, max_len, cfg.qk_rope_dim),
                     ("batch", None, None), dtype=dt, init="zeros"),
    }
