"""Encoder-decoder backbone (seamless-m4t-large-v2).

Counterpart of ``src/repro/models/encdec.py``, the training loss
:func:`encdec_loss` included.  The audio frontend is a stub, as in
the JAX package: the encoder takes precomputed frame embeddings
``(B, S_src, d_model)`` through one learned projection, then non-causal
self attention with RoPE over ``arange(S_src)``.  Decoder = causal self
attention + cross attention over the encoder output + MLP.

On the card the decoder's causal prefill attention is the flash attention
kernel (B5) and its one-token decode the flash-decode kernel (B6); the
encoder's attention and cross attention are plain products
(``attention._sdpa``), as the JAX package leaves them to XLA.  Decode
caches: per decoder layer the self K/V, written in place, and the cross
K/V over the source, computed once in the prefill.

On a mesh the encoder's attention and cross attention run on each rank's
query heads as plain products (``attention._sdpa_local``), the decoder's
causal prefill and its decode through B5 and B6 on each rank's heads
(``attention._flash_local``, ``_tp_decode``); both caches are sharded on
their KV heads over ``model``.
"""
from __future__ import annotations

from typing import Dict

import torch

from .. import to_dtype
from . import attention as A
from .layers import (dense, embed, embed_spec, linear_spec, mlp, mlp_specs,
                     rmsnorm, rmsnorm_spec, softmax_xent)
from .sharding import shard, spec, tree_map
from .transformer import lm_logits, run_stack, run_stack_decode


def _residual(h: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The residual stream after a block, replicated over ``model`` on a
    mesh (the block's row-parallel sum reduced)."""
    return shard(h + out, "batch", "seq", None)


def enc_block_specs(cfg, layers):
    return {
        "ln1": rmsnorm_spec(cfg.d_model, layers),
        "attn": A.attn_specs(cfg, layers),
        "ln2": rmsnorm_spec(cfg.d_model, layers),
        "mlp": mlp_specs(cfg.d_model, cfg.d_ff, layers),
    }


def dec_block_specs(cfg, layers):
    return {
        "ln1": rmsnorm_spec(cfg.d_model, layers),
        "self_attn": A.attn_specs(cfg, layers),
        "lnx": rmsnorm_spec(cfg.d_model, layers),
        "cross_attn": A.attn_specs(cfg, layers, cross=True),
        "ln2": rmsnorm_spec(cfg.d_model, layers),
        "mlp": mlp_specs(cfg.d_model, cfg.d_ff, layers),
    }


def encdec_specs(cfg) -> Dict:
    d = cfg.d_model
    s = {
        "frontend_proj": linear_spec(d, d, ("d_model", None)),
        "enc_blocks": enc_block_specs(cfg, cfg.n_enc_layers),
        "enc_norm": rmsnorm_spec(d),
        "embed": embed_spec(cfg.vocab_size, d),
        "dec_blocks": dec_block_specs(cfg, cfg.n_dec_layers),
        "final_norm": rmsnorm_spec(d),
    }
    if not cfg.tie_embeddings:
        s["head"] = embed_spec(cfg.vocab_size, d)
    return s


def encode(cfg, params, frames: torch.Tensor, *, remat: bool = False
           ) -> torch.Tensor:
    """frames: (B, S_src, d_model) stub embeddings -> encoder output."""
    x = dense(frames.to(to_dtype(cfg.dtype)), params["frontend_proj"])
    positions = torch.arange(x.shape[1], device=x.device)

    def one(pl, h):
        a = A.attn_forward(cfg, pl["attn"], rmsnorm(h, pl["ln1"], cfg.norm_eps),
                           positions, causal=False)
        h = h + a
        h = _residual(h, mlp(pl["mlp"], rmsnorm(h, pl["ln2"], cfg.norm_eps)))
        return h, None, 0.0

    x, _, _ = run_stack(cfg, params["enc_blocks"], x, one, cfg.n_enc_layers,
                        remat=remat)
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _dec_block(cfg, pl, h, positions, enc_out=None, cross_kv=None,
               return_kv=False):
    a = A.attn_forward(cfg, pl["self_attn"],
                       rmsnorm(h, pl["ln1"], cfg.norm_eps), positions,
                       causal=True, return_kv=return_kv)
    a, kv = a if return_kv else (a, None)
    h = h + a
    c, ckv = A.cross_attn_forward(cfg, pl["cross_attn"],
                                  rmsnorm(h, pl["lnx"], cfg.norm_eps),
                                  kv_x=enc_out, kv_cache=cross_kv)
    h = h + c
    h = _residual(h, mlp(pl["mlp"], rmsnorm(h, pl["ln2"], cfg.norm_eps)))
    return h, kv, ckv


def encdec_logits(cfg, params, frames, tokens, *, remat: bool = False):
    """Teacher-forced logits of every decoder position."""
    enc_out = encode(cfg, params, frames, remat=remat)
    x = embed(params["embed"], tokens).to(to_dtype(cfg.dtype))
    positions = torch.arange(tokens.shape[1], device=tokens.device)

    def one(pl, h):
        h, _, _ = _dec_block(cfg, pl, h, positions, enc_out=enc_out)
        return h, None, 0.0

    x, _, _ = run_stack(cfg, params["dec_blocks"], x, one, cfg.n_dec_layers,
                        remat=remat)
    return lm_logits(cfg, params, x)


def encdec_loss(cfg, params, frames, tokens, labels) -> torch.Tensor:
    return softmax_xent(encdec_logits(cfg, params, frames, tokens,
                                      remat=cfg.remat), labels)


@torch.no_grad()
def encdec_prefill(cfg, params, frames, tokens):
    """Encode the source and teacher-force the ``tokens`` prefix; returns
    (last-position logits, caches)."""
    enc_out = encode(cfg, params, frames)
    x = embed(params["embed"], tokens).to(to_dtype(cfg.dtype))
    positions = torch.arange(tokens.shape[1], device=tokens.device)

    def one(pl, h):
        h, kv, ckv = _dec_block(cfg, pl, h, positions, enc_out=enc_out,
                                return_kv=True)
        return h, {"self": kv, "cross": ckv}, 0.0

    x, caches, _ = run_stack(cfg, params["dec_blocks"], x, one,
                             cfg.n_dec_layers, collect=True)
    return lm_logits(cfg, params, x[:, -1:]), caches


@torch.no_grad()
def encdec_decode(cfg, params, caches, tokens, pos):
    """One decode step; each layer's self K/V is written into ``caches`` in
    place and ``caches`` is returned as it came."""
    x = embed(params["embed"], tokens).to(to_dtype(cfg.dtype))

    def dec(pl, h, c):
        a, _ = A.attn_decode(cfg, pl["self_attn"],
                             rmsnorm(h, pl["ln1"], cfg.norm_eps), pos,
                             c["self"])
        h = h + a
        cr, _ = A.cross_attn_forward(cfg, pl["cross_attn"],
                                     rmsnorm(h, pl["lnx"], cfg.norm_eps),
                                     kv_cache=c["cross"])
        h = h + cr
        h = _residual(h, mlp(pl["mlp"], rmsnorm(h, pl["ln2"], cfg.norm_eps)))
        return h, c

    x, caches = run_stack_decode(cfg, params["dec_blocks"], caches, x, dec,
                                 cfg.n_dec_layers)
    return lm_logits(cfg, params, x), caches


def encdec_cache_specs(cfg, batch: int, max_len: int, src_len: int) -> Dict:
    L = cfg.n_dec_layers

    def stack(tree):
        return tree_map(lambda s: spec((L,) + s.shape, ("layers",) + s.axes,
                                       dtype=s.dtype, init="zeros"), tree)

    return {"self": stack(A.kv_cache_specs(cfg, batch, max_len)),
            "cross": stack(A.kv_cache_specs(cfg, batch, src_len))}
