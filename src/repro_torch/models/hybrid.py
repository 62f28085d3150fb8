"""Hybrid SSM + shared-attention backbone (zamba2-1.2b).

Counterpart of ``src/repro/models/hybrid.py``, the training loss
:func:`hybrid_loss` included.  Mamba2 blocks, and ONE shared
transformer block (attention + MLP, weights shared) invoked before every
``cfg.shared_attn_every``-th Mamba block.  Each invocation *site* keeps its
own KV cache (same weights, different activations).

On the card the shared block's causal prefill attention is the flash
attention kernel (B5), its one-token decode the flash-decode kernel (B6),
and every Mamba block's scan the SSD scan kernel (B7).  Decode writes the
new K/V of each site and the new state of each Mamba layer into the
stacked caches in place, and returns the caches it was given.

On a mesh the Mamba2 layers run as ``models/ssm.py`` runs them (B7 on each
rank's heads), the shared block's attention as the dense blocks' (B5 and
B6 on each rank's heads), and the caches carry the placements of their
specs: the sites' K/V sharded on their KV heads, the SSD states on their
heads, over ``model``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .. import to_dtype
from . import attention as A
from .layers import (embed, embed_spec, mlp, mlp_specs, rmsnorm, rmsnorm_spec,
                     softmax_xent)
from .sharding import spec, tree_map
from .ssm import (_residual, mamba_decode, mamba_forward, mamba_prefill,
                  mamba_specs, ssm_logits, ssm_state_specs)
from .transformer import _layer_slice, run_stack, run_stack_decode


def n_sites(cfg) -> int:
    return math.ceil(cfg.n_layers / cfg.shared_attn_every)


def hybrid_specs(cfg) -> Dict:
    d = cfg.d_model
    s = {
        "embed": embed_spec(cfg.vocab_size, d),
        "mamba": mamba_specs(cfg, cfg.n_layers),
        "shared": {  # ONE block, reused at every site
            "ln1": rmsnorm_spec(d),
            "attn": A.attn_specs(cfg),
            "ln2": rmsnorm_spec(d),
            "mlp": mlp_specs(d, cfg.d_ff),
        },
        "final_norm": rmsnorm_spec(d),
    }
    if not cfg.tie_embeddings:
        s["head"] = embed_spec(cfg.vocab_size, d)
    return s


def _shared_fwd(cfg, p, x, positions, return_kv=False):
    a = A.attn_forward(cfg, p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps),
                       positions, causal=True, return_kv=return_kv)
    a, kv = a if return_kv else (a, None)
    x = x + a
    x = _residual(x, mlp(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps)))
    return (x, kv) if return_kv else x


def _groups(cfg):
    """[(site_idx, layer_lo, layer_hi)] — shared block fires before layer_lo."""
    k = cfg.shared_attn_every
    return [(g, g * k, min((g + 1) * k, cfg.n_layers))
            for g in range(n_sites(cfg))]


def _group(tree, lo: int, hi: int):
    """Layers ``[lo, hi)`` of a stacked tree, as views."""
    return tree_map(lambda w: w[lo:hi], tree)


def hybrid_hidden(cfg, params, tokens, *, remat: bool = False):
    """Token ids -> final hidden states (pre final-norm), every position;
    ``remat`` checkpoints the Mamba2 layers (not the shared block), as the
    JAX package does."""
    x = embed(params["embed"], tokens).to(to_dtype(cfg.dtype))
    positions = torch.arange(tokens.shape[1], device=tokens.device)

    def one(pl, h):
        return _residual(h, mamba_forward(cfg, pl, h)), None, 0.0

    for g, lo, hi in _groups(cfg):
        x = _shared_fwd(cfg, params["shared"], x, positions)
        x, _, _ = run_stack(cfg, _group(params["mamba"], lo, hi), x, one,
                            hi - lo, remat=remat)
    return x


def hybrid_loss(cfg, params, tokens, labels) -> torch.Tensor:
    h = hybrid_hidden(cfg, params, tokens, remat=cfg.remat)
    return softmax_xent(ssm_logits(cfg, params, h), labels)


@torch.no_grad()
def hybrid_prefill(cfg, params, tokens):
    x = embed(params["embed"], tokens).to(to_dtype(cfg.dtype))
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    attn_caches, ssm_states = [], []

    def one(pl, h):
        out, st = mamba_prefill(cfg, pl, h)
        return _residual(h, out), st, 0.0

    for g, lo, hi in _groups(cfg):
        x, kv = _shared_fwd(cfg, params["shared"], x, positions,
                            return_kv=True)
        attn_caches.append(kv)
        x, states, _ = run_stack(cfg, _group(params["mamba"], lo, hi), x,
                                 one, hi - lo, collect=True)
        ssm_states.append(states)
    caches = {
        "attn": tree_map(lambda *l: torch.stack(l), *attn_caches),
        "ssm": tree_map(lambda *l: torch.cat(l), *ssm_states),
    }
    return ssm_logits(cfg, params, x[:, -1:]), caches


@torch.no_grad()
def hybrid_decode(cfg, params, caches, tokens, pos):
    """One decode step; ``caches`` are updated in place and returned."""
    x = embed(params["embed"], tokens).to(to_dtype(cfg.dtype))
    sp = params["shared"]

    def dec(pl, h, st):
        out, st = mamba_decode(cfg, pl, h, st)
        return _residual(h, out), st

    for g, lo, hi in _groups(cfg):
        h = rmsnorm(x, sp["ln1"], cfg.norm_eps)
        a, _ = A.attn_decode(cfg, sp["attn"], h, pos,
                             _layer_slice(caches["attn"], g))
        x = x + a
        x = _residual(x, mlp(sp["mlp"], rmsnorm(x, sp["ln2"], cfg.norm_eps)))
        x, _ = run_stack_decode(cfg, _group(params["mamba"], lo, hi),
                                _group(caches["ssm"], lo, hi), x, dec,
                                hi - lo)
    return ssm_logits(cfg, params, x), caches


def hybrid_cache_specs(cfg, batch: int, max_len: int) -> Dict:
    def stack(tree, n):
        return tree_map(
            lambda s: spec((n,) + s.shape, ("layers",) + s.axes,
                           dtype=s.dtype, init="zeros"), tree)

    return {
        "attn": stack(A.kv_cache_specs(cfg, batch, max_len), n_sites(cfg)),
        "ssm": stack(ssm_state_specs(cfg, batch), cfg.n_layers),
    }
