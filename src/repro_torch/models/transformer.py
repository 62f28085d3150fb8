"""Decoder-only LM assembly for the dense family.

Counterpart of the dense path of ``src/repro/models/transformer.py``:
full-sequence forward, prefill and one-token decode.  Layer parameters are
**stacked** along a leading ``layers`` dim, as in the JAX package, and a
layer's weights are views into the stack — nothing is copied to run a
layer.  The stack runs as a Python loop; ``cfg.scan_layers`` and ``remat``
are accepted and have no meaning in eager inference.

Caches follow the same convention: stacked ``(L, B, S_max, KV*hd)``
tensors.  Decode writes each layer's new K/V in place into its view of the
stack, so a step never re-stacks (copies) the cache, and
:func:`lm_decode` returns the same tensors it was given.  MoE blocks
follow with the path that needs them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .. import to_dtype
from . import attention as A
from .layers import (embed, embed_spec, mlp, mlp_specs, rmsnorm, rmsnorm_spec,
                     unembed)
from .sharding import spec, tree_leaves, tree_map

Tree = Any


# ================================================================= specs
def dense_block_specs(cfg, layers: Optional[int] = None,
                      d_ff: Optional[int] = None):
    if cfg.use_mla:
        raise NotImplementedError("MLA attention is not ported yet")
    d = cfg.d_model
    ff = d_ff if d_ff is not None else cfg.d_ff
    out = {
        "ln1": rmsnorm_spec(d, layers),
        "attn": A.attn_specs(cfg, layers),
        "mlp": mlp_specs(d, ff, layers),
    }
    if not cfg.parallel_block:
        out["ln2"] = rmsnorm_spec(d, layers)
    return out


def lm_specs(cfg) -> Dict:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    V, d = cfg.vocab_size, cfg.d_model
    specs: Dict = {"embed": embed_spec(V, d), "final_norm": rmsnorm_spec(d),
                   "blocks": dense_block_specs(cfg, cfg.n_layers)}
    if not cfg.tie_embeddings:
        specs["head"] = embed_spec(V, d)
    return specs


# ================================================================ block fwd
def block_forward(cfg, p: Dict, x: torch.Tensor, positions: torch.Tensor,
                  *, is_moe: bool = False, return_kv: bool = False):
    """Returns (x, kv_cache_or_None, aux_loss)."""
    if is_moe:
        raise NotImplementedError("MoE blocks are not ported yet")
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a = A.attn_forward(cfg, p["attn"], h, positions, causal=cfg.causal,
                       return_kv=return_kv)
    a, kv = a if return_kv else (a, None)
    if cfg.parallel_block:
        # command-r: shared-norm parallel residual
        return x + a + mlp(p["mlp"], h), kv, 0.0
    x = x + a
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(p["mlp"], h), kv, 0.0


def block_decode(cfg, p: Dict, x: torch.Tensor, pos, cache: Dict):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, cache = A.attn_decode(cfg, p["attn"], h, pos, cache)
    if cfg.parallel_block:
        return x + a + mlp(p["mlp"], h), cache
    x = x + a
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(p["mlp"], h), cache


# ================================================================ stack run
def _layer_slice(tree: Tree, i: int) -> Tree:
    """Layer ``i`` of a stacked tree, as views."""
    return tree_map(lambda w: w[i], tree)


def run_stack(cfg, blocks_p: Tree, x: torch.Tensor, fwd_one, n_layers: int,
              *, remat: bool = False, collect: bool = False):
    """fwd_one(layer_params, x) -> (x, ys, aux).  Loops over the stack."""
    ys_list, aux = [], 0.0
    for i in range(n_layers):
        x, ys, a = fwd_one(_layer_slice(blocks_p, i), x)
        aux = aux + a
        if collect:
            ys_list.append(ys)
    if collect and ys_list and ys_list[0] is not None:
        ys = tree_map(lambda *l: torch.stack(l), *ys_list)
    else:
        ys = None
    return x, ys, aux


def run_stack_decode(cfg, blocks_p: Tree, caches: Tree, x: torch.Tensor,
                     dec_one, n_layers: int):
    """dec_one(layer_params, x, cache) -> (x, cache).  Layer ``i``'s cache
    is a view into the stacked ``caches``, which ``dec_one`` updates in
    place; the stack is returned as it came."""
    for i in range(n_layers):
        x, _ = dec_one(_layer_slice(blocks_p, i), x, _layer_slice(caches, i))
    return x, caches


# ================================================================ LM api
@torch.no_grad()
def lm_hidden(cfg, params: Dict, tokens: torch.Tensor, *,
              remat: Optional[bool] = None):
    """Token ids -> final hidden states (pre final-norm). Returns (h, aux)."""
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    x = embed(params["embed"], tokens).to(to_dtype(cfg.dtype))

    def one(pl, h):
        h, _, a = block_forward(cfg, pl, h, positions)
        return h, None, a

    n = tree_leaves(params["blocks"])[0].shape[0]
    x, _, aux = run_stack(cfg, params["blocks"], x, one, n)
    return x, aux


@torch.no_grad()
def lm_logits(cfg, params: Dict, h: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    w = params["embed"] if cfg.tie_embeddings else params["head"]
    return unembed(w, h, cfg.vocab_size)


@torch.no_grad()
def lm_prefill(cfg, params: Dict, tokens: torch.Tensor):
    """Prefill: returns (last-position logits, {"blocks": stacked KV})."""
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    x = embed(params["embed"], tokens).to(to_dtype(cfg.dtype))

    def one(pl, h):
        return block_forward(cfg, pl, h, positions, return_kv=True)

    x, kv, _ = run_stack(cfg, params["blocks"], x, one, cfg.n_layers,
                         collect=True)
    logits = lm_logits(cfg, params, x[:, -1:])
    return logits, {"blocks": kv}


@torch.no_grad()
def lm_decode(cfg, params: Dict, caches: Dict, tokens: torch.Tensor, pos):
    """One decode step. tokens: (B,1); pos: the current position (int or
    0-dim tensor).  ``caches`` are updated in place and returned."""
    x = embed(params["embed"], tokens).to(to_dtype(cfg.dtype))

    def dec(pl, h, c):
        return block_decode(cfg, pl, h, pos, c)

    x, _ = run_stack_decode(cfg, params["blocks"], caches["blocks"], x, dec,
                            cfg.n_layers)
    return lm_logits(cfg, params, x), caches


def lm_cache_specs(cfg, batch: int, max_len: int) -> Dict:
    if cfg.use_mla:
        raise NotImplementedError("MLA caches are not ported yet")
    per = A.kv_cache_specs(cfg, batch, max_len)
    return {"blocks": tree_map(
        lambda s: spec((cfg.n_layers,) + s.shape, ("layers",) + s.axes,
                       dtype=s.dtype, init="zeros"), per)}
