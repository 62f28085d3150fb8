"""Decoder-only LM assembly for the dense and MoE families.

Counterpart of ``src/repro/models/transformer.py``: full-sequence forward,
prefill and one-token decode.  Layer parameters are
**stacked** along a leading ``layers`` dim, as in the JAX package, and a
layer's weights are views into the stack — nothing is copied to run a
layer.  The stack runs as a Python loop (``cfg.scan_layers`` has no
meaning here); with ``remat`` each layer is checkpointed while autograd
records (``torch.utils.checkpoint``, as ``jax.checkpoint`` in the JAX
package), so its activations are recomputed in the backward.  The
training loss is :func:`lm_loss`; serving (:func:`lm_prefill`,
:func:`lm_decode`) runs without autograd.

An MoE model runs its layers in groups (:func:`_groups`): the
``dense_blocks`` first (deepseek-v2-lite-16b has one), then the
``moe_blocks``, each group a stack of its own; attention is MLA where the
config says so (``use_mla``).  On a mesh the residual stream is constrained
to be replicated over ``model`` after each block, as in the JAX package.

Caches follow the same convention: stacked ``(L, B, S_max, KV*hd)``
tensors per group (MLA: ``c_kv`` and ``k_pe``).  Decode writes each
layer's new entries in place into its view of the stack, so a step never
re-stacks (copies) the cache, and :func:`lm_decode` returns the same
tensors it was given.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import to_dtype
from . import attention as A
from .layers import (embed, embed_spec, mlp, mlp_specs, rmsnorm, rmsnorm_spec,
                     softmax_xent, unembed)
from .moe import moe_ffn, moe_specs
from .sharding import in_current_mesh, shard, spec, tree_leaves, tree_map

Tree = Any


# ================================================================= specs
def _attn_specs(cfg, layers):
    return A.mla_specs(cfg, layers) if cfg.use_mla \
        else A.attn_specs(cfg, layers)


def dense_block_specs(cfg, layers: Optional[int] = None,
                      d_ff: Optional[int] = None):
    d = cfg.d_model
    ff = d_ff if d_ff is not None else cfg.d_ff
    out = {
        "ln1": rmsnorm_spec(d, layers),
        "attn": _attn_specs(cfg, layers),
        "mlp": mlp_specs(d, ff, layers),
    }
    if not cfg.parallel_block:
        out["ln2"] = rmsnorm_spec(d, layers)
    return out


def moe_block_specs(cfg, layers: Optional[int] = None):
    d = cfg.d_model
    return {
        "ln1": rmsnorm_spec(d, layers),
        "attn": _attn_specs(cfg, layers),
        "ln2": rmsnorm_spec(d, layers),
        "moe": moe_specs(cfg, layers),
    }


def lm_specs(cfg) -> Dict:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    V, d = cfg.vocab_size, cfg.d_model
    specs: Dict = {"embed": embed_spec(V, d), "final_norm": rmsnorm_spec(d)}
    if cfg.family == "moe":
        nd = cfg.first_dense_layers
        if nd:
            specs["dense_blocks"] = dense_block_specs(cfg, nd)
        specs["moe_blocks"] = moe_block_specs(cfg, cfg.n_layers - nd)
    else:
        specs["blocks"] = dense_block_specs(cfg, cfg.n_layers)
    if not cfg.tie_embeddings:
        specs["head"] = embed_spec(V, d)
    return specs


# ================================================================ block fwd
def _self_attn(cfg, p, x, positions, *, return_kv=False):
    if cfg.use_mla:
        return A.mla_forward(cfg, p, x, positions, causal=cfg.causal,
                             return_kv=return_kv)
    return A.attn_forward(cfg, p, x, positions, causal=cfg.causal,
                          return_kv=return_kv)


def block_forward(cfg, p: Dict, x: torch.Tensor, positions: torch.Tensor,
                  *, is_moe: bool = False, return_kv: bool = False):
    """Returns (x, kv_cache_or_None, aux_loss)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a = _self_attn(cfg, p["attn"], h, positions, return_kv=return_kv)
    a, kv = a if return_kv else (a, None)
    if cfg.parallel_block and not is_moe:
        # command-r: shared-norm parallel residual
        return shard(x + a + mlp(p["mlp"], h), "batch", "seq", None), kv, 0.0
    x = x + a
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if is_moe:
        m, aux = moe_ffn(cfg, p["moe"], h)
    else:
        m, aux = mlp(p["mlp"], h), 0.0
    return shard(x + m, "batch", "seq", None), kv, aux


def block_decode(cfg, p: Dict, x: torch.Tensor, pos, cache: Dict, *,
                 is_moe: bool = False):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        a, cache = A.mla_decode(cfg, p["attn"], h, pos, cache)
    else:
        a, cache = A.attn_decode(cfg, p["attn"], h, pos, cache)
    if cfg.parallel_block and not is_moe:
        return x + a + mlp(p["mlp"], h), cache
    x = x + a
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    m = moe_ffn(cfg, p["moe"], h)[0] if is_moe else mlp(p["mlp"], h)
    return x + m, cache


# ================================================================ stack run
def _layer_slice(tree: Tree, i: int) -> Tree:
    """Layer ``i`` of a stacked tree, as views."""
    return tree_map(lambda w: w[i], tree)


def run_stack(cfg, blocks_p: Tree, x: torch.Tensor, fwd_one, n_layers: int,
              *, remat: bool = False, collect: bool = False):
    """fwd_one(layer_params, x) -> (x, ys, aux).  Loops over the stack;
    with ``remat``, each layer is recomputed in the backward."""
    ys_list, aux = [], 0.0
    fn = fwd_one
    if remat and torch.is_grad_enabled():
        # the recompute runs in autograd's thread: it takes the mesh along
        layer = in_current_mesh(fwd_one)

        def fn(pl, h):
            return checkpoint(layer, pl, h, use_reentrant=False)
    # one unbind per leaf: its backward stacks the layers' gradients once,
    # where a view per layer would write a stack-sized gradient per layer
    layers = tree_map(lambda w: w.unbind(0), blocks_p)
    for i in range(n_layers):
        x, ys, a = fn(tree_map(lambda u: u[i], layers), x)
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
def _groups(cfg):
    """[(name, n_layers, is_moe)] in execution order."""
    if cfg.family == "moe":
        g = []
        if cfg.first_dense_layers:
            g.append(("dense_blocks", cfg.first_dense_layers, False))
        g.append(("moe_blocks", cfg.n_layers - cfg.first_dense_layers, True))
        return g
    return [("blocks", cfg.n_layers, False)]


def lm_hidden(cfg, params: Dict, tokens: torch.Tensor, *,
              remat: Optional[bool] = None):
    """Token ids -> final hidden states (pre final-norm). Returns (h, aux)."""
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    x = embed(params["embed"], tokens).to(to_dtype(cfg.dtype))
    aux = 0.0
    for name, _, is_moe in _groups(cfg):
        def one(pl, h, _moe=is_moe):
            h, _, a = block_forward(cfg, pl, h, positions, is_moe=_moe)
            return h, None, a

        n = tree_leaves(params[name])[0].shape[0]
        x, _, a = run_stack(cfg, params[name], x, one, n,
                            remat=cfg.remat if remat is None else remat)
        aux = aux + a
    return x, aux


def lm_logits(cfg, params: Dict, h: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    w = params["embed"] if cfg.tie_embeddings else params["head"]
    return unembed(w, h, cfg.vocab_size)


def lm_loss(cfg, params: Dict, tokens: torch.Tensor, labels: torch.Tensor,
            *, aux_coef: float = 0.01) -> torch.Tensor:
    """Token-mean cross entropy plus ``aux_coef`` times the MoE layers'
    load-balancing loss (0 for a dense model)."""
    h, aux = lm_hidden(cfg, params, tokens)
    return softmax_xent(lm_logits(cfg, params, h), labels) + aux_coef * aux


@torch.no_grad()
def lm_prefill(cfg, params: Dict, tokens: torch.Tensor):
    """Prefill: returns (last-position logits, stacked caches per group)."""
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    x = embed(params["embed"], tokens).to(to_dtype(cfg.dtype))
    caches: Dict = {}
    for name, n, is_moe in _groups(cfg):
        def one(pl, h, _moe=is_moe):
            return block_forward(cfg, pl, h, positions, is_moe=_moe,
                                 return_kv=True)

        x, caches[name], _ = run_stack(cfg, params[name], x, one, n,
                                       collect=True)
    logits = lm_logits(cfg, params, x[:, -1:])
    return logits, caches


@torch.no_grad()
def lm_decode(cfg, params: Dict, caches: Dict, tokens: torch.Tensor, pos):
    """One decode step. tokens: (B,1); pos: the current position (int or
    0-dim tensor).  ``caches`` are updated in place and returned."""
    x = embed(params["embed"], tokens).to(to_dtype(cfg.dtype))
    for name, n, is_moe in _groups(cfg):
        def dec(pl, h, c, _moe=is_moe):
            return block_decode(cfg, pl, h, pos, c, is_moe=_moe)

        x, _ = run_stack_decode(cfg, params[name], caches[name], x, dec, n)
    return lm_logits(cfg, params, x), caches


def lm_cache_specs(cfg, batch: int, max_len: int) -> Dict:
    per = (A.mla_cache_specs if cfg.use_mla else A.kv_cache_specs)(
        cfg, batch, max_len)
    return {name: tree_map(
        lambda s, n=n: spec((n,) + s.shape, ("layers",) + s.axes,
                            dtype=s.dtype, init="zeros"), per)
        for name, n, _ in _groups(cfg)}
