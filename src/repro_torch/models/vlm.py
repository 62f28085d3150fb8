"""VLM backbone (llama-3.2-vision-11b): decoder LM + gated cross-attn layers.

Counterpart of ``src/repro/models/vlm.py``, the training loss
:func:`vlm_loss` included.  Every ``cfg.cross_attn_every``-th layer is followed
by a gated cross-attention sublayer (tanh-gated attention + tanh-gated
MLP, the tanh in float32) over precomputed vision-patch embeddings
``(B, n_vision_tokens, d_model)`` (the modality frontend is a stub, as in
the JAX package).

On the card the dense blocks' causal prefill attention is the flash
attention kernel (B5) and their one-token decode the flash-decode kernel
(B6); cross attention is plain products (``attention._sdpa``), as the JAX
package leaves it to XLA.  Caches: ``self``, the dense blocks' K/V stacked
over all ``n_layers``; ``cross``, the vision K/V stacked over the cross
layers, computed once in the prefill.  Decode hands each group a view of
``self`` (basic slicing), into which ``attn_decode`` writes the new K/V in
place, and returns the caches it was given.

On a mesh the dense blocks run as in ``models/transformer.py`` and the
cross attention on each rank's query heads (``attention._sdpa_local``);
the cross caches are sharded on their KV heads over ``model``, as the self
caches are.
"""
from __future__ import annotations

from typing import Dict

import torch

from .. import to_dtype
from . import attention as A
from .layers import (embed, embed_spec, mlp, mlp_specs, rmsnorm, rmsnorm_spec,
                     softmax_xent)
from .sharding import shard, spec, tree_map
from .transformer import (_layer_slice, block_decode, block_forward,
                          dense_block_specs, lm_cache_specs, lm_logits,
                          run_stack, run_stack_decode)


def _n_cross(cfg) -> int:
    return cfg.n_layers // cfg.cross_attn_every


def cross_block_specs(cfg, layers):
    d = cfg.d_model
    return {
        "ln1": rmsnorm_spec(d, layers),
        "attn": A.attn_specs(cfg, layers, cross=True),
        "gate_attn": spec((layers, 1), ("layers", None), init="zeros"),
        "ln2": rmsnorm_spec(d, layers),
        "mlp": mlp_specs(d, cfg.d_ff, layers),
        "gate_mlp": spec((layers, 1), ("layers", None), init="zeros"),
    }


def vlm_specs(cfg) -> Dict:
    s = {
        "embed": embed_spec(cfg.vocab_size, cfg.d_model),
        "blocks": dense_block_specs(cfg, cfg.n_layers),
        "cross_blocks": cross_block_specs(cfg, _n_cross(cfg)),
        "final_norm": rmsnorm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        s["head"] = embed_spec(cfg.vocab_size, cfg.d_model)
    return s


def _gate(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(g.float()).to(x.dtype)


def _cross_layer(cfg, pl, x, vision=None, kv_cache=None, return_kv=False):
    h = rmsnorm(x, pl["ln1"], cfg.norm_eps)
    a, ckv = A.cross_attn_forward(cfg, pl["attn"], h, kv_x=vision,
                                  kv_cache=kv_cache)
    x = x + _gate(pl["gate_attn"], x) * a
    m = mlp(pl["mlp"], rmsnorm(x, pl["ln2"], cfg.norm_eps))
    x = shard(x + _gate(pl["gate_mlp"], x) * m, "batch", "seq", None)
    return (x, ckv) if return_kv else x


def _group(tree, g: int, k: int):
    """Layers ``[g*k, (g+1)*k)`` of a stacked tree, as views."""
    return tree_map(lambda w: w[g * k:(g + 1) * k], tree)


def _hidden(cfg, params, tokens, vision, *, remat=False,
            collect_caches=False):
    x = embed(params["embed"], tokens).to(to_dtype(cfg.dtype))
    vision = vision.to(x.dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    k = cfg.cross_attn_every
    self_caches, cross_caches = [], []

    def one(pl, h):
        return block_forward(cfg, pl, h, positions, is_moe=False,
                             return_kv=collect_caches)

    for g in range(_n_cross(cfg)):
        x, kv, _ = run_stack(cfg, _group(params["blocks"], g, k), x, one, k,
                             remat=remat, collect=collect_caches)
        pl_cross = _layer_slice(params["cross_blocks"], g)
        if collect_caches:
            self_caches.append(kv)
            x, ckv = _cross_layer(cfg, pl_cross, x, vision=vision,
                                  return_kv=True)
            cross_caches.append(ckv)
        else:
            x = _cross_layer(cfg, pl_cross, x, vision=vision)
    if collect_caches:
        self_kv = tree_map(lambda *l: torch.cat(l), *self_caches)
        cross_kv = tree_map(lambda *l: torch.stack(l), *cross_caches)
        return x, {"self": self_kv, "cross": cross_kv}
    return x


def vlm_logits(cfg, params, tokens, vision):
    """Logits of every position (the full forward)."""
    return lm_logits(cfg, params, _hidden(cfg, params, tokens, vision))


def vlm_loss(cfg, params, tokens, vision, labels) -> torch.Tensor:
    h = _hidden(cfg, params, tokens, vision, remat=cfg.remat)
    return softmax_xent(lm_logits(cfg, params, h), labels)


@torch.no_grad()
def vlm_prefill(cfg, params, tokens, vision):
    x, caches = _hidden(cfg, params, tokens, vision, collect_caches=True)
    return lm_logits(cfg, params, x[:, -1:]), caches


@torch.no_grad()
def vlm_decode(cfg, params, caches, tokens, pos):
    """One decode step; the self caches are written in place through the
    groups' views and ``caches`` is returned as it came."""
    x = embed(params["embed"], tokens).to(to_dtype(cfg.dtype))
    k = cfg.cross_attn_every

    def dec(pl, h, c):
        return block_decode(cfg, pl, h, pos, c, is_moe=False)

    for g in range(_n_cross(cfg)):
        x, _ = run_stack_decode(cfg, _group(params["blocks"], g, k),
                                _group(caches["self"], g, k), x, dec, k)
        x = _cross_layer(cfg, _layer_slice(params["cross_blocks"], g), x,
                         kv_cache=_layer_slice(caches["cross"], g))
    return lm_logits(cfg, params, x), caches


def vlm_cache_specs(cfg, batch: int, max_len: int) -> Dict:
    self_kv = lm_cache_specs(cfg, batch, max_len)["blocks"]
    per = A.kv_cache_specs(cfg, batch, cfg.n_vision_tokens)
    cross = tree_map(lambda s: spec((_n_cross(cfg),) + s.shape,
                                    ("layers",) + s.axes, dtype=s.dtype,
                                    init="zeros"), per)
    return {"self": self_kv, "cross": cross}
