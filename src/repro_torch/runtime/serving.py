"""Serving steps: prefill + autoregressive decode with preallocated caches.

Counterpart of ``src/repro/runtime/serving.py``.  PyTorch runs eagerly, so
the serve step is a plain callable; the JAX package donates the cache to
its jitted step, and the port gets the same effect by writing each step's
K/V into the cache in place (``models/attention.py::attn_decode``).  A
cache handed to a step is therefore updated, whatever ``donate`` says.
On the card every layer of every step launches the flash-decode kernel
(B6) and every layer of the prefill the flash-attention kernel (B5).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from .kvcache import pad_cache

Tree = Any


def prefill_and_pad(model, params: Tree, batch: Dict, max_len: int,
                    **cache_kw) -> Tuple[torch.Tensor, Tree]:
    """Run prefill, then zero-pad caches to `max_len` decode buffers."""
    logits, cache = model.prefill(params, batch)
    specs = model.cache_specs(batch["tokens"].shape[0], max_len, **cache_kw)
    return logits, pad_cache(cache, specs)


def make_serve_step(model, donate: bool = True):
    """One-token decode step: (params, cache, tokens, pos) -> (logits,
    cache).  The cache is updated in place; ``donate`` is accepted for
    the JAX package's signature and changes nothing."""
    return functools.partial(_serve_step, model)


@torch.no_grad()
def _serve_step(model, params, cache, tokens, pos):
    return model.decode(params, cache, tokens, pos)


@torch.no_grad()
def greedy_generate(model, params: Tree, batch: Dict, n_steps: int,
                    max_len: Optional[int] = None, **cache_kw):
    """Prefill + greedy decode n_steps tokens. Returns (B, n_steps) ids."""
    prompt_len = batch["tokens"].shape[1]
    max_len = max_len or (prompt_len + n_steps)
    logits, cache = prefill_and_pad(model, params, batch, max_len, **cache_kw)
    step = make_serve_step(model, donate=False)
    toks = []
    cur = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    for i in range(n_steps):
        toks.append(cur)
        logits, cache = step(params, cache, cur, prompt_len + i)
        cur = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    return torch.cat(toks, dim=1)
