"""Cache utilities: allocation, prefill->decode padding, accounting.

Counterpart of ``src/repro/runtime/kvcache.py``.  The analytic KV sizing
(``kv_bytes_per_token``, ``request_kv_tokens``, ``graph_kv_cumsum``) and
``ReferenceLedger`` are numpy-only there and are the port's own copies
here, statement for statement, held equal to the reference by
``tests/test_torch_serving.py``.  ``alloc_cache``, ``pad_cache`` and
``cache_bytes`` work on tensors.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import require_device
from ..models.sharding import tree_leaves, tree_map

Tree = Any

# graph layer kinds that materialize a decode-time KV cache (attention
# blocks); ViT/encoder/mamba/DiT/head stages run once per request and
# hold no KV across decode steps
KV_KINDS = ("llm", "moe")


def kv_bytes_per_token(cfg, act_bytes: int = 2) -> float:
    """Per-token per-attention-layer KV cache bytes for ``cfg``.

    Standard attention stores K and V per kv-head; MLA (DeepSeek) stores
    the compressed latent (``kv_lora_rank``) plus the decoupled RoPE key
    (``qk_rope_dim``) instead.
    """
    if getattr(cfg, "use_mla", False):
        return (cfg.kv_lora_rank + cfg.qk_rope_dim) * act_bytes
    return 2 * cfg.n_kv_heads * cfg.resolved_head_dim * act_bytes


def request_kv_tokens(workload) -> int:
    """Tokens resident in the cache at the end of a request: the full
    context + the new chunk + one slot per decode step."""
    return workload.s_ctx + workload.s_new + workload.decode_steps


def graph_kv_cumsum(graph: List, cfg, workload) -> np.ndarray:
    """Suffix cumulative KV bytes over a layer graph: ``out[s]`` is the
    full per-request KV footprint of layers ``[s, n)``, so a placement
    window's cloud-side KV is ``out[s1] - out[s2]`` — the same window
    convention as ``GraphArrays``' cost cumsums."""
    per_layer = kv_bytes_per_token(cfg, workload.act_bytes) \
        * request_kv_tokens(workload) * workload.batch
    has_kv = np.array([1.0 if c.kind in KV_KINDS else 0.0 for c in graph])
    out = np.zeros(len(graph) + 1)
    out[:-1] = per_layer * has_kv[::-1].cumsum()[::-1]
    return out


class ReferenceLedger:
    """Byte accounting for the cloud-side temporal-delta reference cache.

    The delta codec keeps one reference activation per robot on the
    cloud so later frames can ship only changed token rows.  Those
    references live in the same accelerator memory as the KV cache, so
    they compete with it: this ledger tracks bytes per key (robot id)
    against an optional budget and evicts deterministically when a
    ``put`` overflows it.

    Eviction is FIFO-by-refresh: keys are held in dict insertion order,
    a ``put`` of an existing key moves it to the back (its reference
    was just refreshed), and overflow evicts from the front — the
    robots whose references are stalest.  The evicted keys are returned
    so the caller can force those robots onto a key frame next step.
    Determinism (no clocks, no hashing randomness) is what keeps the
    tick and event engines bit-identical when a budget is set.
    """

    def __init__(self, budget_bytes: Optional[float] = None):
        self.budget_bytes = budget_bytes
        self._bytes: Dict[int, float] = {}
        self.total_bytes = 0.0

    def put(self, key: int, n_bytes: float) -> List[int]:
        """Record ``key``'s reference at ``n_bytes``, refreshing its
        eviction position; returns the (possibly empty) list of keys
        evicted to fit the budget.  The new key itself is never evicted
        even when ``n_bytes`` alone exceeds the budget — a reference
        that can never be held would force key frames forever without
        ever reporting an eviction."""
        old = self._bytes.pop(key, 0.0)
        self.total_bytes -= old
        self._bytes[key] = float(n_bytes)
        self.total_bytes += float(n_bytes)
        evicted: List[int] = []
        if self.budget_bytes is not None:
            for k in list(self._bytes):
                if self.total_bytes <= self.budget_bytes or k == key:
                    break
                self.total_bytes -= self._bytes.pop(k)
                evicted.append(k)
        return evicted

    def drop(self, key: int) -> None:
        """Forget ``key``'s reference (robot left, or its cache was
        invalidated out-of-band).  Missing keys are a no-op."""
        old = self._bytes.pop(key, None)
        if old is not None:
            self.total_bytes -= old


def alloc_cache(model, batch: int, max_len: int, device="cuda",
                **kw) -> Tree:
    """Zero-allocate the full decode cache on ``device`` (the card unless
    the caller asks for the CPU)."""
    dev = require_device(device)
    specs = model.cache_specs(batch, max_len, **kw)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=dev), specs)


def pad_cache(cache: Tree, specs: Tree) -> Tree:
    """Zero-pad every cache leaf up to its full-size spec shape.

    Prefill produces caches sized to the prompt; decode wants
    max_len-sized buffers.  Dims only ever differ along the sequence axis,
    so a generic per-dim pad is safe.  Each leaf is copied once into a new
    buffer of the spec's shape and dtype, on the leaf's device.  On a
    bound mesh a ``DTensor`` leaf is gathered, padded and placed again as
    the prefill placed it under the installed rules (a sequence-sharded
    cache's shards do not line up before and after the pad).  Those are
    its spec's placements under ``tp``; under ``fsdp`` a spec names the
    batch's mesh axes twice, and the prefill places the cache on the batch
    alone (the rules' ``cache_*`` axes)."""
    from ..models.sharding import bound_mesh, is_dtensor

    def one(x, s):
        m = bound_mesh()
        if m is not None and is_dtensor(x):
            from torch.distributed.tensor import Replicate, distribute_tensor
            full = one(x.full_tensor(), s)
            pl = [Replicate() if p.is_partial() else p for p in x.placements]
            return distribute_tensor(full, m.device_mesh, pl,
                                     src_data_rank=None)
        for have, want in zip(x.shape, s.shape):
            if have > want:
                raise ValueError(f"cache leaf {tuple(x.shape)} is larger "
                                 f"than its spec {tuple(s.shape)}")
        if tuple(x.shape) == tuple(s.shape):
            return x.to(s.dtype)
        out = torch.zeros(s.shape, dtype=s.dtype, device=x.device)
        out[tuple(slice(0, n) for n in x.shape)] = x
        return out

    return tree_map(one, cache, specs)


def cache_bytes(cache: Tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(cache))
