"""Mixture-of-Experts FFN: top-k routing, GShard capacity and drops.

Counterpart of ``src/repro/models/moe.py`` on one device (the JAX
package's ``shard_map`` branch, experts over a ``model`` mesh axis, waits
for the port's mesh; with no mesh the JAX package takes the same local
routine as here).

Per-expert capacity ``C = ceil(T * top_k / E * capacity_factor)`` (rounded
up to a multiple of 4, at least 4) with ``E`` the *unpadded* expert count;
a token's choice past its expert's capacity is dropped (contributes zero).
Dispatch gathers each expert's queue into an ``(E_tbl, C, d)`` buffer, the
three expert products are batched matrix products over it (the JAX package
leaves them to XLA as einsums, outside any kernel), and a load-balancing
auxiliary loss comes back beside the output.

The combine is a fixed-order sum, not a scatter-add: for each (token,
choice) the choice's output row is gathered from its slot, and the
choices are added one at a time in increasing expert id, in the
activations' dtype — the expert-major slot order in which the JAX package
scatter-adds them.  A scatter-add on the card (``index_add_``) would add
through atomics in an order that changes from run to run, and greedy
tokens would no longer repeat.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import dense, linear_spec, mlp
from .sharding import spec


def _pad_experts(n_experts: int, shards: int) -> int:
    return int(math.ceil(n_experts / shards) * shards)


def padded_expert_count(E: int, max_shards: int = 16) -> int:
    """Expert-table leading dim, as the JAX package pads it so that the
    table shards evenly on a 16-way ``model`` axis: 40 experts (granite)
    pad to 48.  Counts that already divide 16 — or that 16 divides — stay
    unchanged.  The pad experts receive no token."""
    if E % max_shards == 0 or max_shards % E == 0:
        return E
    return _pad_experts(E, max_shards)


def moe_specs(cfg, layers: Optional[int] = None) -> Dict:
    d, fe = cfg.d_model, cfg.moe_d_ff
    E = padded_expert_count(cfg.n_experts)
    L = () if layers is None else (layers,)
    lax = () if layers is None else ("layers",)
    out = {
        "router": spec(L + (d, cfg.n_experts), lax + ("d_model", None),
                       scale=0.02),
        "wg": spec(L + (E, d, fe), lax + ("experts", "d_model", "moe_ff")),
        "wu": spec(L + (E, d, fe), lax + ("experts", "d_model", "moe_ff")),
        "wd": spec(L + (E, fe, d), lax + ("experts", "moe_ff", "d_model")),
    }
    if cfg.n_shared_experts:
        fs = fe * cfg.n_shared_experts
        out["shared"] = {
            "wg": linear_spec(d, fs, ("d_model", "ff"), layers),
            "wu": linear_spec(d, fs, ("d_model", "ff"), layers),
            "wd": linear_spec(fs, d, ("ff", "d_model"), layers),
        }
    return out


def capacity(tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    c = int(math.ceil(tokens * top_k / n_experts * factor))
    return max(4, ((c + 3) // 4) * 4)


def _route(x2d: torch.Tensor, router: torch.Tensor, top_k: int):
    """x2d: (T, d). Returns (gates (T,k) f32, eids (T,k) int64, aux_loss).

    The logits are float32 products of the stored operands (the JAX
    package's ``preferred_element_type=f32``); ``topk`` sorts descending,
    as ``lax.top_k`` does."""
    logits = torch.matmul(x2d.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gates, eids = torch.topk(probs, top_k, dim=-1, sorted=True)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    # GShard aux loss: E * sum_e(frac_tokens_e * mean_prob_e)
    E = probs.shape[-1]
    me = probs.mean(dim=0)
    ce = F.one_hot(eids[:, 0], E).float().mean(dim=0)
    aux = E * (me * ce).sum()
    return gates, eids, aux


def _local_expert_ffn(x2d, gates, eids, wg, wu, wd, *, E: int, C: int):
    """Gather -> expert FFN -> fixed-order combine for every expert of the
    table ``wg``/``wu`` (E_tbl, d, f), ``wd`` (E_tbl, f, d).

    x2d: (T, d); gates/eids: (T, k).  Returns (T, d) in x2d's dtype."""
    T, d = x2d.shape
    k = eids.shape[1]
    E_tbl = wg.shape[0]
    dev = x2d.device
    # position of each (token, choice) in its expert's queue
    onehot = F.one_hot(eids, E).sum(dim=1)                       # (T, E)
    pos_all = torch.cumsum(onehot, dim=0) - onehot               # (T, E)
    pos = torch.gather(pos_all, 1, eids)                         # (T, k)
    kept = (eids < E_tbl) & (pos < C)
    sentinel = E_tbl * C
    slot = torch.where(kept, eids * C + pos,
                       torch.full_like(eids, sentinel))
    # each kept slot holds one token; empty slots read the zero row T
    tok = torch.arange(T, device=dev)[:, None].expand(T, k)
    idx = torch.full((sentinel + 1,), T, dtype=torch.int64, device=dev)
    idx[slot.reshape(-1)] = tok.reshape(-1)
    xpad = torch.cat([x2d, x2d.new_zeros((1, d))], dim=0)
    buf = xpad[idx[:sentinel]].reshape(E_tbl, C, d)
    h = F.silu(dense(buf, wg)) * dense(buf, wu)
    out = dense(h, wd).reshape(sentinel, d)
    out = torch.cat([out, out.new_zeros((1, d))], dim=0)         # dropped: 0
    # the choices of a token in increasing expert id (= slot order), each
    # weighted by its gate, then added one at a time in that order
    order = torch.argsort(eids, dim=1)
    slot_o = torch.gather(slot, 1, order)
    gate_o = torch.gather(gates, 1, order).to(out.dtype)
    contrib = (out[slot_o] * gate_o[..., None]).to(x2d.dtype)   # (T, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


def moe_ffn(cfg, p: Dict, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B,S,d), aux_loss scalar)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    x2d = x.reshape(B * S, d)
    gates, eids, aux = _route(x2d, p["router"], k)
    C = capacity(B * S, E, k, cfg.moe_capacity_factor)
    y = _local_expert_ffn(x2d, gates, eids, p["wg"], p["wu"], p["wd"],
                          E=E, C=C).reshape(B, S, d)
    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], x)
    return y, aux
