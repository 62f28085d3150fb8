"""The plain reference of a VLA over a sparse-expert trunk with latent
attention (Kimi-VL-A3B's language model) under split co-inference.

Float32 PyTorch with TF32 off, one layer at a time, as ``reference/vla.py``,
whose ViT, DiT head, DDIM loop and products it takes; the wire codec is
``reference/codec.py``'s.  The trunk is written from the architecture:

- every block is pre-norm: RMSNorm, multi-head latent attention (MLA), a
  residual add, RMSNorm, then a SwiGLU MLP in the first
  ``first_dense_layers`` blocks and the MoE layer in the others;
- MLA: q = h W_q, each head's 192 columns split into 128 without and 64
  with rotary positions; [c_kv, k_pe] = h W_kv_a with c_kv RMS-normed;
  k_nope = c_kv W_k_b and v = c_kv W_v_b per head; rotary positions
  (split halves, ``rope_theta``) on q_pe and on the one k_pe all heads
  share; scores (q_nope . k_nope + q_pe . k_pe) / sqrt(192), causal over
  the image rows and the prompt; the heads' outputs times W_o;
- the MoE layer: scores s = sigmoid(h W_r) in float32; the chosen set the
  ``moe_top_k`` largest of s + b, b the per-expert selection bias; gates
  g_i = ``moe_routed_scale`` * s_i / (the sum of the chosen s_j); the
  output the sum over the chosen experts of g_i SwiGLU_i(h), added in
  increasing expert id, plus the shared experts' one SwiGLU of width
  ``n_shared_experts * moe_d_ff``.  Every expert runs on its own tokens:
  no capacity, no drop.

The chosen set is a cliff: where the k-th and the next biased score lie
closer than the two sides' rounding, the program in bfloat16 and the
reference in float32 choose differently from the same input, and over the
blocks the two drift apart whole.  So the reference takes the program's
choices (``choices``: each MoE block's (tokens, k) experts, in block
order) where they are a top-k of its own biased scores up to ``TIE``: k
distinct experts, none more than ``TIE`` below the k-th largest.
Elsewhere it keeps its own, and a router that chose wrong (a bias left
out, a choice dropped, another k) reads as the output it changes.  The
gates are always the reference's own scores over the set it follows.

``lowp="fp8"`` is the control: every product with a weight, the router's
included, takes its operands rounded to float8 e4m3, as in
``reference/vla.py``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from . import codec as wire
from .vla import _NoTF32, attention, ddim, linear, rmsnorm, rope, vit

# how far below the k-th largest biased score the program's choice may lie
# and be followed: above the largest shortfall a sound program's choices
# show under bfloat16 (PERF.md), below what a wrong router's do
TIE = 0.02


def mla(c: Dict, a: Dict, i: int, h: torch.Tensor, lowp) -> torch.Tensor:
    """Multi-head latent attention of block ``i`` over ``h`` (B, S, d)."""
    B, S, _ = h.shape
    H, qn, qr, r = (c["n_heads"], c["qk_nope_dim"], c["qk_rope_dim"],
                    c["kv_lora_rank"])
    theta = c["rope_theta"]
    q = linear(h, a["wq"][i], lowp).reshape(B, S, H, qn + qr)
    q = torch.cat([q[..., :qn], rope(q[..., qn:], theta)], dim=-1)
    kv = linear(h, a["wkv_a"][i], lowp)
    c_kv = rmsnorm(kv[..., :r], a["kv_norm"][i], c["norm_eps"])
    k_pe = rope(kv[..., None, r:], theta).expand(B, S, H, qr)
    k = torch.cat([linear(c_kv, a["wk_b"][i], lowp).reshape(B, S, H, qn),
                   k_pe], dim=-1)
    v = linear(c_kv, a["wv_b"][i], lowp).reshape(B, S, H, c["v_head_dim"])
    o = attention(q, k, v, causal=True).reshape(B, S, -1)
    return linear(o, a["wo"][i], lowp)


def swiglu(x: torch.Tensor, wg, wu, wd, lowp) -> torch.Tensor:
    return linear(F.silu(linear(x, wg, lowp)) * linear(x, wu, lowp), wd,
                  lowp)


def followed(pick: torch.Tensor, theirs: Optional[torch.Tensor], k: int
             ) -> torch.Tensor:
    """(T,) whether each row of ``theirs`` is a top-``k`` of the biased
    scores ``pick`` (T, E) up to ``TIE``: all False where ``theirs`` is
    missing or of another shape."""
    T, E = pick.shape
    if theirs is None or tuple(theirs.shape) != (T, k):
        return torch.zeros(T, dtype=torch.bool, device=pick.device)
    t = theirs.to(pick.device).long().clamp(0, E - 1)
    kth = torch.topk(pick, k, dim=-1).values[:, -1:]
    distinct = (t.sort(dim=1).values.diff(dim=1) != 0).all(1)
    return distinct & (theirs.to(pick.device) == t).all(1) \
        & (pick.gather(1, t) >= kth - TIE).all(1)


def route(c: Dict, m: Dict, i: int, x: torch.Tensor, lowp,
          theirs: Optional[torch.Tensor] = None):
    """The chosen experts (T, k) of the rows ``x`` (T, d), the program's
    ``theirs`` where :func:`followed`, and their gates; the biased scores
    are the selection's margins."""
    k = c["moe_top_k"]
    s = torch.sigmoid(linear(x, m["router"][i], lowp))
    pick = s + m["bias"][i].float()
    chosen = torch.topk(pick, k, dim=-1).indices
    take = followed(pick, theirs, k)
    if take.any():
        chosen = torch.where(take[:, None], theirs.to(chosen.device).long(),
                             chosen)
    g = s.gather(1, chosen)
    return chosen, c["moe_routed_scale"] * g / g.sum(-1, keepdim=True), pick


def moe(c: Dict, m: Dict, i: int, h: torch.Tensor, lowp,
        theirs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The MoE layer of MoE block ``i`` over ``h`` (B, S, d)."""
    x = h.reshape(-1, h.shape[-1])
    chosen, gates, _ = route(c, m, i, x, lowp, theirs)
    y = torch.zeros_like(x)
    for e in range(c["n_experts"]):
        rows, slot = (chosen == e).nonzero(as_tuple=True)
        if rows.numel():
            out = swiglu(x[rows], m["wg"][i][e], m["wu"][i][e],
                         m["wd"][i][e], lowp)
            y[rows] += gates[rows, slot, None] * out
    sh = m["shared"]
    y = y + swiglu(x, sh["wg"][i], sh["wu"][i], sh["wd"][i], lowp)
    return y.reshape(h.shape)


def block(c: Dict, p: Dict, j: int, x: torch.Tensor, lowp,
          choices: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """LLM block ``j`` of the trunk: a dense block below
    ``first_dense_layers``, an MoE block from there, which follows the
    program's ``choices`` of that block (module docstring)."""
    nd = c["first_dense_layers"]
    g, i = (p["dense_blocks"], j) if j < nd else (p["moe_blocks"], j - nd)
    eps = c["norm_eps"]
    x = x + mla(c, g["attn"], i, rmsnorm(x, g["ln1"][i], eps), lowp)
    h = rmsnorm(x, g["ln2"][i], eps)
    if j < nd:
        ml = g["mlp"]
        return x + swiglu(h, ml["wg"][i], ml["wu"][i], ml["wd"][i], lowp)
    return x + moe(c, g["moe"], i, h, lowp,
                   None if choices is None else choices[i])


def _edge(c: Dict, p: Dict, patches, tokens, edge_blocks: int, lowp,
          choices) -> torch.Tensor:
    img = vit(c, p["vit"], patches, lowp)
    x = torch.cat([img, p["embed"][tokens.long()].float()], dim=1)
    for j in range(edge_blocks):
        x = block(c, p, j, x, lowp, choices)
    return x


def _cloud(c: Dict, p: Dict, x: torch.Tensor, edge_blocks: int, noise,
           lowp, choices) -> Dict[str, torch.Tensor]:
    for j in range(edge_blocks, c["n_layers"]):
        x = block(c, p, j, x, lowp, choices)
    h = rmsnorm(x, p["final_norm"], c["norm_eps"])
    if c["vla_action_head"] != "dit":
        raise ValueError("no reference for the action head "
                         f"{c['vla_action_head']!r}")
    return {"action": ddim(c, p["action"], h[:, -1], noise, lowp)}


@torch.no_grad()
def request(c: Dict, p: Dict, patches: torch.Tensor, tokens: torch.Tensor,
            edge_blocks: int, codec: str, noise: Optional[torch.Tensor] = None,
            lowp: Optional[str] = None,
            choices: Optional[Sequence[torch.Tensor]] = None
            ) -> Dict[str, torch.Tensor]:
    """One batch of requests split after ``edge_blocks`` LLM blocks, the cut
    activation shipped through ``codec`` ("", "int8" or "int4"): ``wire``,
    the float32 activation the cloud reads, and ``action`` (B, horizon,
    action_dim); each MoE block follows the program's ``choices`` of it
    (module docstring)."""
    with _NoTF32():
        x = wire.roundtrip(_edge(c, p, patches, tokens, edge_blocks, lowp,
                                 choices), codec)
        return {"wire": x,
                **_cloud(c, p, x, edge_blocks, noise, lowp, choices)}


@torch.no_grad()
def cloud(c: Dict, p: Dict, x: torch.Tensor, edge_blocks: int,
          noise: Optional[torch.Tensor] = None, lowp: Optional[str] = None,
          choices: Optional[Sequence[torch.Tensor]] = None
          ) -> Dict[str, torch.Tensor]:
    """The cloud's part alone, from an activation ``x`` read after the
    wire."""
    with _NoTF32():
        return _cloud(c, p, x.float(), edge_blocks, noise, lowp, choices)
