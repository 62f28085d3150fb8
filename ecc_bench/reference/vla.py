"""The plain reference of a VLA request under split co-inference.

Float32 PyTorch with TF32 off, written from the architecture: a ViT over
the image's patch rows (pre-norm blocks, RMSNorm, rotary positions, 64-wide
heads, non-causal attention, SwiGLU MLP at 4x width, a final norm and a
projection to the LLM width), the prompt's token embeddings after the image
rows, pre-norm LLM blocks with rotary positions (split halves) and causal
attention, the cut activation through the wire codec, then a final RMSNorm
and the action head: ``detok`` (the LM head over the last ``action_dim``
rows) or ``dit`` (adaLN DiT blocks run as DDIM over ``diffusion_steps``).

It reads the parameter tree the benchmark drew (nested dicts of stacked
tensors, keys as the configuration's model names them) and converts each
layer's weights to float32 as it reaches them; activations are computed
whole and each layer once, so the float32 copy is never larger than one
layer.  ``lowp="fp8"`` is the control: every product with a weight takes
its operands rounded to float8 e4m3 (a scale per row of the activation and
per output column of the weight), as an fp8 matrix-product path would.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import codec as wire

FP8_MAX = 448.0


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    amax = t.abs().amax(dim=dim, keepdim=True)
    s = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (t / s).to(torch.float8_e4m3fn).float() * s


def linear(x: torch.Tensor, w: torch.Tensor, lowp: Optional[str]
           ) -> torch.Tensor:
    """``x @ w`` in float32; ``lowp="fp8"`` rounds both operands first."""
    w = w.float()
    x = x.float()
    if lowp == "fp8":
        x, w = _fp8(x, -1), _fp8(w, 0)
    elif lowp is not None:
        raise ValueError(f"no precision {lowp!r}")
    return x @ w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions 0..S-1; rotation of the two halves."""
    S, D = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                          device=x.device) / D))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, causal: bool) -> torch.Tensor:
    """q, k, v: (B, S, H, D) with as many K/V heads as query heads."""
    S, D = q.shape[1], q.shape[-1]
    s = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(D)
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhst,bthd->bshd", torch.softmax(s, dim=-1), v)


def _heads(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.reshape(*t.shape[:2], n, -1)


def block(x, p: Dict, i: int, n_heads: int, n_kv: int, theta: float,
          eps: float, causal: bool, lowp) -> torch.Tensor:
    """Pre-norm block ``i`` of a stacked parameter tree."""
    a = p["attn"]
    h = rmsnorm(x, p["ln1"][i], eps)
    q = rope(_heads(linear(h, a["wq"][i], lowp), n_heads), theta)
    k = rope(_heads(linear(h, a["wk"][i], lowp), n_kv), theta)
    v = _heads(linear(h, a["wv"][i], lowp), n_kv)
    if n_kv != n_heads:
        k = k.repeat_interleave(n_heads // n_kv, dim=2)
        v = v.repeat_interleave(n_heads // n_kv, dim=2)
    o = attention(q, k, v, causal).reshape(*x.shape[:2], -1)
    x = x + linear(o, a["wo"][i], lowp)
    h = rmsnorm(x, p["ln2"][i], eps)
    m = p["mlp"]
    g = F.silu(linear(h, m["wg"][i], lowp)) * linear(h, m["wu"][i], lowp)
    return x + linear(g, m["wd"][i], lowp)


def vit(c: Dict, p: Dict, patches: torch.Tensor, lowp) -> torch.Tensor:
    dv = c["vit_dim"]
    hd = min(64, dv)
    x = patches.float() + p["pos_embed"].float()
    for i in range(c["vit_layers"]):
        x = block(x, p["blocks"], i, dv // hd, dv // hd, c["rope_theta"],
                  c["norm_eps"], False, lowp)
    return linear(rmsnorm(x, p["norm"], c["norm_eps"]), p["proj"], lowp)


def _ln(x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt((x - mu).square().mean(-1, keepdim=True)
                                  + 1e-6)


def _timestep(t: torch.Tensor, dim: int = 64) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t[:, None].float() * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def dit_eps(c: Dict, p: Dict, x: torch.Tensor, t: torch.Tensor,
            cog: torch.Tensor, lowp) -> torch.Tensor:
    """The DiT's noise prediction for actions ``x`` (B, horizon, dim) at
    timestep ``t`` (B,) under the cognition feature ``cog`` (B, d)."""
    nh = c["dit_heads"]
    cond = linear(cog, p["cond"], lowp) \
        + linear(_timestep(t), p["t_emb"], lowp)
    sc = F.silu(cond)
    h = linear(x, p["x_in"], lowp)
    b = p["blocks"]
    for i in range(c["dit_layers"]):
        sh1, sc1, g1, sh2, sc2, g2 = linear(sc, b["mod"][i], lowp)[:, None] \
            .chunk(6, dim=-1)
        u = _ln(h) * (1 + sc1) + sh1
        q, k, v = (_heads(linear(u, b[w][i], lowp), nh)
                   for w in ("wq", "wk", "wv"))
        o = attention(q, k, v, False).reshape(h.shape)
        h = h + g1 * linear(o, b["wo"][i], lowp)
        u = _ln(h) * (1 + sc2) + sh2
        h = h + g2 * linear(F.gelu(linear(u, b["w1"][i], lowp),
                                   approximate="tanh"), b["w2"][i], lowp)
    sh, scale = linear(sc, p["final_mod"], lowp)[:, None].chunk(2, dim=-1)
    return linear(_ln(h) * (1 + scale) + sh, p["out"], lowp)


def ddim(c: Dict, p: Dict, cog: torch.Tensor, noise: torch.Tensor, lowp
         ) -> torch.Tensor:
    """DDIM from ``noise`` over ``diffusion_steps`` with betas spaced
    evenly over [1e-4, 0.02]."""
    n = c["diffusion_steps"]
    dev = cog.device
    ab_all = torch.cumprod(1.0 - torch.linspace(1e-4, 0.02, n,
                                                dtype=torch.float32,
                                                device=dev), dim=0)
    x = noise.float()
    for t in range(n - 1, -1, -1):
        ab = ab_all[t]
        ab_prev = ab_all[t - 1] if t > 0 else torch.ones((), device=dev)
        eps = dit_eps(c, p, x, torch.full((x.shape[0],), t, device=dev),
                      cog, lowp)
        x0 = (x - torch.sqrt(1 - ab) * eps) / torch.sqrt(ab)
        x = torch.sqrt(ab_prev) * x0 + torch.sqrt(1 - ab_prev) * eps
    return x


class _NoTF32:
    """float32 products in float32: TF32 off inside, as it was after."""

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.prev


def _edge(c: Dict, p: Dict, patches, tokens, edge_blocks: int, lowp
          ) -> torch.Tensor:
    img = vit(c, p["vit"], patches, lowp)
    x = torch.cat([img, p["embed"][tokens.long()].float()], dim=1)
    for i in range(edge_blocks):
        x = block(x, p["blocks"], i, c["n_heads"], c["n_kv_heads"],
                  c["rope_theta"], c["norm_eps"], True, lowp)
    return x


def _cloud(c: Dict, p: Dict, x: torch.Tensor, edge_blocks: int, noise,
           lowp) -> Dict[str, torch.Tensor]:
    for i in range(edge_blocks, c["n_layers"]):
        x = block(x, p["blocks"], i, c["n_heads"], c["n_kv_heads"],
                  c["rope_theta"], c["norm_eps"], True, lowp)
    h = rmsnorm(x, p["final_norm"], c["norm_eps"])
    kind = c["vla_action_head"]
    if kind == "detok":
        a = c["action_dim"]
        return {"logits": linear(h[:, -a:], p["head"].t(), lowp)}
    if kind == "dit":
        return {"action": ddim(c, p["action"], h[:, -1], noise, lowp)}
    raise ValueError(f"no reference for the action head {kind!r}")


@torch.no_grad()
def request(c: Dict, p: Dict, patches: torch.Tensor, tokens: torch.Tensor,
            edge_blocks: int, codec: str, noise: Optional[torch.Tensor] = None,
            lowp: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """One batch of requests split after ``edge_blocks`` LLM blocks, the cut
    activation shipped through ``codec`` ("", "int8" or "int4").

    Returns ``wire``, the float32 activation the cloud reads after the
    wire, and ``logits`` (B, action_dim, vocab) for ``detok`` or ``action``
    (B, horizon, action_dim) for ``dit``."""
    with _NoTF32():
        x = wire.roundtrip(_edge(c, p, patches, tokens, edge_blocks, lowp),
                           codec)
        return {"wire": x, **_cloud(c, p, x, edge_blocks, noise, lowp)}


@torch.no_grad()
def cloud(c: Dict, p: Dict, x: torch.Tensor, edge_blocks: int,
          noise: Optional[torch.Tensor] = None, lowp: Optional[str] = None
          ) -> Dict[str, torch.Tensor]:
    """The cloud's part alone, from an activation ``x`` read after the wire:
    the blocks after ``edge_blocks``, the final norm and the action head."""
    with _NoTF32():
        return _cloud(c, p, x.float(), edge_blocks, noise, lowp)
