"""VLA models — the paper's own evaluation targets (OpenVLA, CogACT).

Counterpart of ``src/repro/models/vla.py``: ViT encoder (patch embeddings
-> vit blocks -> project to LLM width) + LLM backbone + action decoder.
Ported here are the two heads the paper's models use: ``detok`` (OpenVLA)
and ``dit`` (CogACT, DDIM sampling).  The ``mlp``, ``lstm`` and
``diffusion`` heads and the training loss are not ported yet and raise.

Where the JAX package draws the DiT's initial noise from a key,
:func:`dit_sample` takes the noise as an argument, so that a test can feed
both packages the same draw.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .. import to_dtype
from . import attention as A
from .layers import (dense, embed, embed_spec, linear_spec, mlp, mlp_specs,
                     rmsnorm, rmsnorm_spec, unembed)
from .sharding import spec
from .transformer import block_forward, dense_block_specs, run_stack

_PORTED_HEADS = ("detok", "", "dit")


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"action head {kind!r} is not ported yet; have 'detok' and 'dit'")


# ------------------------------------------------------------------ ViT
def _vit_cfg(cfg):
    dv = cfg.vit_dim
    hd = min(64, dv)
    return cfg.replace(d_model=dv, n_heads=dv // hd, n_kv_heads=dv // hd,
                       head_dim=hd, d_ff=4 * dv, causal=False,
                       use_mla=False, parallel_block=False, qkv_bias=False)


def vit_specs(cfg) -> Dict:
    dv = cfg.vit_dim
    vit_cfg = _vit_cfg(cfg)
    return {
        "pos_embed": spec((cfg.n_patches, dv), (None, None), scale=0.02),
        "blocks": {
            "ln1": rmsnorm_spec(dv, cfg.vit_layers),
            "attn": A.attn_specs(vit_cfg, cfg.vit_layers),
            "ln2": rmsnorm_spec(dv, cfg.vit_layers),
            "mlp": mlp_specs(dv, 4 * dv, cfg.vit_layers),
        },
        "norm": rmsnorm_spec(dv),
        "proj": linear_spec(dv, cfg.d_model, ("d_model", None)),
    }


@torch.no_grad()
def vit_encode(cfg, p, patches: torch.Tensor) -> torch.Tensor:
    """patches: (B, n_patches, vit_dim) -> (B, n_patches, d_model)."""
    vit_cfg = _vit_cfg(cfg)
    dt = to_dtype(cfg.dtype)
    x = patches.to(dt) + p["pos_embed"].to(dt)
    positions = torch.arange(x.shape[1], device=x.device)

    def one(pl, h):
        a = A.attn_forward(vit_cfg, pl["attn"],
                           rmsnorm(h, pl["ln1"], cfg.norm_eps), positions,
                           causal=False)
        h = h + a
        h = h + mlp(pl["mlp"], rmsnorm(h, pl["ln2"], cfg.norm_eps))
        return h, None, 0.0

    x, _, _ = run_stack(vit_cfg, p["blocks"], x, one, cfg.vit_layers)
    x = rmsnorm(x, p["norm"], cfg.norm_eps)
    return dense(x, p["proj"])


# ------------------------------------------------------------- action heads
def action_head_specs(cfg) -> Dict:
    d, a = cfg.d_model, cfg.action_dim
    kind = cfg.vla_action_head
    if kind in ("detok", ""):
        return {}
    if kind == "dit":
        dd = cfg.dit_dim
        return {
            "x_in": linear_spec(a, dd, (None, None)),
            "cond": linear_spec(d, dd, ("d_model", None)),
            "t_emb": linear_spec(64, dd, (None, None)),
            "blocks": {
                "mod": linear_spec(dd, 6 * dd, (None, None), cfg.dit_layers,
                                   init="zeros"),
                "wq": linear_spec(dd, dd, (None, "q_heads"), cfg.dit_layers),
                "wk": linear_spec(dd, dd, (None, "q_heads"), cfg.dit_layers),
                "wv": linear_spec(dd, dd, (None, "q_heads"), cfg.dit_layers),
                "wo": linear_spec(dd, dd, ("q_heads", None), cfg.dit_layers),
                "w1": linear_spec(dd, 4 * dd, (None, "ff"), cfg.dit_layers),
                "w2": linear_spec(4 * dd, dd, ("ff", None), cfg.dit_layers),
            },
            "final_mod": linear_spec(dd, 2 * dd, (None, None), init="zeros"),
            "out": linear_spec(dd, a, (None, None), init="zeros"),
        }
    if kind in ("mlp", "lstm", "diffusion"):
        raise _not_ported(kind)
    raise ValueError(f"unknown action head {kind!r}")


def _timestep_embed(t: torch.Tensor, dim: int = 64) -> torch.Tensor:
    half = dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(-torch.log(torch.tensor(10_000.0, device=t.device))
                      * idx / half)
    ang = t[..., None].float() * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _ln(x):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + 1e-6)).to(x.dtype)


def _dit_block(cfg, pl, x, cond):
    """x: (B, H, dd); cond: (B, dd). adaLN-zero DiT block."""
    dd = cfg.dit_dim
    nh = cfg.dit_heads
    hd = dd // nh
    m = dense(F.silu(cond.float()).to(x.dtype), pl["mod"])
    sh1, sc1, g1, sh2, sc2, g2 = m[:, None, :].chunk(6, dim=-1)
    h = _ln(x) * (1 + sc1) + sh1
    B, H, _ = x.shape
    q = dense(h, pl["wq"]).reshape(B, H, nh, hd)
    k = dense(h, pl["wk"]).reshape(B, H, nh, hd).permute(0, 2, 1, 3)
    v = dense(h, pl["wv"]).reshape(B, H, nh, hd).permute(0, 2, 1, 3)
    o = A._sdpa(q, k, v, causal=False)
    x = x + g1 * dense(o.reshape(B, H, dd), pl["wo"])
    h = _ln(x) * (1 + sc2) + sh2
    x = x + g2 * dense(F.gelu(dense(h, pl["w1"]), approximate="tanh"),
                       pl["w2"])
    return x


@torch.no_grad()
def dit_denoise(cfg, p, noisy: torch.Tensor, t: torch.Tensor,
                cognition: torch.Tensor):
    """noisy: (B, horizon, action_dim); t: (B,); cognition: (B, d_model)."""
    dt = to_dtype(cfg.dtype)
    x = dense(noisy.to(dt), p["x_in"])
    cond = dense(cognition, p["cond"]) + dense(_timestep_embed(t).to(dt),
                                               p["t_emb"])

    def one(pl, h):
        return _dit_block(cfg, pl, h, cond), None, 0.0

    x, _, _ = run_stack(cfg, p["blocks"], x, one, cfg.dit_layers)
    m = dense(F.silu(cond.float()).to(x.dtype), p["final_mod"])
    sh, sc = m[:, None, :].chunk(2, dim=-1)
    return dense(_ln(x) * (1 + sc) + sh, p["out"])     # predicted noise


@torch.no_grad()
def dit_sample(cfg, p, cognition: torch.Tensor, noise: torch.Tensor
               ) -> torch.Tensor:
    """DDIM sampling over cfg.diffusion_steps, starting from ``noise`` of
    shape (B, action_horizon, action_dim), float32."""
    B = cognition.shape[0]
    a, h = cfg.action_dim, cfg.action_horizon
    if tuple(noise.shape) != (B, h, a):
        raise ValueError(f"noise {tuple(noise.shape)} != {(B, h, a)}")
    dev = cognition.device
    x = noise.to(device=dev, dtype=torch.float32)
    n = cfg.diffusion_steps
    betas = torch.linspace(1e-4, 0.02, n, dtype=torch.float32, device=dev)
    alphas = torch.cumprod(1.0 - betas, dim=0)
    one = torch.ones((), dtype=torch.float32, device=dev)
    for i in range(n):
        t = n - 1 - i
        ab = alphas[t]
        ab_prev = alphas[t - 1] if t > 0 else one
        eps = dit_denoise(cfg, p, x, torch.full((B,), t, device=dev),
                          cognition).float()
        x0 = (x - torch.sqrt(1 - ab) * eps) / torch.sqrt(ab)
        x = torch.sqrt(ab_prev) * x0 + torch.sqrt(1 - ab_prev) * eps
    return x


# ------------------------------------------------------------------ VLA model
def vla_specs(cfg) -> Dict:
    return {
        "vit": vit_specs(cfg),
        "embed": embed_spec(cfg.vocab_size, cfg.d_model),
        "blocks": dense_block_specs(cfg, cfg.n_layers),
        "final_norm": rmsnorm_spec(cfg.d_model),
        "head": embed_spec(cfg.vocab_size, cfg.d_model),
        "action": action_head_specs(cfg),
    }


@torch.no_grad()
def vla_backbone(cfg, params, patches, tokens, *, remat=False):
    """ViT + LLM over [img ; text] -> hidden states (B, P+S, d)."""
    img = vit_encode(cfg, params["vit"], patches)
    txt = embed(params["embed"], tokens).to(to_dtype(cfg.dtype))
    x = torch.cat([img, txt], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)

    def one(pl, h):
        h, _, a = block_forward(cfg, pl, h, positions)
        return h, None, a

    x, _, _ = run_stack(cfg, params["blocks"], x, one, cfg.n_layers)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def detokenize(logits: torch.Tensor) -> torch.Tensor:
    """Greedy action tokens -> 256 uniform bins over [-1, 1]:
    (B, action_dim, V) -> (B, 1, action_dim)."""
    toks = torch.argmax(logits, dim=-1)
    act = (toks % 256).float() / 127.5 - 1.0
    return act[:, None, :]


def draw_noise(cfg, batch: int, device, generator: Optional[torch.Generator]
               ) -> torch.Tensor:
    """The DiT's initial noise from an explicit generator (seed 0 when none
    is given, as the JAX package defaults its key)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.randn((batch, cfg.action_horizon, cfg.action_dim),
                       generator=generator, device=device,
                       dtype=torch.float32)


@torch.no_grad()
def vla_forward(cfg, params, patches, tokens, noise=None, generator=None):
    """Inference: returns action (B, horizon, action_dim)."""
    kind = cfg.vla_action_head
    if kind not in _PORTED_HEADS:
        raise _not_ported(kind)
    h = vla_backbone(cfg, params, patches, tokens)
    if kind in ("detok", ""):
        return detokenize(unembed(params["head"], h[:, -cfg.action_dim:],
                                  cfg.vocab_size))
    cog = h[:, -1]                                        # cognition feature
    if noise is None:
        noise = draw_noise(cfg, cog.shape[0], cog.device, generator)
    return dit_sample(cfg, params["action"], cog, noise)


def vla_loss(cfg, params, patches, tokens, action_labels, key=None):
    raise NotImplementedError("training is not ported yet (inference only)")
