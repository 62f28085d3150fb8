"""VLA models — the paper's own evaluation targets (OpenVLA, CogACT).

Counterpart of ``src/repro/models/vla.py``: ViT encoder (patch embeddings
-> vit blocks -> project to LLM width) + LLM backbone + action decoder
S_dec in {detok, MLP, LSTM, diffusion, DiT} (paper §IV-A).  ``detok``
(OpenVLA) reads the LM head; the other four read the cognition feature,
the final hidden state of the last position (:func:`decode_action`).  The
training loss is :func:`vla_loss`.

Where the JAX package draws the initial noise of the ``diffusion`` and
``dit`` heads from a key, the port takes the noise as an argument (drawn
by :func:`draw_noise` from an explicit ``torch.Generator`` when left out),
so that a test can feed both packages the same draw; :func:`vla_loss`
takes the DiT's timesteps and noise the same way.

On a mesh the ViT runs as the encoder does (its non-causal attention on
each rank's heads, ``attention._sdpa_local``; ``vit_heads`` / ``vit_ff``
over ``model``), the LLM blocks as the dense blocks, and the action head
(the DiT, the ``mlp``, ``lstm`` and ``diffusion`` heads) replicated over
``model`` on each rank's tokens (:func:`_replicated`).  A VLA serves whole
requests, so on a mesh its path is the loss and the train step.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .. import to_dtype
from . import attention as A
from .layers import (dense, embed, embed_spec, linear_spec, mlp, mlp_specs,
                     rmsnorm, rmsnorm_spec, softmax_xent, unembed)
from .sharding import is_dtensor, shard, spec, tree_map
from .transformer import (_groups, block_forward, dense_block_specs,
                          moe_block_specs, run_stack)

HEADS = ("detok", "", "mlp", "lstm", "diffusion", "dit")
NOISY_HEADS = ("diffusion", "dit")      # heads that start from a draw


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
        h = shard(h + mlp(pl["mlp"], rmsnorm(h, pl["ln2"], cfg.norm_eps)),
                  "batch", "seq", None)
        return h, None, 0.0

    x, _, _ = run_stack(vit_cfg, p["blocks"], x, one, cfg.vit_layers)
    x = rmsnorm(x, p["norm"], cfg.norm_eps)
    return dense(x, p["proj"])


# ------------------------------------------------------------- action heads
def action_head_specs(cfg) -> Dict:
    d, a, h = cfg.d_model, cfg.action_dim, cfg.action_horizon
    kind = cfg.vla_action_head
    if kind in ("detok", ""):
        return {}
    if kind == "mlp":
        return {
            "w1": linear_spec(d, 4 * d, ("d_model", "ff")),
            "w2": linear_spec(4 * d, d, ("ff", "d_model")),
            "out": linear_spec(d, a * h, ("d_model", None)),
        }
    if kind == "lstm":
        return {
            "wx": linear_spec(d, 4 * d, ("d_model", "ff")),
            "wh": linear_spec(d, 4 * d, ("d_model", "ff")),
            "b": spec((4 * d,), ("ff",), init="zeros"),
            "out": linear_spec(d, a, ("d_model", None)),
        }
    if kind == "diffusion":  # small conditional denoising MLP
        return {
            "in": linear_spec(a * h + d + 64, d, (None, "d_model")),
            "mid": linear_spec(d, d, ("d_model", None)),
            "out": linear_spec(d, a * h, ("d_model", None)),
        }
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
    raise ValueError(f"unknown action head {kind!r}")


def _timestep_freqs(device, dim: int = 64) -> torch.Tensor:
    """The timestep embedding's frequencies, made on ``device`` with no
    copy from the host (a CUDA graph cannot capture one)."""
    half = dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=device)
    return torch.exp(-torch.log(torch.full((), 10_000.0, device=device))
                     * idx / half)


def _fourier(t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    ang = t[..., None].float() * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _timestep_embed(t: torch.Tensor, dim: int = 64) -> torch.Tensor:
    return _fourier(t, _timestep_freqs(t.device, dim))


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


def dit_denoise(cfg, p, noisy: torch.Tensor, t: torch.Tensor,
                cognition: torch.Tensor):
    """noisy: (B, horizon, action_dim); t: (B,); cognition: (B, d_model)."""
    return _dit_eps(cfg, p, noisy, t, dense(cognition, p["cond"]),
                    _timestep_freqs(t.device))


def _dit_eps(cfg, p, noisy, t, cog_cond, freqs):
    """:func:`dit_denoise` from the cognition's conditioning product
    ``cog_cond`` (B, dit_dim) and the embedding's ``freqs``."""
    dt = to_dtype(cfg.dtype)
    x = dense(noisy.to(dt), p["x_in"])
    cond = cog_cond + dense(_fourier(t, freqs).to(dt), p["t_emb"])

    def one(pl, h):
        return _dit_block(cfg, pl, h, cond), None, 0.0

    x, _, _ = run_stack(cfg, p["blocks"], x, one, cfg.dit_layers)
    m = dense(F.silu(cond.float()).to(x.dtype), p["final_mod"])
    sh, sc = m[:, None, :].chunk(2, dim=-1)
    return dense(_ln(x) * (1 + sc) + sh, p["out"])     # predicted noise


def check_noise(cfg, cognition: torch.Tensor, noise: torch.Tensor) -> None:
    """``noise`` must be the (B, action_horizon, action_dim) draw of the
    DiT head for ``cognition``'s batch B."""
    want = (cognition.shape[0], cfg.action_horizon, cfg.action_dim)
    if tuple(noise.shape) != want:
        raise ValueError(f"noise {tuple(noise.shape)} != {want}")


def ddim_constants(cfg, device) -> tuple:
    """What the DDIM loop reads besides its inputs, the same in every call:
    the timestep embedding's frequencies and, indexed by the timestep t,
    sqrt(1 - ab_t), sqrt(ab_t), sqrt(ab_{t-1}) and sqrt(1 - ab_{t-1})
    (ab_{-1} = 1), all float32 on ``device``."""
    n = cfg.diffusion_steps
    betas = torch.linspace(1e-4, 0.02, n, dtype=torch.float32, device=device)
    ab = torch.cumprod(1.0 - betas, dim=0)
    prev = torch.cat([torch.ones((1,), dtype=torch.float32, device=device),
                      ab[:-1]])
    return (_timestep_freqs(device), torch.sqrt(1 - ab), torch.sqrt(ab),
            torch.sqrt(prev), torch.sqrt(1 - prev))


def dit_ddim(cfg, p, cog_cond: torch.Tensor, x: torch.Tensor,
             consts: tuple) -> torch.Tensor:
    """The DDIM loop of :func:`dit_sample` from the cognition's
    conditioning product ``cog_cond`` (B, dit_dim), the float32 noise ``x``
    and :func:`ddim_constants`: nothing in it copies from the host or waits
    for the device, so a CUDA graph can capture it."""
    freqs, s1ab, sab, sprev, s1prev = consts
    B, n = x.shape[0], cfg.diffusion_steps
    for i in range(n):
        t = n - 1 - i
        eps = _dit_eps(cfg, p, x, torch.full((B,), t, device=x.device),
                       cog_cond, freqs).float()
        x0 = (x - s1ab[t] * eps) / sab[t]
        x = sprev[t] * x0 + s1prev[t] * eps
    return x


def dit_sample(cfg, p, cognition: torch.Tensor, noise: torch.Tensor
               ) -> torch.Tensor:
    """DDIM sampling over cfg.diffusion_steps, starting from ``noise`` of
    shape (B, action_horizon, action_dim), float32."""
    check_noise(cfg, cognition, noise)
    dev = cognition.device
    return dit_ddim(cfg, p, dense(cognition, p["cond"]),
                    noise.to(device=dev, dtype=torch.float32),
                    ddim_constants(cfg, dev))


def _gelu(x):
    return F.gelu(x, approximate="tanh")        # jax.nn.gelu's default


def mlp_head(cfg, p, cog: torch.Tensor) -> torch.Tensor:
    """cognition (B, d_model) -> action chunk (B, horizon, action_dim)."""
    z = _gelu(dense(cog, p["w1"]))
    z = _gelu(dense(z, p["w2"]))
    return dense(z, p["out"]).reshape(-1, cfg.action_horizon, cfg.action_dim)


def lstm_head(cfg, p, cog: torch.Tensor) -> torch.Tensor:
    """An LSTM unrolled over the horizon on the constant cognition input;
    the cell state stays float32, the hidden state in the cognition's
    dtype, as in the JAX package."""
    B, d = cog.shape
    hs = torch.zeros((B, d), dtype=cog.dtype, device=cog.device)
    cs = torch.zeros((B, d), dtype=torch.float32, device=cog.device)
    acts = []
    for _ in range(cfg.action_horizon):
        g = dense(cog, p["wx"]) + dense(hs, p["wh"]) + p["b"]
        i, f, o, c = g.float().chunk(4, dim=-1)
        cs = torch.sigmoid(f) * cs + torch.sigmoid(i) * torch.tanh(c)
        hs = (torch.sigmoid(o) * torch.tanh(cs)).to(cog.dtype)
        acts.append(dense(hs, p["out"]))
    return torch.stack(acts, dim=1)


def diffusion_head(cfg, p, cog: torch.Tensor, noise: torch.Tensor
                   ) -> torch.Tensor:
    """cfg.diffusion_steps of a conditional denoising MLP, starting from
    ``noise`` of shape (B, horizon * action_dim), float32."""
    B = cog.shape[0]
    if tuple(noise.shape) != noise_shape(cfg, B):
        raise ValueError(f"noise {tuple(noise.shape)} != "
                         f"{noise_shape(cfg, B)}")
    n = cfg.diffusion_steps
    x = noise.to(device=cog.device, dtype=torch.float32)
    for t in range(n - 1, -1, -1):
        te = _timestep_embed(torch.full((B,), t, device=cog.device))
        inp = torch.cat([x.to(cog.dtype), cog, te.to(cog.dtype)], dim=-1)
        eps = dense(_gelu(dense(_gelu(dense(inp, p["in"])), p["mid"])),
                    p["out"])
        x = x - eps.float() / n
    return x.reshape(B, cfg.action_horizon, cfg.action_dim)


def noise_shape(cfg, batch: int) -> tuple:
    """The initial draw of a head in ``NOISY_HEADS``."""
    h, a = cfg.action_horizon, cfg.action_dim
    if cfg.vla_action_head == "diffusion":
        return (batch, h * a)
    return (batch, h, a)


def decode_action(cfg, p, cog: torch.Tensor, noise=None) -> torch.Tensor:
    """A head that reads the cognition feature (every head but ``detok``):
    (B, d_model) -> (B, horizon, action_dim).  ``noise`` is the initial
    draw of the ``diffusion`` and ``dit`` heads."""
    kind = cfg.vla_action_head
    if kind == "mlp":
        return mlp_head(cfg, p, cog)
    if kind == "lstm":
        return lstm_head(cfg, p, cog)
    if kind not in NOISY_HEADS:
        raise ValueError(f"action head {kind!r} does not read the "
                         "cognition feature")
    if noise is None:
        raise ValueError(f"the {kind!r} head needs its initial noise")
    head = diffusion_head if kind == "diffusion" else dit_sample
    return head(cfg, p, cog, noise)


# ------------------------------------------------------------------ VLA model
def trunk_specs(cfg) -> Dict:
    """The LLM trunk's stacks by group name: ``blocks`` for a dense trunk;
    for one with experts ``dense_blocks`` (the first
    ``first_dense_layers``) then ``moe_blocks``, attention MLA where the
    config says so."""
    out = {}
    for name, n, is_moe in _groups(cfg):
        out[name] = moe_block_specs(cfg, n) if is_moe \
            else dense_block_specs(cfg, n)
    return out


def vla_specs(cfg) -> Dict:
    return {
        "vit": vit_specs(cfg),
        "embed": embed_spec(cfg.vocab_size, cfg.d_model),
        **trunk_specs(cfg),
        "final_norm": rmsnorm_spec(cfg.d_model),
        "head": embed_spec(cfg.vocab_size, cfg.d_model),
        "action": action_head_specs(cfg),
    }


def vla_backbone(cfg, params, patches, tokens, *, remat=False):
    """ViT + LLM over [img ; text] -> hidden states (B, P+S, d)."""
    img = vit_encode(cfg, params["vit"], patches)
    txt = embed(params["embed"], tokens).to(to_dtype(cfg.dtype))
    x = torch.cat([img, txt], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    for name, n, is_moe in _groups(cfg):
        def one(pl, h, _moe=is_moe):
            h, _, a = block_forward(cfg, pl, h, positions, is_moe=_moe)
            return h, None, a

        x, _, _ = run_stack(cfg, params[name], x, one, n, remat=remat)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def _replicated(tree):
    """The action head's parameters replicated over the mesh (no-op off
    one): the DiT and the small heads run whole on every rank, on its
    tokens, where the rules would shard their products over ``model``."""
    return tree_map(lambda w: shard(w, *(None,) * w.dim())
                    if is_dtensor(w) else w, tree)


def detokenize(logits: torch.Tensor) -> torch.Tensor:
    """Greedy action tokens -> 256 uniform bins over [-1, 1]:
    (B, action_dim, V) -> (B, 1, action_dim)."""
    toks = torch.argmax(logits, dim=-1)
    act = (toks % 256).float() / 127.5 - 1.0
    return act[:, None, :]


def draw_noise(cfg, batch: int, device, generator: Optional[torch.Generator]
               ) -> torch.Tensor:
    """The initial noise of the ``diffusion`` or ``dit`` head from an
    explicit generator (seed 0 when none is given, as the JAX package
    defaults its key)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.randn(noise_shape(cfg, batch), generator=generator,
                       device=device, dtype=torch.float32)


def vla_forward(cfg, params, patches, tokens, noise=None, generator=None):
    """Inference: returns action (B, horizon, action_dim)."""
    kind = cfg.vla_action_head
    if kind not in HEADS:
        raise ValueError(f"unknown action head {kind!r}")
    h = vla_backbone(cfg, params, patches, tokens)
    if kind in ("detok", ""):
        return detokenize(unembed(params["head"], h[:, -cfg.action_dim:],
                                  cfg.vocab_size))
    cog = h[:, -1]                                        # cognition feature
    if kind in NOISY_HEADS and noise is None:
        noise = draw_noise(cfg, cog.shape[0], cog.device, generator)
    return decode_action(cfg, _replicated(params["action"]), cog, noise)


def vla_loss(cfg, params, patches, tokens, action_labels,
             generator: Optional[torch.Generator] = None, *, t=None,
             noise=None) -> torch.Tensor:
    """Training loss: ``detok`` -> cross entropy on the binned first action
    of the chunk; ``dit`` -> the noise-prediction MSE at timesteps ``t``
    (B,) and ``noise`` (the actions' shape); ``mlp``, ``lstm`` and
    ``diffusion`` -> the MSE of the predicted chunk (``noise``: the
    diffusion head's initial draw).  What is not given is drawn from
    ``generator`` (seed 0 when none is given)."""
    h = vla_backbone(cfg, params, patches, tokens, remat=cfg.remat)
    kind = cfg.vla_action_head
    if kind in ("detok", ""):
        logits = unembed(params["head"], h[:, -cfg.action_dim:],
                         cfg.vocab_size)
        bins = torch.clamp((action_labels[:, 0].float() + 1) * 127.5, 0, 255)
        return softmax_xent(logits, bins.to(torch.int32))
    cog = h[:, -1]
    pa = _replicated(params["action"])
    dev, B = cog.device, cog.shape[0]
    if generator is None and ((kind == "dit" and (t is None or noise is None))
                              or (kind == "diffusion" and noise is None)):
        generator = torch.Generator(device=dev).manual_seed(0)
    labels = action_labels.to(device=dev, dtype=torch.float32)
    if kind == "dit":
        n = cfg.diffusion_steps
        if t is None:
            t = torch.randint(0, n, (B,), generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(labels.shape, generator=generator,
                                device=dev, dtype=torch.float32)
        t = t.to(device=dev, dtype=torch.int64)
        noise = noise.to(device=dev, dtype=torch.float32)
        betas = torch.linspace(1e-4, 0.02, n, dtype=torch.float32,
                               device=dev)
        ab = torch.cumprod(1.0 - betas, dim=0)[t][:, None, None]
        noisy = torch.sqrt(ab) * labels + torch.sqrt(1 - ab) * noise
        eps = dit_denoise(cfg, pa, noisy, t, cog)
        return ((eps.float() - noise) ** 2).mean()
    if kind == "diffusion" and noise is None:
        noise = draw_noise(cfg, B, dev, generator)
    if noise is not None:
        noise = noise.to(device=dev, dtype=torch.float32)
    pred = decode_action(cfg, pa, cog, noise)
    return ((pred.float() - labels) ** 2).mean()
