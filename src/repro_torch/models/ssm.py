"""Mamba2 (SSD — state-space duality) blocks: chunked prefill and O(1)
decode, and the SSM language model.

Counterpart of ``src/repro/models/ssm.py`` without the mesh annotations
(``shard``); the training loss is :func:`ssm_lm_loss`.

``ssd_chunked`` is the plain version of the SSD scan, in the JAX package's
own precision: ``xdt``, the masked scores and the incoming chunk states are
rounded to the input's type, as there.  ``mamba_forward`` and
``mamba_prefill`` reach the scan through
``kernels.ssd_scan.ops.ssd_scan``: the hand-written kernel for a CUDA
tensor, ``ssd_chunked`` for a CPU tensor.  (The JAX package reaches its
Pallas kernel only from ``mamba_forward`` with ``impl="pallas"``; its
prefill always runs the jnp version.)  Decode (``ssd_step``) has no kernel
in either package.

Decode states are stacked ``(L, B, ...)`` tensors, and
:func:`mamba_decode` writes the new SSD state and the three conv tails
into its layer's views of them **in place** (the JAX package returns
updated copies, which its serving step donates), so a step copies no
state.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import to_dtype
from ..kernels.ssd_scan import ops as ssd_ops
from .layers import dense, embed, embed_spec, linear_spec, rmsnorm, \
    rmsnorm_spec, softmax_xent, unembed
from .sharding import spec, tree_map
from .transformer import run_stack, run_stack_decode


# ------------------------------------------------------------------ specs
def mamba_specs(cfg, layers: Optional[int] = None) -> Dict:
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H, W = cfg.ssm_nheads, cfg.ssm_conv
    L = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)
    return {
        "norm": rmsnorm_spec(d, layers),
        "wz": linear_spec(d, di, ("d_model", "inner"), layers),
        "wx": linear_spec(d, di, ("d_model", "inner"), layers),
        "wB": linear_spec(d, N, ("d_model", None), layers),
        "wC": linear_spec(d, N, ("d_model", None), layers),
        "wdt": linear_spec(d, H, ("d_model", "inner"), layers),
        "dt_bias": spec(L + (H,), lax_ + ("inner",), init="zeros"),
        "A_log": spec(L + (H,), lax_ + ("inner",), init="zeros"),
        "D": spec(L + (H,), lax_ + ("inner",), init="ones"),
        "conv_x": spec(L + (W, di), lax_ + (None, "inner"), scale=0.5),
        "conv_B": spec(L + (W, N), lax_ + (None, None), scale=0.5),
        "conv_C": spec(L + (W, N), lax_ + (None, None), scale=0.5),
        "gate_norm": spec(L + (di,), lax_ + ("inner",), init="ones"),
        "wo": linear_spec(di, d, ("inner", "d_model"), layers),
    }


def ssm_state_specs(cfg, batch: int) -> Dict:
    """Decode-time recurrent state (per layer)."""
    di, N = cfg.d_inner, cfg.ssm_state
    H, P, W = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_conv
    dt = to_dtype(cfg.dtype)
    return {
        "ssd": spec((batch, H, N, P), ("batch", "act_inner", None, None),
                    dtype=torch.float32, init="zeros"),
        "conv_x": spec((batch, W - 1, di), ("batch", None, "act_inner"),
                       dtype=dt, init="zeros"),
        "conv_B": spec((batch, W - 1, N), ("batch", None, None), dtype=dt,
                       init="zeros"),
        "conv_C": spec((batch, W - 1, N), ("batch", None, None), dtype=dt,
                       init="zeros"),
    }


# ------------------------------------------------------------------ helpers
def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B,T,C); w: (W,C). Depthwise causal conv, silu activation."""
    W = w.shape[0]
    T = x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    y = xp[:, 0:T] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + T] * w[i]
    return F.silu(y)


def _conv_step(x: torch.Tensor, w: torch.Tensor, cache: torch.Tensor):
    """x: (B,C); cache: (B,W-1,C). Returns (y (B,C), the new cache).  The
    new cache is a new tensor: the caller copies it into place."""
    W = w.shape[0]
    s = cache[:, 0] * w[0]
    for i in range(1, W - 1):
        s = s + cache[:, i] * w[i]
    y = x * w[-1] + s
    new = torch.cat([cache[:, 1:], x[:, None].to(cache.dtype)], dim=1)
    return F.silu(y), new


# ------------------------------------------------------------------ SSD core
def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD forward.

    x:  (B, T, H, P)   inputs
    dt: (B, T, H)      positive step sizes
    A:  (H,)           negative decay rates
    Bm: (B, T, N), Cm: (B, T, N)  (n_groups=1, shared across heads)
    Returns (y (B,T,H,P), final_state (B,H,N,P) float32).
    """
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, T)
    pad = (-T) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    Tp = T + pad
    nc = Tp // Q
    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H).float()
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)

    dA = dtc * A.float()                                   # (B,nc,Q,H) <= 0
    # inclusive cumsum, accumulated in float64 and rounded once (what
    # torch's CPU cumsum does for float32; on the card it would accumulate
    # in float32 and drift by a few units in the last place of |cs|)
    dA_cs = torch.cumsum(dA.double(), dim=2).to(dA.dtype)
    xdt = xc * dtc[..., None].to(xc.dtype)

    # ---- intra-chunk (quadratic within chunk, decay-masked)
    seg = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]  # (B,nc,Q,K,H)
    ii = torch.arange(Q, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    # masked before the exp, not after: above the diagonal seg is the decay
    # run backwards (up to +177 over a 256-chunk of Mamba2 at init), whose
    # exp overflows, and a where after the exp would pass the backward
    # 0 * inf = NaN there (the JAX package's gradient is NaN at a full
    # chunk); the values are the same either way
    L = torch.exp(torch.where(causal[None, None, :, :, None], seg,
                              torch.full((), -torch.inf, device=x.device)))
    CB = torch.einsum("bcqn,bckn->bcqk", Cc.float(), Bc.float())
    scores = (CB[..., None] * L).to(xc.dtype)              # (B,nc,Q,K,H)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores, xdt)

    # ---- chunk states
    decay_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)      # (B,nc,Q,H)
    wgt = xdt * decay_end[..., None].to(xc.dtype)
    S_c = torch.einsum("bckn,bckhp->bchnp", Bc.float(),
                       wgt.float())                        # (B,nc,H,N,P)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])             # (B,nc,H)

    # ---- inter-chunk recurrence
    S = (initial_state.float() if initial_state is not None
         else torch.zeros((Bsz, H, N, P), dtype=torch.float32,
                          device=x.device))
    S_ins = []
    for c in range(nc):
        S_ins.append(S)
        S = S * chunk_decay[:, c, :, None, None] + S_c[:, c]
    S_ins = torch.stack(S_ins, dim=1)                       # (B,nc,H,N,P)

    y_inter = torch.einsum("bcqn,bchnp->bcqhp", Cc, S_ins.to(xc.dtype))
    y_inter = y_inter * torch.exp(dA_cs)[..., None].to(xc.dtype)
    y = (y_intra + y_inter).reshape(Bsz, Tp, H, P)
    return y[:, :T], S


def ssd_step(S: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
             A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single recurrent step. S:(B,H,N,P) x:(B,H,P) dt:(B,H) Bm/Cm:(B,N)."""
    dtf = dt.float()
    dA = torch.exp(dtf * A.float())                        # (B,H)
    upd = torch.einsum("bn,bhp->bhnp", Bm.float(),
                       (x * dt[..., None]).float())
    S = S * dA[:, :, None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), S)
    return y.to(x.dtype), S


# ------------------------------------------------------------------ block
def _proj(cfg, p, u):
    """Shared input projections + activations for prefill and decode."""
    z = dense(u, p["wz"])
    xi = dense(u, p["wx"])
    Bm = dense(u, p["wB"])
    Cm = dense(u, p["wC"])
    dt = F.softplus(dense(u, p["wdt"]).float() + p["dt_bias"].float())
    return z, xi, Bm, Cm, dt


def _gate_out(cfg, p, y, xh, z):
    """Skip (D), gated RMSNorm and the output projection."""
    B, T = y.shape[:2]
    y = y + xh * p["D"].to(xh.dtype)[:, None]
    y = y.reshape(B, T, cfg.d_inner)
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p["gate_norm"],
                cfg.norm_eps)
    return dense(y, p["wo"])


def mamba_forward(cfg, p: Dict, x: torch.Tensor):
    """Full-sequence Mamba2 block (pre-norm, residual outside).  The SSD
    scan runs as the device of ``x`` decides (no ``impl`` switch)."""
    B, T, d = x.shape
    H, P = cfg.ssm_nheads, cfg.ssm_headdim
    u = rmsnorm(x, p["norm"], cfg.norm_eps)
    z, xi, Bm, Cm, dt = _proj(cfg, p, u)
    xi = _causal_conv(xi, p["conv_x"])
    Bm = _causal_conv(Bm, p["conv_B"])
    Cm = _causal_conv(Cm, p["conv_C"])
    A = -torch.exp(p["A_log"].float())
    xh = xi.reshape(B, T, H, P)
    y, _ = ssd_ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    return _gate_out(cfg, p, y, xh, z)


def _tail(pre_conv_in: torch.Tensor, W: int) -> torch.Tensor:
    """Last W-1 raw (pre-activation) conv inputs, for decode handoff."""
    T = pre_conv_in.shape[1]
    pad = max(W - 1 - T, 0)
    x = F.pad(pre_conv_in, (0, 0, pad, 0))
    return x[:, -(W - 1):]


def mamba_prefill(cfg, p: Dict, x: torch.Tensor):
    """Forward + recurrent state for decode handoff."""
    B, T, d = x.shape
    H, P, W = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_conv
    u = rmsnorm(x, p["norm"], cfg.norm_eps)
    z, xi_raw, Bm_raw, Cm_raw, dt = _proj(cfg, p, u)
    xi = _causal_conv(xi_raw, p["conv_x"])
    Bm = _causal_conv(Bm_raw, p["conv_B"])
    Cm = _causal_conv(Cm_raw, p["conv_C"])
    A = -torch.exp(p["A_log"].float())
    xh = xi.reshape(B, T, H, P)
    y, S = ssd_ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    out = _gate_out(cfg, p, y, xh, z)
    state = {"ssd": S,
             "conv_x": _tail(xi_raw, W),
             "conv_B": _tail(Bm_raw, W),
             "conv_C": _tail(Cm_raw, W)}
    return out, state


def mamba_decode(cfg, p: Dict, x: torch.Tensor, state: Dict):
    """One-token step. x: (B,1,d).  ``state`` (this layer's views of the
    stacked decode state) is updated in place and returned."""
    B = x.shape[0]
    H, P = cfg.ssm_nheads, cfg.ssm_headdim
    u = rmsnorm(x[:, 0], p["norm"], cfg.norm_eps)
    z, xi, Bm, Cm, dt = _proj(cfg, p, u)
    xi, cx = _conv_step(xi, p["conv_x"], state["conv_x"])
    Bm, cB = _conv_step(Bm, p["conv_B"], state["conv_B"])
    Cm, cC = _conv_step(Cm, p["conv_C"], state["conv_C"])
    A = -torch.exp(p["A_log"].float())
    y, S = ssd_step(state["ssd"], xi.reshape(B, H, P), dt, A, Bm, Cm)
    for name, new in (("ssd", S), ("conv_x", cx), ("conv_B", cB),
                      ("conv_C", cC)):
        state[name].copy_(new)
    out = _gate_out(cfg, p, y[:, None], xi.reshape(B, 1, H, P), z[:, None])
    return out, state


# ================================================================ SSM LM
def ssm_lm_specs(cfg) -> Dict:
    s = {
        "embed": embed_spec(cfg.vocab_size, cfg.d_model),
        "mamba": mamba_specs(cfg, cfg.n_layers),
        "final_norm": rmsnorm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        s["head"] = embed_spec(cfg.vocab_size, cfg.d_model)
    return s


def ssm_logits(cfg, params: Dict, h: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    w = params["embed"] if cfg.tie_embeddings else params["head"]
    return unembed(w, h, cfg.vocab_size)


def ssm_lm_hidden(cfg, params: Dict, tokens: torch.Tensor, *,
                  remat: bool = False) -> torch.Tensor:
    """Token ids -> final hidden states (pre final-norm), every position."""
    x = embed(params["embed"], tokens).to(to_dtype(cfg.dtype))

    def one(pl, h):
        return h + mamba_forward(cfg, pl, h), None, 0.0

    x, _, _ = run_stack(cfg, params["mamba"], x, one, cfg.n_layers,
                        remat=remat)
    return x


def ssm_lm_loss(cfg, params: Dict, tokens: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    h = ssm_lm_hidden(cfg, params, tokens, remat=cfg.remat)
    return softmax_xent(ssm_logits(cfg, params, h), labels)


@torch.no_grad()
def ssm_lm_prefill(cfg, params: Dict, tokens: torch.Tensor):
    x = embed(params["embed"], tokens).to(to_dtype(cfg.dtype))

    def one(pl, h):
        out, st = mamba_prefill(cfg, pl, h)
        return h + out, st, 0.0

    x, states, _ = run_stack(cfg, params["mamba"], x, one, cfg.n_layers,
                             collect=True)
    return ssm_logits(cfg, params, x[:, -1:]), states


@torch.no_grad()
def ssm_lm_decode(cfg, params: Dict, states: Dict, tokens: torch.Tensor,
                  pos):
    """One decode step; ``states`` are updated in place and returned."""
    x = embed(params["embed"], tokens).to(to_dtype(cfg.dtype))

    def dec(pl, h, st):
        out, st = mamba_decode(cfg, pl, h, st)
        return h + out, st

    x, states = run_stack_decode(cfg, params["mamba"], states, x, dec,
                                 cfg.n_layers)
    return ssm_logits(cfg, params, x), states


def ssm_lm_cache_specs(cfg, batch: int) -> Dict:
    per = ssm_state_specs(cfg, batch)
    return tree_map(
        lambda s: spec((cfg.n_layers,) + s.shape, ("layers",) + s.axes,
                       dtype=s.dtype, init="zeros"), per)
