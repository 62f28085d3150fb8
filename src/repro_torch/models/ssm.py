"""Mamba2 (SSD — state-space duality) blocks: chunked prefill and O(1)
decode, and the SSM language model.

Counterpart of ``src/repro/models/ssm.py``, its three activation
constraints (``shard``) included; the training loss is :func:`ssm_lm_loss`.

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

On a mesh (``models/sharding.py``) ``d_inner``, and so the SSD heads,
shard over ``model`` (``inner`` / ``act_inner``); B and C (the state dim,
one group) stay replicated.  The per-head part of a block — the depthwise
convs, the scan (B7 on each rank's heads), the D skip and the gate — runs
in a ``local_map`` region (:func:`_mix_sharded`); the gated RMSNorm over
the whole ``d_inner`` adds the ranks' sums of squares (:func:`_gate_norm`);
decode writes each rank's heads of the state in place through the local
shards, which must carry ``ssm_state_specs``' placements.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import to_dtype
from ..kernels.ssd_scan import ops as ssd_ops
from .layers import dense, embed, embed_spec, linear_spec, rmsnorm, \
    rmsnorm_spec, softmax_xent, unembed
from .sharding import (P, act_axis, act_shards, batch_axes, bound_mesh,
                       check_placements, contiguous_grad, is_dtensor,
                       local_region, placements, resolve, shard, spec,
                       tree_map)
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


def _mix(cfg, z, xi, Bm, Cm, dt, conv_x, conv_B, conv_C, A_log, D, *,
         state: bool = False):
    """The per-head part of a block over the heads it is given (all of
    them, or one rank's): the depthwise causal convs, the SSD scan (B7 on
    the card), the D skip and the silu(z) gate, before the gated norm.
    With ``state``: also the final SSD state and the three raw conv tails
    for the decode handoff."""
    B, T, di = xi.shape
    P, W = cfg.ssm_headdim, cfg.ssm_conv
    H = di // P
    x = _causal_conv(xi, conv_x)
    b = _causal_conv(Bm, conv_B)
    c = _causal_conv(Cm, conv_C)
    A = -torch.exp(A_log.float())
    xh = x.reshape(B, T, H, P)
    y, S = ssd_ops.ssd_scan(xh, dt, A, b, c, chunk=cfg.ssm_chunk)
    y = y + xh * D.to(xh.dtype)[:, None]
    y = y.reshape(B, T, di) * F.silu(z.float()).to(y.dtype)
    if not state:
        return y
    return y, S, _tail(xi, W), _tail(Bm, W), _tail(Cm, W)


def _on_mesh(t) -> bool:
    return is_dtensor(t) and bound_mesh() is not None


def _heads_axis(cfg) -> Optional[str]:
    """The mesh axis the rules shard the SSD heads over (``act_inner``),
    checked to divide them."""
    ax = act_axis("act_inner")
    n = act_shards("act_inner")
    if cfg.ssm_nheads % n:
        raise ValueError(f"{cfg.ssm_nheads} SSD heads do not shard over "
                         f"{ax}={n}")
    return ax


def _mix_sharded(cfg, p, z, xi, Bm, Cm, dt, *, state: bool = False):
    """:func:`_mix` in a region on each rank's heads: x, z, dt, A and D
    (and conv_x's channels) sharded on heads, B and C (N, one group)
    replicated.  Replicated inputs read by each rank for its own heads, or
    by each data rank for its own tokens, get their gradients as pending
    sums."""
    ax, b = _heads_axis(cfg), resolve(("batch",))[0]
    inner, rep = P(b, None, ax), P(b, None, None)

    def local(*args):
        return _mix(cfg, *(contiguous_grad(t) for t in args), state=state)

    out = [inner, P(b, ax, None, None), inner, rep, rep] if state else inner
    return local_region(
        local, out,
        (inner, inner, rep, rep, inner, P(None, ax), P(None, None),
         P(None, None), P(ax), P(ax)),
        partial_grad=batch_axes() + ((ax,) if ax else ()))(
        z, xi, Bm, Cm, dt, p["conv_x"], p["conv_B"], p["conv_C"],
        p["A_log"], p["D"])


def _gate_norm(cfg, y, w):
    """The gated RMSNorm over the whole ``d_inner``.  On a mesh each rank
    sums the squares of its own channels and the ranks' sums are added
    (a pending sum that :func:`shard` reduces) before the scale, in float32
    as :func:`rmsnorm` does."""
    if not _on_mesh(y):
        return rmsnorm(y, w, cfg.norm_eps)
    ax, b = act_axis("act_inner"), resolve(("batch",))[0]
    ss = local_region(
        lambda y_: y_.float().square().sum(-1, keepdim=True),
        P(b, None, None), (P(b, None, ax),),
        partial_out=(ax,) if ax else ())(y)
    ss = shard(ss, "batch", "seq", None)
    inv = torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps).to(y.dtype)
    return (y * inv) * w.to(y.dtype)


def _out(cfg, p, y):
    y = _gate_norm(cfg, y, p["gate_norm"])
    y = shard(y, "batch", "seq", "act_inner")
    return dense(y, p["wo"])


def _mix_params(p):
    return (p["conv_x"], p["conv_B"], p["conv_C"], p["A_log"], p["D"])


def mamba_forward(cfg, p: Dict, x: torch.Tensor):
    """Full-sequence Mamba2 block (pre-norm, residual outside).  The SSD
    scan runs as the device of ``x`` decides (no ``impl`` switch); on a
    mesh, on each rank's heads."""
    u = rmsnorm(x, p["norm"], cfg.norm_eps)
    z, xi, Bm, Cm, dt = _proj(cfg, p, u)
    xi = shard(xi, "batch", "seq", "act_inner")
    if _on_mesh(xi):
        y = _mix_sharded(cfg, p, z, xi, Bm, Cm, dt)
    else:
        y = _mix(cfg, z, xi, Bm, Cm, dt, *_mix_params(p))
    return _out(cfg, p, y)


def _tail(pre_conv_in: torch.Tensor, W: int) -> torch.Tensor:
    """Last W-1 raw (pre-activation) conv inputs, for decode handoff."""
    T = pre_conv_in.shape[1]
    pad = max(W - 1 - T, 0)
    x = F.pad(pre_conv_in, (0, 0, pad, 0))
    return x[:, -(W - 1):]


def mamba_prefill(cfg, p: Dict, x: torch.Tensor):
    """Forward + recurrent state for decode handoff."""
    u = rmsnorm(x, p["norm"], cfg.norm_eps)
    z, xi_raw, Bm_raw, Cm_raw, dt = _proj(cfg, p, u)
    xi_raw = shard(xi_raw, "batch", "seq", "act_inner")
    if _on_mesh(xi_raw):
        y, S, tx, tB, tC = _mix_sharded(cfg, p, z, xi_raw, Bm_raw, Cm_raw,
                                        dt, state=True)
    else:
        y, S, tx, tB, tC = _mix(cfg, z, xi_raw, Bm_raw, Cm_raw, dt,
                                *_mix_params(p), state=True)
    state = {"ssd": S, "conv_x": tx, "conv_B": tB, "conv_C": tC}
    return _out(cfg, p, y), state


def _step(cfg, z, xi, Bm, Cm, dt, conv_x, conv_B, conv_C, A_log, D, ssd,
          cx, cB, cC):
    """One token of the per-head part over the heads it is given: the conv
    steps and the SSD step, the new state and conv tails written into
    ``ssd``, ``cx``, ``cB``, ``cC`` in place; returns the gated (B, di)
    output before the norm."""
    B, di = xi.shape
    P = cfg.ssm_headdim
    H = di // P
    x, nx = _conv_step(xi, conv_x, cx)
    b, nB = _conv_step(Bm, conv_B, cB)
    c, nC = _conv_step(Cm, conv_C, cC)
    A = -torch.exp(A_log.float())
    y, S = ssd_step(ssd, x.reshape(B, H, P), dt, A, b, c)
    for dst, new in ((ssd, S), (cx, nx), (cB, nB), (cC, nC)):
        dst.copy_(new)
    y = y + x.reshape(B, H, P) * D.to(x.dtype)[:, None]
    return y.reshape(B, di) * F.silu(z.float()).to(y.dtype)


def mamba_decode(cfg, p: Dict, x: torch.Tensor, state: Dict):
    """One-token step. x: (B,1,d).  ``state`` (this layer's views of the
    stacked decode state) is updated in place and returned; on a mesh each
    rank writes its own heads' state."""
    u = rmsnorm(x[:, 0], p["norm"], cfg.norm_eps)
    z, xi, Bm, Cm, dt = _proj(cfg, p, u)
    xi = shard(xi, "batch", "act_inner")
    sts = (state["ssd"], state["conv_x"], state["conv_B"], state["conv_C"])
    if _on_mesh(xi):
        ax, b = _heads_axis(cfg), resolve(("batch",))[0]
        inner, rep = P(b, ax), P(b, None)
        sspecs = {"ssd": P(b, ax, None, None), "conv_x": P(b, None, ax),
                  "conv_B": P(b, None, None), "conv_C": P(b, None, None)}
        for name, spec_ in sspecs.items():
            check_placements(state[name], placements(spec_, bound_mesh()),
                             f"state {name!r}")
        y = local_region(
            functools.partial(_step, cfg), inner,
            (inner, inner, rep, rep, inner, P(None, ax), P(None, None),
             P(None, None), P(ax), P(ax), *sspecs.values()))(
            z, xi, Bm, Cm, dt, *_mix_params(p), *sts)
    else:
        y = _step(cfg, z, xi, Bm, Cm, dt, *_mix_params(p), *sts)
    return _out(cfg, p, y[:, None]), state


# ================================================================ SSM LM
def _residual(h: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The residual stream after a block: on a mesh replicated over
    ``model`` (the block's row-parallel output sum reduced), as the dense
    blocks keep it."""
    return shard(h + out, "batch", "seq", None)


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
        return _residual(h, mamba_forward(cfg, pl, h)), None, 0.0

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
        return _residual(h, out), st, 0.0

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
        return _residual(h, out), st

    x, states = run_stack_decode(cfg, params["mamba"], states, x, dec,
                                 cfg.n_layers)
    return ssm_logits(cfg, params, x), states


def ssm_lm_cache_specs(cfg, batch: int) -> Dict:
    per = ssm_state_specs(cfg, batch)
    return tree_map(
        lambda s: spec((cfg.n_layers,) + s.shape, ("layers",) + s.axes,
                       dtype=s.dtype, init="zeros"), per)
