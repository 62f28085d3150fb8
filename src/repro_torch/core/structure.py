"""Structure modeling of VLA/LM models — paper Eq. 1.

The port's own copy of ``src/repro/core/structure.py``: the same code,
importing from ``repro_torch`` only, held equal to the reference by
``tests/test_torch_control.py``.

The paper divides a VLA into ``[S_enc, S_bac, S_dec]`` with
``S_enc ∈ {ViT}``, ``S_bac ∈ {LLM}``,
``S_dec ∈ {De-tokenizer, MLP, LSTM, Diffusion, DiT}`` and looks up per-layer
``(C_compute, C_datamove)``.  We implement that mapping *analytically* from
the ModelConfig (equivalent information to the paper's measured lookup
table; DESIGN.md §8), producing a **flattened layer graph** shared by

* Alg. 1 segmentation (core/segmentation.py),
* the parameter-sharing pool (core/pool.py),
* the paper-table benchmarks (benchmarks/),
* napkin math in §Perf.

Key heterogeneity captured: action-model layers with ``repeat > 1``
(diffusion/DiT denoise loops) multiply both compute *and* the transfer
volume if the cut lands inside them — this is exactly why CogACT's optimal
split avoids the DiT region (paper Fig. 2).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class LayerCost:
    name: str
    kind: str                 # vit | llm | moe | mamba | cross | dit | head | ...
    flops: float              # per request (includes `repeat`)
    weight_bytes: float
    datamove_bytes: float     # HBM traffic per request (weights + activations)
    out_transfer_bytes: float # wire bytes if the model is cut AFTER this layer
    repeat: int = 1
    # wire bytes a segment STARTING at this layer actually needs when the
    # producing segment ships only what the consumer reads (a cloud→edge
    # downlink cut in a multi-cut placement, core/placement.py).  ``None``
    # means "the full upstream activation" (the previous layer's
    # out_transfer_bytes).  Action heads consume a small conditioning
    # slice — OpenVLA's de-tokenizer reads the final ``action_dim`` token
    # positions, CogACT's DiT reads the single cognition token — which is
    # what makes the edge→cloud→edge return leg cheap (ActionFlow's
    # action-stage-on-edge pattern).
    in_transfer_bytes: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Workload:
    """One VLA/LM inference request (paper §III setting: batch 1).

    ``decode_steps`` models the autoregressive tail (OpenVLA emits 7 action
    tokens one by one): every decode step re-reads the layer weights (the
    memory-bound regime that makes edge-only so slow) and ships a 1-token
    activation across the cut.  ``input_bytes`` is the raw observation
    (image + prompt) that must be shipped for cloud-only (split=0).
    """
    batch: int = 1
    s_new: int = 17           # tokens whose activations cross the cut
    s_ctx: int = 290          # attention context (image + prompt tokens)
    decode_steps: int = 7     # autoregressive action tokens (detok VLAs)
    act_bytes: int = 2        # bf16 activations on the wire
    wbits: int = 16           # weight bytes for load/traffic (fp16 residency)
    input_bytes: float = 224 * 224 * 3 + 2048   # raw image + prompt

    @property
    def wbytes(self) -> float:
        return self.wbits / 8.0


def _attn_flops(cfg: ModelConfig, S: int, T: int) -> float:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    proj = 2 * S * d * (H + 2 * KV) * hd + 2 * S * H * hd * d
    attn = 2 * S * T * H * hd * 2  # qk + av
    return proj + attn


def _mla_flops(cfg: ModelConfig, S: int, T: int) -> float:
    d, H = cfg.d_model, cfg.n_heads
    r, qn, qr, vd = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    proj = 2 * S * d * H * (qn + qr) + 2 * S * d * (r + qr) \
        + 2 * S * r * H * (qn + vd) + 2 * S * H * vd * d
    attn = 2 * S * T * H * (qn + qr) + 2 * S * T * H * vd
    return proj + attn


def _attn_weight_count(cfg: ModelConfig) -> float:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if cfg.use_mla:
        r, qn, qr, vd = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        return d * cfg.n_heads * (qn + qr) + d * (r + qr) \
            + r * cfg.n_heads * (qn + vd) + cfg.n_heads * vd * d
    return d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d


def _mamba_flops(cfg: ModelConfig, S: int) -> float:
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H, P, W, Q = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_conv, cfg.ssm_chunk
    proj = 2 * S * d * (2 * di + 2 * N + H) + 2 * S * di * d
    conv = 2 * S * (di + 2 * N) * W
    Qe = min(Q, max(S, 1))
    ssd = 2 * S * Qe * (N + H * P) + 4 * S * H * N * P
    return proj + conv + ssd


def _block_cost(cfg: ModelConfig, w: Workload, name: str, kind: str,
                flops_one: float, weight_count: float,
                d_out: Optional[int] = None, repeat: int = 1,
                s_out: Optional[int] = None,
                decode_steps: Optional[int] = None,
                in_transfer_bytes: Optional[float] = None) -> LayerCost:
    """decode_steps: autoregressive invocations of this layer after prefill
    (weights re-read each step; 1-token activation crosses the cut each
    step).  Backbone layers inherit ``w.decode_steps``; ViT/enc/action-model
    layers run once per request (decode_steps=0)."""
    d_out = d_out if d_out is not None else cfg.d_model
    s_out = s_out if s_out is not None else w.s_new
    ds = w.decode_steps if decode_steps is None else decode_steps
    wbytes = weight_count * w.wbytes
    # flops: prefill pass + per-token decode passes (~flops_one / s_new each)
    per_tok = flops_one / max(w.s_new, 1)
    flops = (flops_one + ds * per_tok) * w.batch * repeat
    act_traffic = 2 * w.batch * (s_out + ds) * d_out * w.act_bytes
    reads = 1 + ds
    return LayerCost(
        name=name, kind=kind,
        flops=flops,
        weight_bytes=wbytes,
        datamove_bytes=(wbytes * reads + act_traffic) * repeat,
        out_transfer_bytes=w.batch * (s_out + ds) * d_out * w.act_bytes
        * repeat,
        repeat=repeat,
        in_transfer_bytes=in_transfer_bytes,
    )


def build_graph(cfg: ModelConfig, w: Workload = Workload()) -> List[LayerCost]:
    """Flattened per-request layer graph in execution order."""
    S, T = w.s_new, w.s_ctx
    g: List[LayerCost] = []

    # ---- S_enc: ViT (VLA family) ----------------------------------------
    if cfg.family == "vla" and cfg.vit_layers:
        dv = cfg.vit_dim
        P = cfg.n_patches
        attn = 2 * P * dv * 4 * dv + 2 * P * P * dv * 2
        mlp = 2 * P * 3 * (4 * dv) * dv  # ~GELU MLP ≈ 2*P*2*4dv*dv; use swiglu-equiv
        wcount = 4 * dv * dv + 8 * dv * dv
        for i in range(cfg.vit_layers):
            g.append(_block_cost(cfg, w, f"vit.{i}", "vit", attn + mlp,
                                 wcount, d_out=dv, s_out=P, decode_steps=0))
        g.append(_block_cost(cfg, w, "vit.proj", "vit",
                             2 * P * dv * cfg.d_model, dv * cfg.d_model,
                             s_out=P, decode_steps=0))

    # ---- encoder (audio enc-dec) -----------------------------------------
    if cfg.family == "audio":
        enc_f = _attn_flops(cfg, w.s_ctx, w.s_ctx) \
            + 2 * w.s_ctx * 3 * cfg.d_model * cfg.d_ff
        enc_w = _attn_weight_count(cfg) + 3 * cfg.d_model * cfg.d_ff
        for i in range(cfg.n_enc_layers):
            g.append(_block_cost(cfg, w, f"enc.{i}", "enc", enc_f, enc_w,
                                 s_out=w.s_ctx, decode_steps=0))

    # ---- embedding -------------------------------------------------------
    if cfg.family != "vla":
        g.append(_block_cost(cfg, w, "embed", "embed", 0.0,
                             cfg.vocab_size * cfg.d_model, decode_steps=0))

    # ---- S_bac / backbone blocks ----------------------------------------
    d = cfg.d_model
    if cfg.family in ("dense", "vlm", "vla", "audio"):
        attn_f = _attn_flops(cfg, S, T)
        mlp_f = 2 * S * 3 * d * cfg.d_ff
        wcount = _attn_weight_count(cfg) + 3 * d * cfg.d_ff
        n = cfg.n_dec_layers if cfg.family == "audio" else cfg.n_layers
        for i in range(n):
            extra_f, extra_w = 0.0, 0.0
            if (cfg.family == "vlm" and cfg.cross_attn_every
                    and (i + 1) % cfg.cross_attn_every == 0):
                extra_f = _attn_flops(cfg, S, cfg.n_vision_tokens)
                extra_w = _attn_weight_count(cfg) + 3 * d * cfg.d_ff
            if cfg.family == "audio":
                extra_f = _attn_flops(cfg, S, T)   # cross-attn to encoder
                extra_w = _attn_weight_count(cfg)
            g.append(_block_cost(cfg, w, f"llm.{i}", "llm",
                                 attn_f + mlp_f + extra_f,
                                 wcount + extra_w))
    elif cfg.family == "moe":
        attn_f = _mla_flops(cfg, S, T) if cfg.use_mla else _attn_flops(cfg, S, T)
        for i in range(cfg.n_layers):
            if i < cfg.first_dense_layers:
                ffn_f = 2 * S * 3 * d * cfg.d_ff
                ffn_w = 3 * d * cfg.d_ff
                kind = "llm"
            else:
                k, fe = cfg.moe_top_k, cfg.moe_d_ff
                ffn_f = 2 * S * d * cfg.n_experts \
                    + 2 * S * (k + cfg.n_shared_experts) * 3 * d * fe
                ffn_w = cfg.n_experts * 3 * d * fe + d * cfg.n_experts \
                    + cfg.n_shared_experts * 3 * d * fe
                kind = "moe"
            g.append(_block_cost(cfg, w, f"llm.{i}", kind,
                                 attn_f + ffn_f,
                                 _attn_weight_count(cfg) + ffn_w))
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            g.append(_block_cost(cfg, w, f"ssm.{i}", "mamba",
                                 _mamba_flops(cfg, S),
                                 cfg._mamba_params()))
    elif cfg.family == "hybrid":
        shared_f = _attn_flops(cfg, S, T) + 2 * S * 3 * d * cfg.d_ff
        shared_w = _attn_weight_count(cfg) + 3 * d * cfg.d_ff
        for i in range(cfg.n_layers):
            if cfg.shared_attn_every and i % cfg.shared_attn_every == 0:
                # shared block weights live on BOTH tiers by construction;
                # weight_bytes counted once at the first site
                g.append(_block_cost(cfg, w, f"shared.{i}", "llm", shared_f,
                                     shared_w if i == 0 else 0.0))
            g.append(_block_cost(cfg, w, f"ssm.{i}", "mamba",
                                 _mamba_flops(cfg, S),
                                 cfg._mamba_params()))

    # ---- S_dec: action model / head --------------------------------------
    if cfg.family == "vla":
        kind = cfg.vla_action_head
        # the action stage consumes a small conditioning slice of the final
        # backbone activation (detok: the last action_dim token positions;
        # DiT/MLP/LSTM/diffusion: the single cognition token) — the
        # downlink bytes of an edge→cloud→edge placement's second cut
        detok_in = w.batch * cfg.action_dim * d * w.act_bytes
        cog_in = w.batch * 1 * d * w.act_bytes
        if kind in ("detok", ""):
            g.append(_block_cost(cfg, w, "detok", "head",
                                 2 * cfg.action_dim * d * cfg.vocab_size,
                                 cfg.vocab_size * d,
                                 d_out=cfg.action_dim, s_out=1,
                                 decode_steps=0, in_transfer_bytes=detok_in))
        elif kind == "dit":
            dd, hor = cfg.dit_dim, cfg.action_horizon
            reps = cfg.diffusion_steps
            attn = 2 * hor * dd * 4 * dd + 2 * hor * hor * dd * 2
            mlp = 2 * hor * 2 * (4 * dd) * dd
            ada = 2 * hor * 6 * dd * dd
            wcount = 4 * dd * dd + 8 * dd * dd + 6 * dd * dd
            for i in range(cfg.dit_layers):
                g.append(_block_cost(cfg, w, f"dit.{i}", "dit",
                                     (attn + mlp + ada), wcount,
                                     d_out=dd, s_out=hor, repeat=reps,
                                     decode_steps=0,
                                     in_transfer_bytes=cog_in
                                     if i == 0 else None))
        elif kind == "mlp":
            g.append(_block_cost(cfg, w, "am.mlp", "am",
                                 2 * (4 * d * d + 4 * d * d), 8 * d * d,
                                 d_out=cfg.action_dim,
                                 s_out=cfg.action_horizon, decode_steps=0,
                                 in_transfer_bytes=cog_in))
        elif kind == "lstm":
            g.append(_block_cost(cfg, w, "am.lstm", "am",
                                 cfg.action_horizon * 2 * 8 * d * d,
                                 8 * d * d, d_out=cfg.action_dim,
                                 s_out=cfg.action_horizon,
                                 repeat=cfg.action_horizon, decode_steps=0,
                                 in_transfer_bytes=cog_in))
        elif kind == "diffusion":
            g.append(_block_cost(cfg, w, "am.diff", "am",
                                 2 * 3 * d * d, 3 * d * d,
                                 d_out=cfg.action_dim,
                                 s_out=cfg.action_horizon,
                                 repeat=cfg.diffusion_steps, decode_steps=0,
                                 in_transfer_bytes=cog_in))
    else:
        g.append(_block_cost(cfg, w, "head", "head",
                             2 * S * d * cfg.vocab_size,
                             0.0 if cfg.tie_embeddings
                             else cfg.vocab_size * d,
                             d_out=cfg.vocab_size))
    return g


def total_weight_bytes(graph: List[LayerCost]) -> float:
    return sum(c.weight_bytes for c in graph)


def total_flops(graph: List[LayerCost]) -> float:
    return sum(c.flops for c in graph)
