"""Configuration dataclasses — the PyTorch port's own copy.

Field for field the dataclass of ``src/repro/configs/base.py`` (a test
holds the two equal), kept here so that the port imports nothing of the
JAX package.  The same config object drives parameter-spec construction
(``models.model.build``) and the reduced variants the CPU tests run
(:meth:`ModelConfig.reduced`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    # -- identity ----------------------------------------------------------
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | audio | vlm | hybrid | vla

    # -- core transformer dims --------------------------------------------
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0          # 0 -> d_model // n_heads

    # -- attention ---------------------------------------------------------
    rope_theta: float = 500_000.0
    parallel_block: bool = False      # command-r style parallel attn+ffn
    qkv_bias: bool = False
    causal: bool = True

    # -- MLA (deepseek) ------------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # -- MoE -----------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    first_dense_layers: int = 0     # deepseek: first k layers use dense FFN

    # -- SSM (mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # -- hybrid (zamba2) -------------------------------------------------------
    shared_attn_every: int = 0      # shared transformer block every k ssm blocks

    # -- encoder-decoder (seamless) --------------------------------------------
    is_encdec: bool = False
    n_enc_layers: int = 0
    n_dec_layers: int = 0

    # -- VLM (llama-3.2-vision) --------------------------------------------------
    cross_attn_every: int = 0       # every k-th layer gets a gated cross-attn sublayer
    n_vision_tokens: int = 0

    # -- VLA (paper models) -------------------------------------------------------
    vla_action_head: str = ""       # detok | mlp | lstm | diffusion | dit
    vit_layers: int = 0
    vit_dim: int = 0
    n_patches: int = 0
    action_dim: int = 7
    action_horizon: int = 16
    diffusion_steps: int = 10
    dit_layers: int = 0
    dit_dim: int = 0
    dit_heads: int = 0

    # -- numerics / implementation ---------------------------------------------
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    scan_layers: bool = True        # False -> unrolled (exact HLO costs; dry-run)
    remat: bool = True
    attn_impl: str = "xla"          # kept for parity; the port routes causal
    #                                 prefill attention to its own kernel
    tie_embeddings: bool = False
    # -- distribution variants (§Perf hillclimbing) -----------------------------
    decode_attn: str = "tp"         # tp | sp (shard_map flash-decode over seq)
    tp_collective: str = "ar"       # ar | int8_ring (inference projections)

    # ------------------------------------------------------------------ helpers
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // max(self.ssm_headdim, 1)

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can decode a 500k context (SSM/hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # no encoder-only archs in the assigned pool

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------- param count
    def n_params(self) -> int:
        """Analytic parameter count (used for 6ND MODEL_FLOPS and paper tables)."""
        d, hd = self.d_model, self.resolved_head_dim
        nl = self.n_layers

        def attn_params() -> int:
            if self.use_mla:
                q = d * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                kv_a = d * (self.kv_lora_rank + self.qk_rope_dim)
                kv_b = self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                o = self.n_heads * self.v_head_dim * d
                return q + kv_a + kv_b + o
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            return q + kv + o

        def mlp_params(ff: int) -> int:
            return 3 * d * ff  # SwiGLU: gate, up, down

        total = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d  # head

        if self.family in ("dense", "vlm"):
            total += nl * (attn_params() + mlp_params(self.d_ff) + 2 * d)
            if self.family == "vlm" and self.cross_attn_every:
                n_x = nl // self.cross_attn_every
                total += n_x * (attn_params() + 2 * d)
        elif self.family == "moe":
            n_moe = nl - self.first_dense_layers
            moe = self.n_experts * mlp_params(self.moe_d_ff) + d * self.n_experts
            moe += self.n_shared_experts * mlp_params(self.moe_d_ff)
            total += nl * (attn_params() + 2 * d)
            total += self.first_dense_layers * mlp_params(self.d_ff) + n_moe * moe
        elif self.family == "ssm":
            total += nl * (self._mamba_params() + d)
        elif self.family == "hybrid":
            total += nl * (self._mamba_params() + d)
            total += attn_params() + mlp_params(self.d_ff) + 2 * d  # one shared block
        elif self.family == "audio":
            enc = self.n_enc_layers * (attn_params() + mlp_params(self.d_ff) + 2 * d)
            dec = self.n_dec_layers * (2 * attn_params() + mlp_params(self.d_ff) + 3 * d)
            total += enc + dec
        elif self.family == "vla":
            total += self.vit_layers * (4 * self.vit_dim ** 2 + 8 * self.vit_dim ** 2) \
                + self.vit_dim * d
            total += nl * (attn_params() + mlp_params(self.d_ff) + 2 * d)
            total += self._action_head_params()
        return total

    def _mamba_params(self) -> int:
        d, di, ns = self.d_model, self.d_inner, self.ssm_state
        nh = self.ssm_nheads
        # B/C are per-group (n_groups=1), width ssm_state each
        in_proj = d * (2 * di + 2 * ns + nh)        # x, z, B, C, dt
        conv = self.ssm_conv * (di + 2 * ns)
        out = di * d
        return in_proj + conv + out + 2 * nh + di   # A, D, norm

    def _action_head_params(self) -> int:
        d, a = self.d_model, self.action_dim
        h = self.action_horizon
        if self.vla_action_head in ("detok", ""):
            return 0
        if self.vla_action_head == "mlp":
            return d * 4 * d + 4 * d * d + d * a * h
        if self.vla_action_head == "lstm":
            return 8 * d * d + d * a
        if self.vla_action_head == "diffusion":
            return 3 * (d * d) + d * a + a * d
        if self.vla_action_head == "dit":
            dd = self.dit_dim
            per = 4 * dd * dd + 8 * dd * dd + 6 * dd * dd  # attn+mlp+adaLN
            return self.dit_layers * per + d * dd + dd * a
        return 0

    # ------------------------------------------------------------------ reduced
    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            scan_layers=True,
            remat=False,
        )
        if self.use_mla:
            kw.update(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
        if self.n_experts:
            kw.update(n_experts=4, moe_top_k=2, moe_d_ff=64,
                      n_shared_experts=min(self.n_shared_experts, 1),
                      first_dense_layers=min(self.first_dense_layers, 1))
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=32, d_model=64)
        if self.shared_attn_every:
            kw.update(shared_attn_every=2, n_layers=4)
        if self.is_encdec:
            kw.update(n_enc_layers=2, n_dec_layers=2)
        if self.cross_attn_every:
            kw.update(cross_attn_every=2, n_vision_tokens=8, n_layers=4)
        if self.family == "vla":
            kw.update(vit_layers=2, vit_dim=32, n_patches=16,
                      dit_layers=2, dit_dim=32, dit_heads=2,
                      diffusion_steps=2, action_horizon=4)
        return self.replace(**kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the assignment grid."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long_decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "long_decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; have {[s.name for s in SHAPES]}")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason). long_500k only for sub-quadratic archs (DESIGN.md §4)."""
    if shape.kind == "long_decode" and not cfg.sub_quadratic:
        return False, ("skip: full-attention arch cannot decode 524288 ctx "
                       "(quadratic); see DESIGN.md §4")
    return True, ""
