"""Work counts of the VLA request and its kernels, from the configuration's
widths, and the card's data-sheet peaks.

Every count follows the operation's shapes, never the kernel that
implements it: a matrix product ``(m, k) @ (k, n)`` is ``2 m k n``
operations; causal attention over ``S`` positions scores ``S (S + 1) / 2``
pairs; each input byte is read once and each output byte written once.
"""
from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet: dense bfloat16 tensor-core rate and HBM3
# bandwidth, both at the full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
CODEC_BLOCK = 128           # columns that share one float32 scale


def least_seconds(flops: float, nbytes: float) -> Tuple[float, str]:
    """The least time the card could take, and which bound sets it."""
    t_flops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES_PER_S
    return (t_flops, "flops") if t_flops >= t_bytes else (t_bytes, "bytes")


def _head_dim(c: Dict) -> int:
    return c["head_dim"] or c["d_model"] // c["n_heads"]


def vit_flops(c: Dict) -> float:
    """The ViT over ``n_patches`` patch rows: per block q, k, v, o, the
    SwiGLU MLP at 4x width and non-causal attention; then the projection
    to the LLM width."""
    P, dv = c["n_patches"], c["vit_dim"]
    per_block = 2 * P * (4 * dv * dv + 3 * dv * 4 * dv) + 2 * 2 * P * P * dv
    return c["vit_layers"] * per_block + 2 * P * dv * c["d_model"]


def llm_block_flops(c: Dict, S: int) -> float:
    """One LLM block over ``S`` positions: q, k, v, o, the SwiGLU MLP and
    causal attention."""
    d, H, KV, hd = c["d_model"], c["n_heads"], c["n_kv_heads"], _head_dim(c)
    linear = d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * c["d_ff"]
    return 2 * S * linear + causal_attention(1, S, H, KV, hd)[0]


def dit_flops(c: Dict) -> float:
    """The DiT action head of one request: ``diffusion_steps`` denoising
    passes over the ``action_horizon`` action tokens."""
    h, a, dd, d = (c["action_horizon"], c["action_dim"], c["dit_dim"],
                   c["d_model"])
    block = (2 * dd * 6 * dd                # adaLN modulation of the condition
             + 4 * 2 * h * dd * dd          # q, k, v, o
             + 2 * 2 * h * h * dd           # non-causal attention
             + 2 * 2 * h * dd * 4 * dd)     # GELU MLP at 4x width
    step = (2 * h * a * dd + 2 * d * dd + 2 * 64 * dd
            + c["dit_layers"] * block + 2 * dd * 2 * dd + 2 * h * dd * a)
    return c["diffusion_steps"] * step


def head_flops(c: Dict) -> float:
    kind = c["vla_action_head"]
    if kind == "detok":        # the LM head over the last action_dim rows
        return 2 * c["action_dim"] * c["d_model"] * c["vocab_size"]
    if kind == "dit":
        return dit_flops(c)
    raise ValueError(f"no work count for the action head {kind!r}")


def action_flops(c: Dict, prompt_tokens: int) -> float:
    """Model operations of one action request: ViT, LLM blocks over the
    image rows and the prompt, and the action head."""
    S = c["n_patches"] + prompt_tokens
    return (vit_flops(c) + c["n_layers"] * llm_block_flops(c, S)
            + head_flops(c))


def causal_attention(B: int, S: int, H: int, KV: int, D: int,
                     elem_bytes: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of causal self attention: q k^T and p v over the
    ``S (S + 1) / 2`` causal pairs of each of ``B * H`` heads; q and o at
    ``H`` heads, k and v at ``KV``, each moved once."""
    flops = 2 * 2 * B * H * D * S * (S + 1) / 2
    nbytes = B * S * (2 * H + 2 * KV) * D * elem_bytes
    return flops, nbytes


def codec_bytes(B: int, S: int, D: int, codec: str, elem_bytes: int = 2
                ) -> float:
    """Bytes of one quantize and one dequantize of a ``(B, S, D)``
    activation: the activation read and written back, the codes written
    and read, the float32 scales (one per 128 columns) written and read.
    Their few operations an element are far below the bytes' time."""
    n = B * S * D
    code = {"int8": n, "int4": n // 2}[codec]
    scales = n // CODEC_BLOCK * 4
    return 2 * (n * elem_bytes + code + scales)
