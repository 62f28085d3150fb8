"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.

Cross-attn image layers: every 5th layer carries a gated cross-attention
sublayer over precomputed vision-patch embeddings (frontend STUB per the
assignment; input_specs() provides (B, n_vision_tokens, d_model)).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_every=5,
    n_vision_tokens=1600,
    rope_theta=500_000.0,
)
