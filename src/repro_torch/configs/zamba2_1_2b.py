"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=32000.

Mamba2 backbone (ssm_state=64) + ONE shared attention+MLP transformer block
invoked every 6 SSM blocks (weights shared across invocations).
Simplification vs HF checkpoint noted in DESIGN.md §4 (no [h, embed] concat /
per-invocation LoRA).
[arXiv:2411.15242; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=256,
    shared_attn_every=6,
    rope_theta=10_000.0,
    tie_embeddings=True,
)
