"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) vocab=49155.

MoE 40 experts top-8, expert d_ff=512.  The assignment note also says
"32 experts"; we follow the primary spec line (40e top-8) — DESIGN.md §4.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,              # unused (no dense layers), kept for spec fidelity
    vocab_size=49155,
    n_experts=40,
    n_shared_experts=0,
    moe_top_k=8,
    moe_d_ff=512,
    first_dense_layers=0,
    rope_theta=10_000.0,
    tie_embeddings=True,
)
