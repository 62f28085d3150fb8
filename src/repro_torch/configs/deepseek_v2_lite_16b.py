"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff(expert)=1408 vocab=102400.

MLA kv_lora=512, 64 routed experts top-6 + 2 shared, first layer dense.
The assignment line lists both "64e top-6" and "160 routed"; we follow the
primary spec (64 routed, top-6) — see DESIGN.md §4.
[arXiv:2405.04434; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,            # dense FFN width (first layer)
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    rope_theta=10_000.0,
)
