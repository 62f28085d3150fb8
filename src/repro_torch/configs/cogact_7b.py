"""CogACT — the paper's second evaluation model (§V, Table III).

ViT encoder + Llama-2-7B backbone + DiT action module (DiT-Base: 12L, 768d)
run for `diffusion_steps` denoising iterations.  This is the heterogeneous
S_dec structure that breaks load-budget-only segmentation (paper Fig. 2).
[arXiv:2411.19650]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="cogact-7b",
    family="vla",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32064,
    rope_theta=10_000.0,
    vla_action_head="dit",
    vit_layers=24,
    vit_dim=1024,
    n_patches=256,
    action_dim=7,
    action_horizon=16,
    diffusion_steps=10,
    dit_layers=12,
    dit_dim=768,
    dit_heads=12,
)
