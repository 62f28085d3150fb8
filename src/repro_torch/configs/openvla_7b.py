"""OpenVLA-7B — the paper's main evaluation model (§V).

ViT encoder + Llama-2-7B backbone + action de-tokenizer (no generative
action model).  OpenVLA generates 7-DoF actions token-by-token through the
LM head; the paper's Fig. 3 cut tensor [1, 17, 3072]... (OpenVLA's prompt
yields short action sequences).  ViT is a real ViT here (prismatic-style
patch encoder); dry-run input specs stub the image as patch embeddings.
[arXiv:2406.09246]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="openvla-7b",
    family="vla",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32064,
    rope_theta=10_000.0,
    vla_action_head="detok",
    vit_layers=24,
    vit_dim=1024,
    n_patches=256,
    action_dim=7,
    action_horizon=1,
)
