"""seamless-m4t-large-v2 [audio] — 24L d_model=1024 16H d_ff=8192 vocab=256206.

Encoder-decoder, multimodal.  "24L" is read as 24 encoder + 24 decoder layers
(the HF checkpoint's speech-encoder / text-decoder depths) — DESIGN.md §4.
The audio frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, S, d_model).
[arXiv:2308.11596; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=48,            # total, for bookkeeping
    n_enc_layers=24,
    n_dec_layers=24,
    is_encdec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    causal=True,
    rope_theta=10_000.0,
)
