"""Llama-3.2-Vision-90B backbone [hf:meta-llama/Llama-3.2-90B-Vision].

100 total layers (80 self-attention + 20 image cross-attention, every 5th),
d_model 8192, 64H GQA (8 KV), d_ff 28672, vocab 128256.  The vision tower is
a stub: the model takes precomputed patch/tile embeddings already projected
to d_model (4 tiles x 1601 patches) as its cross-attention memory.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    vision_tokens=6404,       # 4 tiles x 1601 patches
    rope_theta=500_000.0,
)
