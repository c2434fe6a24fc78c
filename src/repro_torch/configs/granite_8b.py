"""IBM Granite-8B-Code [arXiv:2405.04324; hf:ibm-granite/granite-8b-code-base].

Llama-architecture dense LM: 36L, d_model 4096, 32H GQA (8 KV), d_ff 14336,
vocab 49152, SwiGLU + RMSNorm + RoPE.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    rope_theta=10_000_000.0,
    tie_embeddings=True,
)
