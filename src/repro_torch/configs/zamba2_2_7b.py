"""Zamba2-2.7B [arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B].

Hybrid: 54 Mamba2 (SSD) layers, d_model 2560, ssm_state 64, with one *shared*
attention+MLP block (32 heads, d_ff 10240) invoked every 6 Mamba layers
(9 invocations sharing one set of weights).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_chunk=256,
    shared_attn_every=6,
    tie_embeddings=True,
)
