"""StarCoder2-15B [arXiv:2402.19173; hf:bigcode/starcoder2-15b].

Dense decoder LM: 40L, d_model 6144, 48 query heads with GQA (4 KV heads),
d_ff 24576, vocab 49152, RoPE.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=100_000.0,
    mlp_gated=False,
)
