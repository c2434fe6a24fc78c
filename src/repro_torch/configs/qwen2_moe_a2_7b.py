"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L, d_model 2048, 16H (MHA: kv=16), per-expert d_ff 1408, vocab 151936,
60 routed experts top-4 + 4 shared experts (shared width 5632).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    n_experts=60,
    top_k=4,
    # 4 shared experts of width 1408 (= 5632 fused); the implementation fuses
    # them into one SwiGLU GEMM
    n_shared_experts=4,
    shared_expert_d_ff=1408,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
