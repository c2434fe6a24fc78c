"""DBRX-132B [hf:databricks/dbrx-base] (fine-grained MoE).

40L, d_model 6144, 48H GQA (8 KV), per-expert d_ff 10752, vocab 100352,
16 experts with top-4 routing.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    top_k=4,
    rope_theta=500_000.0,
)
