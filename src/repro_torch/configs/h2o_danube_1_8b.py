"""H2O-Danube-1.8B [arXiv:2401.16818; hf:h2oai/h2o-danube-1.8b-base].

Llama+Mistral mix with sliding-window attention: 24L, d_model 2560, 32H GQA
(8 KV), d_ff 6912, vocab 32000, window 4096.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=10_000.0,
)
