"""SeamlessM4T-large v2 text backbone [arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large].

Encoder-decoder transformer backbone: 24 encoder + 24 decoder layers,
d_model 1024, 16H (MHA), d_ff 8192, vocab 256206.  The audio frontend
(w2v-BERT conformer) is a stub: the encoder takes precomputed frame
embeddings at d_model.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,               # decoder layers
    n_encoder_layers=24,
    encoder_seq_ratio=2,       # stub: 2 audio frames per target token
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    mlp_gated=False,
    vocab_size=256206,
)
