"""xLSTM-125M [arXiv:2405.04517].

12 blocks, d_model 768, 4 heads, vocab 50304 (GPT-NeoX tokenizer, padded).
xLSTM[7:1]-style mix: every 4th block is an sLSTM block, the rest are mLSTM
(matrix-memory, chunked-parallel).  d_ff=0: blocks carry their own
up/down projections (proj_factor 2).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=0,
    d_ff=0,
    vocab_size=50304,
    ssm_state=0,          # mLSTM memory is (head_dim x head_dim); no extra state dim
    ssm_expand=2,
    ssm_chunk=256,
    slstm_every=4,
    tie_embeddings=True,
)
