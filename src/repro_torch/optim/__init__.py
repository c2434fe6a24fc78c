"""AdamW with a cosine schedule and global-norm clipping, the int8
gradient codec and its all-reduce over a process group
(``repro.optim``'s counterpart)."""
from repro_torch.optim.adamw import (  # noqa: F401
    OptConfig, clip_by_global_norm, cosine_lr, global_norm, opt_init,
    opt_update,
)
from repro_torch.optim.compression import (  # noqa: F401
    compressed_allreduce, int8_compress, int8_decompress,
)
