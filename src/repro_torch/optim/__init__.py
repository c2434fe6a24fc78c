"""AdamW with a cosine schedule and global-norm clipping, and the int8
gradient codec (``repro.optim``'s counterpart; ``compressed_allreduce``
needs a mesh and waits in ROADMAP.md, Queue 1 item 14)."""
from repro_torch.optim.adamw import (  # noqa: F401
    OptConfig, clip_by_global_norm, cosine_lr, global_norm, opt_init,
    opt_update,
)
from repro_torch.optim.compression import (  # noqa: F401
    int8_compress, int8_decompress,
)
