"""Crash-consistent checkpoints in the reference's file format."""
from repro_torch.checkpoint.ckpt import (  # noqa: F401
    latest_step, restore_checkpoint, restore_resharded, save_checkpoint,
)
