"""Checkpoints in the reference's on-disk format.  Port of
``src/repro/ckpt``."""

from repro_torch.ckpt.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CheckpointManager", "save_checkpoint", "restore_checkpoint",
    "latest_step",
]
