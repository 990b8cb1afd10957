"""Checkpoints in the reference's npz + msgpack layout (``checkpoint.io``)."""
from repro_torch.checkpoint.io import (
    latest_step,
    peek_metadata,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["latest_step", "peek_metadata", "restore_checkpoint", "save_checkpoint"]
