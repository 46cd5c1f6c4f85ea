"""Checkpoints in the reference's format (the port of
``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer, latest_step, restore_checkpoint, save_checkpoint,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer"]
