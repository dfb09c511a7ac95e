"""Atomic, streaming and delta checkpoints (torch port of
``repro.checkpoint``; the same on-disk format)."""
from .store import (
    CheckpointCorruptionError,
    CheckpointManager,
    latest_step,
    load_extra,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CheckpointCorruptionError",
    "CheckpointManager",
    "latest_step",
    "load_extra",
    "restore_checkpoint",
    "save_checkpoint",
]
