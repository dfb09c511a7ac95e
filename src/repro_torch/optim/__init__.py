"""Optimizer substrate: AdamW + schedules + gradient compression (torch
port of ``repro.optim``)."""
from .adamw import OptState, adamw_init, adamw_update, global_norm, lr_at
from .compress import compress, compressed_psum, decompress, init_error

__all__ = [
    "OptState",
    "adamw_init",
    "adamw_update",
    "compress",
    "compressed_psum",
    "decompress",
    "global_norm",
    "init_error",
    "lr_at",
]
