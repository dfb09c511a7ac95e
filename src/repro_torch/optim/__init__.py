"""Optimizer substrate: AdamW + schedules + gradient compression (torch
port of ``repro.optim``; the wire collective ``compressed_psum`` waits for
the multi-card slice, ROADMAP §A A15.4)."""
from .adamw import OptState, adamw_init, adamw_update, global_norm, lr_at
from .compress import compress, decompress, init_error

__all__ = [
    "OptState",
    "adamw_init",
    "adamw_update",
    "compress",
    "decompress",
    "global_norm",
    "init_error",
    "lr_at",
]
