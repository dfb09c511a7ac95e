"""mamba2-370m: 48L d=1024 (attention-free) vocab=50280, ssm_state=128.

SSD (state-space duality). [arXiv:2405.21060]
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_heads=32,  # d_inner 2048 / head_dim 64
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    notes="attention-free: paper's KV-streaming inapplicable (DESIGN.md §4); "
    "long_500k RUNS (O(1) decode state)",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab=256, ssm_state=16, ssm_heads=8,
        ssm_head_dim=16, ssm_chunk=16,
    )
