"""h2o-danube-1.8b: 24L d=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.

llama+mistral mix with sliding-window attention. [arXiv:2401.16818]
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab=32000,
    act="silu",
    sliding_window=4096,
    notes="SWA on all layers -> long_500k RUNS with a bounded window cache",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, sliding_window=8,
    )
