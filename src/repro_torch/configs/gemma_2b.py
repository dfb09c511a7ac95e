"""gemma-2b: 18L d=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.

GeGLU, head_dim=256, MQA. [arXiv:2403.08295]
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    act="gelu",
    embed_scale=True,
    notes="MQA (kv=1): maximal KV reuse; long_500k SKIPPED (full attention)",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=256,
    )
