"""command-r-35b: 40L d=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.

GQA, no biases, SwiGLU. [hf:CohereForAI/c4ai-command-r-v01; assignment]
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab=256000,
    act="silu",
    rope_theta=8_000_000.0,
    notes="pure full attention -> long_500k SKIPPED (DESIGN.md §4)",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
    )
