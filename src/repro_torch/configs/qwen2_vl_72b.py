"""qwen2-vl-72b: 80L d=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.

M-RoPE (t/h/w sections 16/24/24 pairs), dynamic-resolution vision frontend
STUBBED — input_specs() provides patch embeddings. [arXiv:2409.12191]
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    act="silu",
    m_rope_sections=(16, 24, 24),
    notes="vision frontend stubbed; full attention -> long_500k SKIPPED",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, m_rope_sections=(2, 3, 3),
    )
