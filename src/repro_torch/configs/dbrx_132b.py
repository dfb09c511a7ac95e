"""dbrx-132b: 40L d=6144 48H (GQA kv=8) d_ff=10752 vocab=100352.

MoE: 16 experts, top-4 (fine-grained). [hf:databricks/dbrx-base]
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab=100352,
    act="silu",
    n_experts=16,
    top_k=4,
    notes="full attention -> long_500k SKIPPED",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=48, vocab=256, n_experts=4, top_k=2,
    )
