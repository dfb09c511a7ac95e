"""qwen3-moe-235b-a22b: 94L d=4096 64H (GQA kv=4) vocab=151936.

MoE: 128 experts, top-8, expert d_ff=1536, qk-norm.
[hf:Qwen/Qwen3-235B-A22B lineage; assignment block]
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab=151936,
    act="silu",
    qk_norm=True,
    n_experts=128,
    top_k=8,
    notes="expert streaming = SEM analogue; full attention -> long_500k "
    "SKIPPED",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab=256, n_experts=8, top_k=2,
    )
