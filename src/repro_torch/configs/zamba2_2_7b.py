"""zamba2-2.7b: 54L d=2560 (mamba2) + ONE shared 32H attention+MLP block
applied every 6 layers, d_ff=10240, vocab=32000, ssm_state=64.

Zamba2's signature trick: the attention/MLP block is parameter-SHARED
across all of its applications. [arXiv:2411.15242]
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab=32000,
    act="silu",
    ssm_state=64,
    ssm_heads=80,  # d_inner 5120 / head_dim 64
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    attn_every=6,
    notes="hybrid: SSM state resident + shared-attn KV streamed -> "
    "long_500k RUNS",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, ssm_state=16, ssm_heads=8, ssm_head_dim=16,
        ssm_chunk=16, attn_every=2,
    )
