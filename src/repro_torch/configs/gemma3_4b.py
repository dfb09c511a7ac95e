"""gemma3-4b: 34L d=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

5:1 local:global attention (window 1024 on local layers), GeGLU, head_dim
256, qk-norm, gemma-style sqrt(d) embedding scale.
[hf:google/gemma-3-4b-pt lineage; assignment block]
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262144,
    act="gelu",
    sliding_window=1024,
    local_global_pattern=5,
    rope_theta=1_000_000.0,
    qk_norm=True,
    embed_scale=True,
    notes="5:1 local:global SWA; long_500k RUNS (local layers bound the "
    "cache; global layers use SP-sharded full cache)",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=256,
        sliding_window=8,
        local_global_pattern=1,
    )
