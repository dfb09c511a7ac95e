"""whisper-base: 6L enc + 6L dec, d=512 8H d_ff=2048 vocab=51865.

Encoder-decoder; conv audio frontend is a STUB — input_specs() provides
precomputed frame embeddings [B, S, d]. Plain (non-gated) GELU MLP, learned
positions. [arXiv:2212.04356]
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab=51865,
    act="gelu",
    gated_mlp=False,
    pos="learned",
    max_pos=32768,
    encoder_layers=6,
    notes="enc-dec; full attention -> long_500k SKIPPED; decode shapes run "
    "(self-cache + cross K/V)",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, encoder_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=256, max_pos=128,
    )
