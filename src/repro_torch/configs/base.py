"""Model / shape / run configuration dataclasses.

Every assigned architecture gets one module in this package defining
``CONFIG`` (the exact published configuration) and ``smoke()`` (a reduced
same-family configuration for CPU tests).  ``repro_torch.configs.registry`` maps
``--arch <id>`` to these.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "TrainConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "silu"  # silu -> SwiGLU, gelu -> GeGLU
    # --- attention layout ---
    sliding_window: int = 0  # 0 = full attention on every layer
    local_global_pattern: int = 0  # N -> N local : 1 global (gemma3); 0 = off
    rope_theta: float = 10000.0
    m_rope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (pairs per section)
    qk_norm: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv: int = 4
    # --- hybrid (zamba2): one shared attention block every k SSM blocks ---
    attn_every: int = 0
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    # --- misc ---
    tie_embeddings: bool = True
    gated_mlp: bool = True  # False -> plain 2-layer MLP (whisper)
    pos: str = "rope"  # rope | learned (whisper) 
    max_pos: int = 0  # learned-position table size (0 = unused)
    embed_scale: bool = False  # gemma-style sqrt(d) embedding scaling
    dtype: str = "bfloat16"
    notes: str = ""

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 so the unembedding shards
        cleanly over a 16-way tensor-parallel axis (production practice —
        whisper's 51865 and mamba2's 50280 do not divide 16)."""
        return -(-self.vocab // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for 6ND math."""
        d, v = self.d_model, self.vocab
        total = v * d  # embedding (tied head)
        if not self.tie_embeddings:
            total += v * d

        def attn_params() -> int:
            return d * self.n_heads * self.head_dim * 2 + (
                d * self.n_kv_heads * self.head_dim * 2
            )

        def mlp_params(ff: int) -> int:
            return (3 if self.gated_mlp else 2) * d * ff

        def ssm_params() -> int:
            di = self.d_inner
            # in_proj (x, z, B, C, dt) + out_proj + conv + A/D/dt_bias
            nh = self.ssm_heads
            return (
                d * (2 * di + 2 * self.ssm_state + nh)
                + di * d
                + self.ssm_conv * (di + 2 * self.ssm_state)
                + 3 * nh
            )

        if self.family in ("dense", "vlm"):
            total += self.n_layers * (attn_params() + mlp_params(self.d_ff))
        elif self.family == "moe":
            total += self.n_layers * (
                attn_params() + self.n_experts * mlp_params(self.d_ff) + d * self.n_experts
            )
        elif self.family == "ssm":
            total += self.n_layers * ssm_params()
        elif self.family == "hybrid":
            total += self.n_layers * ssm_params()
            # ONE shared attention+MLP block, reused every attn_every layers
            # (zamba2's parameter-sharing trick)
            total += attn_params() + mlp_params(self.d_ff)
        elif self.family == "encdec":
            enc = self.encoder_layers * (attn_params() + mlp_params(self.d_ff))
            dec = self.n_layers * (2 * attn_params() + mlp_params(self.d_ff))
            total += enc + dec
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense_part = self.vocab * d + self.n_layers * (
            d * self.n_heads * self.head_dim * 2
            + d * self.n_kv_heads * self.head_dim * 2
            + d * self.n_experts
        )
        return dense_part + self.n_layers * self.top_k * 3 * d * self.d_ff


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    microbatches: int = 1  # gradient-accumulation chunks per step
    remat: str = "none"  # none | dots | full
    grad_compress: bool = False  # int8 error-feedback DP compression
