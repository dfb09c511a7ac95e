"""Shared inputs of ``tests/test_torch_mesh_ranks.py``: numpy only, so the
port's gloo ranks (``tests/torch_mesh_ranks_worker.py``) and the JAX
subprocess that computes the reference's side
(``tests/torch_mesh_ranks_ref.py``) build the same inputs from one seed
without importing each other's framework.  Float arrays are float32; a
bf16 input is that array rounded to bf16 on both sides (round to nearest
even in both frameworks, so the same bits).
"""
from __future__ import annotations

import numpy as np

MESH = (2, 4)  # (data, model) over 8 ranks
RANKS = MESH[0] * MESH[1]

# tests/test_moe_ep.py's configuration (capacity factor per case)
MOE = dict(name="moe-test", family="moe", n_layers=1, d_model=64, n_heads=4,
           n_kv_heads=2, head_dim=16, d_ff=96, vocab=128, n_experts=8,
           top_k=2)
# case -> (capacity factor, x shape): the training layout with no drops,
# the training layout dropping tokens per shard (32 tokens a shard: the
# capacity of 8 a expert binds), the serving layout (s=1)
MOE_CASES = {"train_cf8": (8.0, (4, 8, 64)),
             "train_cf1": (1.0, (4, 64, 64)),
             "serve_s1": (8.0, (4, 1, 64))}

# the blocks each rank holds of the layer's leaves (the plan's specs, as
# tuples of entries): experts x model, d_model over data (training), or
# the ffn over data (the serving layout)
_MOE_TRAIN = {"router": ("data", "model"), "up": ("model", "data", None),
              "gate": ("model", "data", None),
              "down": ("model", None, "data")}
_MOE_SERVE = {"router": (None, "model"), "up": ("model", None, "data"),
              "gate": ("model", None, "data"),
              "down": ("model", "data", None)}


def moe_specs(case: str) -> dict:
    return _MOE_SERVE if MOE_CASES[case][1][1] == 1 else _MOE_TRAIN


# batch specs for sharded_batches, as tuples of entries
BATCH_SPECS = {"data": ("data",), "data_model": (("data", "model"),),
               "data_seq": ("data", "model")}
STREAM = dict(vocab=128, seq_len=16, global_batch=8, seed=3)
STREAM_STEPS = (0, 1, 5)

DP_ARCHS = {"dense": "gemma-2b", "moe": "qwen3-moe-235b-a22b",
            "ssm": "mamba2-370m"}
DP_BATCH, DP_SEQ = 4, 32
DP_SEED = 1  # torch.Generator seed of the port's Model.init
PAD_VOCAB = 250  # a vocabulary padded to 256 rows (the last block's 6)
SERVE = (4, 16, 3)  # prefill B x S on the mesh, then decode steps
# the decode cache's layouts held against the reference's program with its
# plan (gemma-2b's smoke configuration: one kv head, so the head_dim splits
# over 'model'): case -> (B, prompt S, decode steps); the cache holds
# SERVE_LEN slots, which divide over 'data', so at B = 1 (the batch does
# not divide) the sequence splits over it
SERVE_REF = {"b4": (4, 16, 3), "b1": (1, 16, 3)}
SERVE_LEN = 20
# the families whose SSD mixer runs on each rank's block of its heads (8
# heads, 2 a rank), held through SERVE_REF's cases against the reference's
# program with its plan: the state held with its head_dim over 'model'
# (and at B = 1 its heads over 'data'), moved to the rank's heads by
# all-to-alls
SSD_ARCHS = {"ssm": "mamba2-370m", "hybrid": "zamba2-2.7b"}
# the families whose sublayers take the sequence-parallel stream by other
# routes than the dense one: cross attention and the encoder, the SSD
# mixer and the shared block, the vision embeddings and M-RoPE
SP_ARCHS = {"encdec": "whisper-base", "hybrid": "zamba2-2.7b",
            "vlm": "qwen2-vl-72b"}
# whisper's smoke configuration at 2 heads (and 2 kv heads), so that on a
# 4-way 'model' its self and cross caches hold their head_dim split
SP_HEADS = {"encdec": 2}
SP_VISION = 8  # vision embeddings of the vlm batch


def serve_tokens(b: int, n: int, vocab: int) -> np.ndarray:
    """``b`` rows of ``n`` tokens in [1, vocab), int32."""
    return np.random.default_rng(6).integers(1, vocab, (b, n)).astype(
        np.int32)


def moe_inputs(case: str) -> tuple:
    """(params as float32 arrays, x float32, capacity factor): router f32,
    experts fan-in scaled as ``Mk`` scales them."""
    cf, shape = MOE_CASES[case]
    rng = np.random.default_rng(7)
    d, ff, e = MOE["d_model"], MOE["d_ff"], MOE["n_experts"]
    params = {
        "router": rng.normal(size=(d, e)).astype(np.float32) * d**-0.5,
        "up": rng.normal(size=(e, d, ff)).astype(np.float32) * e**-0.5,
        "gate": rng.normal(size=(e, d, ff)).astype(np.float32) * e**-0.5,
        "down": rng.normal(size=(e, ff, d)).astype(np.float32) * e**-0.5,
    }
    x = (np.random.default_rng(11).normal(size=shape) * 0.1).astype(
        np.float32)
    return params, x, cf


def psum_inputs() -> tuple:
    """(global grads, global errors): each leaf's dim 0 holds the 8 ranks'
    blocks; "b" is a bf16 gradient."""
    rng = np.random.default_rng(5)
    grads = {"a": rng.normal(size=(RANKS * 3, 5)).astype(np.float32),
             "b": (rng.normal(size=(RANKS * 16,)) * 1e-3).astype(np.float32),
             "c": {"w": (rng.normal(size=(RANKS * 2, 4, 3)) * 50).astype(
                 np.float32)}}
    err = {"a": (rng.normal(size=(RANKS * 3, 5)) * 1e-2).astype(np.float32),
           "b": (rng.normal(size=(RANKS * 16,)) * 1e-5).astype(np.float32),
           "c": {"w": rng.normal(size=(RANKS * 2, 4, 3)).astype(
               np.float32)}}
    return grads, err
