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
DP_MESH = (4, 2)  # the data-parallel step: data=4 (two replicas of it)

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

# batch specs for sharded_batches, as tuples of entries
BATCH_SPECS = {"data": ("data",), "data_model": (("data", "model"),),
               "data_seq": ("data", "model")}
STREAM = dict(vocab=128, seq_len=16, global_batch=8, seed=3)
STREAM_STEPS = (0, 1, 5)

DP_ARCHS = {"dense": "gemma-2b", "moe": "qwen3-moe-235b-a22b"}
DP_BATCH, DP_SEQ = 4, 32
DP_SEED = 1  # torch.Generator seed of the port's Model.init


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
