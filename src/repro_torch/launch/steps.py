"""Step functions: the torch twin of the JAX package's
``repro/launch/steps.py``.  Only ``make_decode_step`` is ported;
``make_train_step`` and ``make_prefill_step`` come with the training and
prefill slices (ROADMAP §A A15).
"""
from __future__ import annotations

import torch

from ..models.model import Model

__all__ = ["make_decode_step"]


def make_decode_step(model: Model, sample: bool = False):
    """(params, cache, tokens[B,1]) -> (next_tokens[B,1], logits, cache).

    ``sample`` is kept for the reference's signature: both pick the argmax.
    The reference jit-compiles this step; the port runs it eagerly.
    """

    def decode_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return nxt, logits, cache

    return decode_step
