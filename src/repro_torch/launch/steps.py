"""Step functions: the torch twin of the JAX package's
``repro/launch/steps.py``.  ``make_prefill_step`` and ``make_decode_step``
are ported; ``make_train_step`` comes with the training slice (ROADMAP §A
A15.2).  The reference jit-compiles these steps; the port runs them
eagerly, under ``torch.inference_mode()`` (``Model.prefill`` and
``Model.decode_step`` enter it).
"""
from __future__ import annotations

import torch

from ..models.model import Model

__all__ = ["make_decode_step", "make_prefill_step"]


def make_prefill_step(model: Model, unroll: bool = False):
    """(params, batch) -> (last-token logits, primed decode cache)."""

    def prefill_step(params, batch):
        return model.prefill(params, batch, unroll=unroll)

    return prefill_step


def make_decode_step(model: Model, sample: bool = False):
    """(params, cache, tokens[B,1]) -> (next_tokens[B,1], logits, cache).

    ``sample`` is kept for the reference's signature: both pick the argmax.
    """

    def decode_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return nxt, logits, cache

    return decode_step
