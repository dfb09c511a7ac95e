"""Allocation-free stand-ins for every (arch x shape) cell: the torch twin of
the JAX package's ``repro/launch/specs.py``.

Where the reference builds ``jax.ShapeDtypeStruct`` leaves under
``jax.eval_shape``, these are tensors on the meta device: the reference's
shapes and dtypes, no storage, so the multi-hundred-billion-parameter
configurations lay out without touching device memory.  Modality
frontends are stubbed as in the reference: whisper gets precomputed frame
embeddings, qwen2-vl patch embeddings.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models.model import Model
from ..optim import adamw_init

__all__ = ["VISION_TOKENS", "cache_specs", "input_specs", "state_specs"]

VISION_TOKENS = 256  # stub patch-embedding length for the VLM frontend


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _meta(model: Model) -> Model:
    return Model(model.cfg, "meta", model.attention)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Batch specs for the step that ``shape.kind`` runs."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _sds((b, 1), torch.int32)}
    batch = {"tokens": _sds((b, s), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = _sds((b, s), torch.int32)
    if cfg.family == "encdec":
        batch["frames"] = _sds((b, s, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm":
        batch["vision_embeds"] = _sds((b, VISION_TOKENS, cfg.d_model),
                                      torch.bfloat16)
    return batch


def state_specs(model: Model):
    """(parameter specs, optimizer-state specs, logical axes) on the meta
    device."""
    meta = _meta(model)
    params = meta.init(torch.Generator())
    return params, adamw_init(params), meta.logical_axes()


def cache_specs(model: Model, shape: ShapeConfig):
    """Decode-cache specs for the given serving shape; the position ``len``
    as a 0-d int32 tensor, the reference's scalar (the port's cache keeps a
    Python int)."""
    cache = _meta(model).init_cache(shape.global_batch, shape.seq_len,
                                    enc_len=shape.seq_len)
    return dict(cache, len=_sds((), torch.int32))
