"""Model assembly, dense family, cached decode: the torch twin of the JAX
package's ``repro/models/model.py`` (``Model.init``, ``layer_windows``,
``init_cache``, ``decode_step`` and ``build_model``).

The dense family is a pre-norm GQA transformer (optional sliding windows,
a local:global pattern, qk-norm, GeGLU/SwiGLU).  ``decode_step``
runs the layers unrolled, so each layer's cache keeps its own length
(window or full).  Parameters are a nested dict of tensors with the JAX
tree's keys; the layer parameters are stacked along a leading layer axis
under ``blocks``, as the JAX package stacks them for its layer scan.

Not ported yet (ROADMAP A15): ``forward`` and ``prefill`` (with
``attn_full`` and ``models/flash.py``), and the moe, ssm, hybrid, encdec
and vlm families.  The reference's mesh hooks (``set_mesh``,
``_constrain*``) have no meaning on one card.
"""
from __future__ import annotations

from typing import Callable

import torch

from .._device import resolve_device
from ..configs.base import ModelConfig
from ..kernels.decode_attn import decode_attention
from .attention import attn_decode, init_attention, init_kv_cache
from .layers import (
    embed,
    init_embedding,
    init_mlp,
    init_rmsnorm,
    mlp,
    residual_add,
    rmsnorm,
    unembed,
)
from .param import Mk

__all__ = ["Model", "build_model"]

_NOT_PORTED = ("the {} family is not ported yet (ROADMAP §A A15: the moe, "
               "ssm/hybrid, enc-dec and vlm families come after prefill and "
               "training)")


class Model:
    """One architecture on one device.

    ``attention`` is the decode-attention function every layer calls after
    its cache write: B5's ``decode_attention`` (the default), or its plain
    version ``decode_attention_plain`` to hold the kernel against it.
    """

    def __init__(self, cfg: ModelConfig, device=None,
                 attention: Callable = decode_attention):
        if cfg.family != "dense":
            raise NotImplementedError(_NOT_PORTED.format(cfg.family))
        self.cfg = cfg
        self.device = resolve_device(device)
        self.attention = attention

    # ------------------------------------------------------------- init
    def init(self, generator: torch.Generator):
        """Random parameters on the model's device, drawn from
        ``generator`` (a generator of that device).  Returns the params
        tree; the reference's logical axes have no counterpart on one
        card."""
        cfg = self.cfg
        mk = Mk(generator, self.device)
        n = cfg.n_layers
        return {
            "embed": init_embedding(mk, cfg),
            "final_norm": init_rmsnorm(mk, cfg.d_model),
            "blocks": {
                "ln1": init_rmsnorm(mk, cfg.d_model, layers=n),
                "attn": init_attention(mk, cfg, layers=n),
                "ln2": init_rmsnorm(mk, cfg.d_model, layers=n),
                "mlp": init_mlp(mk, cfg, layers=n),
            },
        }

    # ------------------------------------------------- layer windows
    def layer_windows(self) -> list:
        """Per-layer sliding window (0 = full attention). Static python ints."""
        cfg = self.cfg
        w = []
        for l in range(cfg.n_layers):
            if cfg.sliding_window == 0:
                w.append(0)
            elif cfg.local_global_pattern:
                period = cfg.local_global_pattern + 1
                w.append(0 if (l + 1) % period == 0 else cfg.sliding_window)
            else:
                w.append(cfg.sliding_window)
        return w

    # ------------------------------------------------------------ caches
    def init_cache(self, batch: int, max_len: int):
        """The decode cache: one :class:`KVCache` per layer, window-sized on
        sliding-window layers, and the shared position ``len`` (a Python
        int here, where the reference keeps a device scalar)."""
        caches = []
        for w in self.layer_windows():
            length = min(w, max_len) if w else max_len
            caches.append(init_kv_cache(batch, length, self.cfg, self.device))
        return {"layers": tuple(caches), "len": 0}

    # ------------------------------------------------------------ decode
    def decode_step(self, params, cache, tokens: torch.Tensor):
        """One new token per sequence. tokens: [B, 1] -> (logits [B, V] f32,
        cache).  Every row takes position ``cache['len']``; the layer caches
        are written in place and the returned cache holds ``len + 1``."""
        cfg = self.cfg
        pos = cache["len"]
        b = tokens.shape[0]
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=tokens.device)

        x = embed(params["embed"], tokens, cfg)
        blocks = params["blocks"]
        windows = self.layer_windows()
        for l in range(cfg.n_layers):
            h = rmsnorm(x, blocks["ln1"]["w"][l])
            attn = {key: (val[l] if isinstance(val, torch.Tensor)
                          else {"w": val["w"][l]})
                    for key, val in blocks["attn"].items()}
            h, _ = attn_decode(attn, h, cache["layers"][l], cfg, positions,
                               windows[l], attend=self.attention)
            x = residual_add(x, h)
            h = rmsnorm(x, blocks["ln2"]["w"][l])
            h = mlp({key: val[l] for key, val in blocks["mlp"].items()}, h,
                    cfg)
            x = residual_add(x, h)

        x = rmsnorm(x, params["final_norm"]["w"])
        logits = unembed(params["embed"], x[:, 0], cfg)
        return logits, {"layers": cache["layers"], "len": pos + 1}

    def forward(self, *args, **kwargs):
        raise NotImplementedError(
            "Model.forward is not ported yet (ROADMAP §A A15, step 1: "
            "forward/prefill with attn_full and models/flash.py)")

    def prefill(self, *args, **kwargs):
        raise NotImplementedError(
            "Model.prefill is not ported yet (ROADMAP §A A15, step 1: "
            "forward/prefill with attn_full and models/flash.py)")


def build_model(cfg: ModelConfig, device=None,
                attention: Callable = decode_attention) -> Model:
    return Model(cfg, device, attention)
