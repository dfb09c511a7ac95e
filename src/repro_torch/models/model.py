"""Model assembly for every architecture family: the torch twin of the JAX
package's ``repro/models/model.py``.

One :class:`Model` covers:
  dense / vlm — pre-norm GQA transformer (optional sliding windows, a
                local:global pattern, M-RoPE, qk-norm, GeGLU/SwiGLU)
  moe         — dense attention + top-k expert FFN
  ssm         — mamba2 (SSD) stack
  hybrid      — mamba2 stack + ONE shared attention+MLP block applied every
                ``attn_every`` layers (zamba2)
  encdec      — whisper-style encoder/decoder with cross attention

Execution paths:
  * ``forward``     — full-sequence logits (the training-path oracle).
  * ``prefill``     — full sequence -> (last-token logits, decode cache).
  * ``decode_step`` — one token against the cache, through B5 (the decode
    attention kernel) on every attention layer; each layer's cache keeps
    its own length (window or full).

Parameters are a nested dict of tensors with the JAX tree's keys; the
layer parameters are stacked along a leading layer axis under ``blocks``
(and ``encoder``), as the JAX package stacks them for its layer scan.  The
layers run as a Python loop: the reference's ``lax.scan`` and its
``lax.cond`` on the hybrid's shared block become a loop over the static
layer index, so ``unroll`` changes nothing.  ``remat`` (activation
recomputation) wraps each layer body of ``forward`` as the reference's
``_maybe_remat`` wraps its scan body: ``"full"`` in
``torch.utils.checkpoint.checkpoint``, ``"dots"`` with a selective policy
that keeps the weight products; it changes no value, only training memory
(the encoder is not wrapped, as in the reference).
``forward`` is differentiable (the training path); ``prefill`` and
``decode_step`` run under ``torch.inference_mode()``.

``init`` returns the parameters; ``logical_axes`` the reference's axes tree
beside them (``distributed.sharding.param_pspecs`` reads both).
``set_mesh`` installs the reference's layout hooks: each call runs in the
mesh's ``shard_ctx`` scope (so the MoE layers take the expert-parallel
path where its ``model`` dim is > 1), and ``_constrain``, ``_constrain_bp``
and ``_constrain_logits`` pin the residual stream, each layer's parameters
(the plan's per-layer specs) and the logits.  A layout changes no value:
on plain tensors the pins are the identity, and the logits with a mesh set
are the logits without one.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from .._device import resolve_device
from ..configs.base import ModelConfig
from ..kernels.decode_attn import decode_attention
from .attention import (
    FLASH_MIN_SEQ,
    KVCache,
    attn_cross,
    attn_decode,
    attn_full,
    init_attention,
    init_kv_cache,
    project_kv,
)
from .flash import TileTable, pick_chunk
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
from .mamba2 import init_mamba2, init_ssm_cache, mamba2_decode, mamba2_full
from .moe import init_moe, moe_apply
from .param import AxesMk, Mk
from .shard_ctx import batch_axes, constrain_m, shard_scope

__all__ = ["Model", "build_model"]

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")
_ATTN = ("dense", "vlm", "moe")
_REMAT = ("none", "dots", "full")


def _at(tree, l: int):
    """Layer ``l`` of a stacked parameter tree."""
    return {k: _at(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


def _layers(tree, n: int) -> list:
    """The ``n`` per-layer trees of a stacked parameter tree, as views of
    one ``unbind`` a leaf: its gradient is one stacked tensor, where
    ``_at``'s ``v[l]`` would add up ``n`` zero-filled ones."""
    if not isinstance(tree, dict):
        return tree.unbind(0)
    per = {k: _layers(v, n) for k, v in tree.items()}
    return [{k: v[l] for k, v in per.items()} for l in range(n)]


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the 2-D weight products, recompute the rest: the reference's
    ``checkpoint_dots_with_no_batch_dims`` (a ``[B, S, d] @ [d, f]``
    product reaches aten as one ``mm`` over the flattened rows; the
    attention's batched products are ``bmm`` and are recomputed)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
              torch.ops.aten.mm.dtype):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(body: Callable, remat: str) -> Callable:
    """``body`` under activation recomputation: ``"full"`` saves only its
    inputs, ``"dots"`` also its weight products (:func:`_dots_policy`).
    Outside autograd there is nothing to save, and the body runs as it
    is."""
    if remat == "none" or not torch.is_grad_enabled():
        return body
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def run(*args):
        return checkpoint(body, *args, use_reentrant=False, **kw)

    return run


def _default_positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, dtype=torch.int32,
                        device=tokens.device)[None].expand(b, s)


class Model:
    """One architecture on one device.

    ``attention`` is the decode-attention function every attention layer
    calls after its cache write: B5's ``decode_attention`` (the default),
    or its plain version ``decode_attention_plain`` to hold the kernel
    against it.
    """

    def __init__(self, cfg: ModelConfig, device=None,
                 attention: Callable = decode_attention):
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.attention = attention
        self._mesh = None  # set by set_mesh
        self._msize = 1
        self._layer_specs = None

    # ------------------------------------------------------- distribution
    def set_mesh(self, mesh):
        """Install the layout hooks for ``mesh`` (a ``DeviceMesh``): the
        residual stream batch x ('pod','data'), sequence x 'model'; the
        logits' vocabulary x 'model'; each layer's parameters as the plan
        lays them out.  Returns the model."""
        from ..distributed.sharding import _axes

        self._mesh = mesh
        self._msize = _axes(mesh).get("model", 1)
        self._layer_specs = self._per_layer_shardings(mesh)
        return self

    def _per_layer_shardings(self, mesh) -> dict:
        """The plan's specs for ONE layer's parameters (the stacked specs
        minus the leading 'layers' dim), and the hybrid's shared block's."""
        from ..distributed.sharding import PartitionSpec, _map, param_pspecs

        shapes = Model(self.cfg, "meta").init(torch.Generator())
        specs = param_pspecs(self.logical_axes(), shapes, mesh)
        is_spec = lambda x: isinstance(x, PartitionSpec)  # noqa: E731
        out = {}
        for name in ("blocks", "encoder"):
            if name in specs:
                out[name] = _map(lambda sp: PartitionSpec(*sp[1:]),
                                 specs[name], is_leaf=is_spec)
        if "shared" in specs:
            out["shared"] = specs["shared"]
        return out

    def _constrain_bp(self, bp, which: str = "blocks"):
        if not self._layer_specs or which not in self._layer_specs:
            return bp
        from ..distributed.sharding import _map, constrain

        return _map(lambda t, sp: constrain(t, self._mesh, sp), bp,
                    self._layer_specs[which])

    def _scope(self):
        """The mesh's sharding scope for a model call, keeping the batch
        axes of an enclosing scope (the data-parallel step's); no mesh set:
        the enclosing scope, if any, stays."""
        if self._mesh is None:
            return contextlib.nullcontext()
        return shard_scope(self._mesh, batch_axes=batch_axes())

    def _constrain(self, x):
        """Residual-stream pin (a no-op when no mesh is installed)."""
        if self._mesh is None or x.dim() != 3:
            return x
        s = x.shape[1]
        seq = "model" if s > 1 and s % self._msize == 0 else None
        return constrain_m(self._mesh, x, "dp", seq, None)

    def _constrain_logits(self, logits):
        if self._mesh is None or logits.dim() != 3:
            return logits
        return constrain_m(self._mesh, logits, "dp", None, "model")

    # ------------------------------------------------------------- init
    def init(self, generator: torch.Generator):
        """Random parameters on the model's device, drawn from
        ``generator`` (a generator of that device; any generator on the
        meta device, which draws shapes alone).  Returns the params tree;
        :meth:`logical_axes` gives the reference's axes tree beside it."""
        return self._init_tree(Mk(generator, self.device))

    def logical_axes(self):
        """The reference's logical-axes tree of :meth:`init`'s parameters
        (``Model.init(key)[1]`` there): a tuple of axis names a leaf, with
        ``"layers"`` ahead of a stacked one."""
        return self._init_tree(AxesMk())

    def _init_tree(self, mk):
        cfg = self.cfg
        n, d = cfg.n_layers, cfg.d_model
        params = {"embed": init_embedding(mk, cfg),
                  "final_norm": init_rmsnorm(mk, d)}
        if cfg.family in _ATTN:
            blocks = {"ln1": init_rmsnorm(mk, d, layers=n),
                      "attn": init_attention(mk, cfg, layers=n),
                      "ln2": init_rmsnorm(mk, d, layers=n)}
            if cfg.family == "moe":
                blocks["moe"] = init_moe(mk, cfg, layers=n)
            else:
                blocks["mlp"] = init_mlp(mk, cfg, layers=n)
            params["blocks"] = blocks
        elif cfg.family in ("ssm", "hybrid"):
            params["blocks"] = {"ln": init_rmsnorm(mk, d, layers=n),
                                "ssm": init_mamba2(mk, cfg, layers=n)}
            if cfg.family == "hybrid":
                params["shared"] = {"ln1": init_rmsnorm(mk, d),
                                    "attn": init_attention(mk, cfg),
                                    "ln2": init_rmsnorm(mk, d),
                                    "mlp": init_mlp(mk, cfg)}
        else:  # encdec
            e = cfg.encoder_layers
            params["encoder"] = {"ln1": init_rmsnorm(mk, d, layers=e),
                                 "attn": init_attention(mk, cfg, layers=e),
                                 "ln2": init_rmsnorm(mk, d, layers=e),
                                 "mlp": init_mlp(mk, cfg, layers=e)}
            params["blocks"] = {"ln1": init_rmsnorm(mk, d, layers=n),
                                "self_attn": init_attention(mk, cfg, layers=n),
                                "ln_x": init_rmsnorm(mk, d, layers=n),
                                "cross_attn": init_attention(mk, cfg,
                                                             layers=n),
                                "ln2": init_rmsnorm(mk, d, layers=n),
                                "mlp": init_mlp(mk, cfg, layers=n)}
            params["enc_norm"] = init_rmsnorm(mk, d)
        return params

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

    def _has_shared_attn(self, l: int) -> bool:
        """Whether hybrid layer ``l`` is followed by the shared block."""
        return (l + 1) % self.cfg.attn_every == 0

    # ------------------------------------------------------------ forward
    def forward(self, params, batch: dict, *, remat: str = "none",
                unroll: bool = False, return_hidden: bool = False):
        """Full-sequence logits.  Returns (logits [B,S,V] f32, aux_loss), or
        the final-normed hidden state in place of the logits when
        ``return_hidden``."""
        if remat not in _REMAT:
            raise ValueError(remat)
        with self._scope():
            return self._forward(params, batch, remat, return_hidden)

    def _forward(self, params, batch: dict, remat: str, return_hidden: bool):
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        if cfg.family == "encdec":
            enc_out = self.encode(params, batch)
            x, positions = self._embed_decoder(params, batch)
        else:
            x, positions = self._embed_inputs(params, batch)
        x = self._constrain(x)
        tiles = self._tiles(positions, batch)
        blocks = _layers(params["blocks"], cfg.n_layers)

        if cfg.family in _ATTN:
            windows = self.layer_windows()

            def layer(x, aux, bp, window):
                bp = self._constrain_bp(bp)
                h = rmsnorm(x, bp["ln1"]["w"])
                x = residual_add(x, attn_full(bp["attn"], h, cfg, positions,
                                              window, tiles=tiles))
                h = rmsnorm(x, bp["ln2"]["w"])
                if cfg.family == "moe":
                    h, a = moe_apply(bp["moe"], h, cfg)
                    aux = aux + a
                else:
                    h = mlp(bp["mlp"], h, cfg)
                return self._constrain(residual_add(x, h)), aux

            layer = _maybe_remat(layer, remat)
            for bp, window in zip(blocks, windows):
                x, aux = layer(x, aux, bp, window)
        elif cfg.family in ("ssm", "hybrid"):
            def ssm_layer(x, bp):
                bp = self._constrain_bp(bp)
                h = rmsnorm(x, bp["ln"]["w"])
                return self._constrain(
                    residual_add(x, mamba2_full(bp["ssm"], h, cfg)))

            shared = self._constrain_bp(params.get("shared"), "shared")

            def shared_block(x):
                return self._constrain(self._shared_block(
                    shared, x, positions, tiles)[0])

            ssm_layer = _maybe_remat(ssm_layer, remat)
            shared_block = _maybe_remat(shared_block, remat)
            for l, bp in enumerate(blocks):
                x = ssm_layer(x, bp)
                if cfg.family == "hybrid" and self._has_shared_attn(l):
                    x = shared_block(x)
        else:  # encdec
            def dec_layer(x, bp):
                bp = self._constrain_bp(bp)
                return self._constrain(
                    self._dec_layer(bp, x, positions, tiles, enc_out)[0])

            dec_layer = _maybe_remat(dec_layer, remat)
            for bp in blocks:
                x = dec_layer(x, bp)

        x = rmsnorm(x, params["final_norm"]["w"])
        if return_hidden:
            return x, aux
        return self._constrain_logits(unembed(params["embed"], x, cfg)), aux

    def _shared_block(self, shared, x, positions, tiles):
        """The hybrid's shared attention + MLP block; returns (x, k, v)."""
        cfg = self.cfg
        h = rmsnorm(x, shared["ln1"]["w"])
        out, k, v = attn_full(shared["attn"], h, cfg, positions, tiles=tiles,
                              return_kv=True)
        x = residual_add(x, out)
        h = rmsnorm(x, shared["ln2"]["w"])
        return residual_add(x, mlp(shared["mlp"], h, cfg)), k, v

    def _dec_layer(self, bp, x, positions, tiles, enc_out):
        """One decoder layer of the encoder-decoder; returns (x, self K,
        self V, cross K, cross V)."""
        cfg = self.cfg
        h = rmsnorm(x, bp["ln1"]["w"])
        out, k, v = attn_full(bp["self_attn"], h, cfg, positions,
                              tiles=tiles, return_kv=True)
        x = residual_add(x, out)
        h = rmsnorm(x, bp["ln_x"]["w"])
        ek, ev = project_kv(bp["cross_attn"], enc_out, cfg)
        x = residual_add(x, attn_cross(bp["cross_attn"], h, ek, ev, cfg))
        h = rmsnorm(x, bp["ln2"]["w"])
        return residual_add(x, mlp(bp["mlp"], h, cfg)), k, v, ek, ev

    # ------------------------------------------------------------ encoder
    def encode(self, params, batch: dict):
        """Whisper encoder over stubbed frame embeddings [B, S, d]."""
        cfg = self.cfg
        x = batch["frames"].to(torch.bfloat16)
        b, s = x.shape[:2]
        if cfg.pos == "learned":
            x = x + params["embed"]["pos"][:s][None]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        for bp in _layers(params["encoder"], cfg.encoder_layers):
            bp = self._constrain_bp(bp, "encoder")
            h = rmsnorm(x, bp["ln1"]["w"])
            x = residual_add(x, attn_full(bp["attn"], h, cfg, positions,
                                          causal=False))
            h = rmsnorm(x, bp["ln2"]["w"])
            x = self._constrain(residual_add(x, mlp(bp["mlp"], h, cfg)))
        return rmsnorm(x, params["enc_norm"]["w"])

    # ------------------------------------------------------------ caches
    def init_cache(self, batch: int, max_len: int, enc_len: int = 0):
        """The decode cache: per layer a :class:`KVCache` (window-sized on
        sliding-window layers), an ``SSMCache``, the hybrid's dict of both,
        or the encoder-decoder's self cache and cross K/V; and the shared
        position ``len`` (a Python int here, where the reference keeps a
        device scalar)."""
        cfg, dev = self.cfg, self.device
        caches = []
        if cfg.family in _ATTN:
            for w in self.layer_windows():
                length = min(w, max_len) if w else max_len
                caches.append(init_kv_cache(batch, length, cfg, dev))
        elif cfg.family == "ssm":
            caches = [init_ssm_cache(batch, cfg, dev)
                      for _ in range(cfg.n_layers)]
        elif cfg.family == "hybrid":
            for l in range(cfg.n_layers):
                entry = {"ssm": init_ssm_cache(batch, cfg, dev)}
                if self._has_shared_attn(l):
                    entry["attn"] = init_kv_cache(batch, max_len, cfg, dev)
                caches.append(entry)
        else:  # encdec
            shape = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
            for _ in range(cfg.n_layers):
                caches.append({
                    "self": init_kv_cache(batch, max_len, cfg, dev),
                    "cross_k": torch.zeros(shape, dtype=torch.bfloat16,
                                           device=dev),
                    "cross_v": torch.zeros(shape, dtype=torch.bfloat16,
                                           device=dev),
                })
        return {"layers": tuple(caches), "len": 0}

    # ------------------------------------------------------------ decode
    @torch.inference_mode()
    def decode_step(self, params, cache, tokens: torch.Tensor):
        """One new token per sequence. tokens: [B, 1] -> (logits [B, V] f32,
        cache).  Every row takes position ``cache['len']``; attention caches
        are written in place, and the returned cache holds ``len + 1``."""
        with self._scope():
            return self._decode_step(params, cache, tokens)

    def _decode_step(self, params, cache, tokens: torch.Tensor):
        cfg = self.cfg
        pos = cache["len"]
        b = tokens.shape[0]
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=tokens.device)
        if cfg.m_rope_sections:
            positions = positions[None].expand(3, b, 1)

        x = embed(params["embed"], tokens, cfg)
        if cfg.pos == "learned":
            x = x + params["embed"]["pos"][pos][None, None]

        attend = self.attention
        windows = self.layer_windows()
        new_layers = []
        for l in range(cfg.n_layers):
            bp = _at(params["blocks"], l)
            lc = cache["layers"][l]
            if cfg.family in _ATTN:
                h = rmsnorm(x, bp["ln1"]["w"])
                h, lc = attn_decode(bp["attn"], h, lc, cfg, positions,
                                    windows[l], attend=attend)
                x = residual_add(x, h)
                h = rmsnorm(x, bp["ln2"]["w"])
                if cfg.family == "moe":
                    h, _ = moe_apply(bp["moe"], h, cfg)
                else:
                    h = mlp(bp["mlp"], h, cfg)
                x = residual_add(x, h)
            elif cfg.family == "ssm":
                h = rmsnorm(x, bp["ln"]["w"])
                h, lc = mamba2_decode(bp["ssm"], h, lc, cfg)
                x = residual_add(x, h)
            elif cfg.family == "hybrid":
                h = rmsnorm(x, bp["ln"]["w"])
                h, ssm_c = mamba2_decode(bp["ssm"], h, lc["ssm"], cfg)
                x = residual_add(x, h)
                lc = dict(lc, ssm=ssm_c)
                if "attn" in lc:
                    shared = params["shared"]
                    h = rmsnorm(x, shared["ln1"]["w"])
                    h, _ = attn_decode(shared["attn"], h, lc["attn"], cfg,
                                       positions, attend=attend)
                    x = residual_add(x, h)
                    h = rmsnorm(x, shared["ln2"]["w"])
                    x = residual_add(x, mlp(shared["mlp"], h, cfg))
            else:  # encdec
                h = rmsnorm(x, bp["ln1"]["w"])
                h, _ = attn_decode(bp["self_attn"], h, lc["self"], cfg,
                                   positions, attend=attend)
                x = residual_add(x, h)
                h = rmsnorm(x, bp["ln_x"]["w"])
                x = residual_add(x, attn_cross(bp["cross_attn"], h,
                                               lc["cross_k"], lc["cross_v"],
                                               cfg))
                h = rmsnorm(x, bp["ln2"]["w"])
                x = residual_add(x, mlp(bp["mlp"], h, cfg))
            new_layers.append(lc)

        x = rmsnorm(x, params["final_norm"]["w"])
        logits = unembed(params["embed"], x[:, 0], cfg)
        return logits, {"layers": tuple(new_layers), "len": pos + 1}

    # ------------------------------------------------------------ prefill
    @torch.inference_mode()
    def prefill(self, params, batch: dict, unroll: bool = False,
                max_len=None):
        """Full-sequence pass returning (last-token logits, primed cache).

        ``max_len`` sizes the decode cache (default: exactly the prompt
        length, a FULL cache whose next write rotates out position 0;
        serving passes prompt + generation budget so slots are free).  Only
        the last position is unembedded: serving never reads the others."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        max_len = max_len or s
        if cfg.family in _ATTN:
            with self._scope():
                return self._prefill_fused(params, batch, max_len)
        if cfg.family in ("ssm", "hybrid"):
            with self._scope():
                return self._prefill_fused_ssm(params, batch, max_len)
        hidden, _ = self.forward(params, batch, return_hidden=True)
        logits = unembed(params["embed"], hidden[:, -1], cfg)
        cache = self.init_cache(
            b, max_len, enc_len=batch.get("frames", tokens).shape[1])
        with self._scope():
            return logits, self._prime_cache(params, batch, cache)

    @staticmethod
    def _cache_layout(k, v, pos, t_alloc: int, s: int) -> KVCache:
        """Lay the (tail of the) prefilled K/V into a ``t_alloc``-slot
        rotating cache keeping the invariant ``slot == pos % t_alloc`` that
        decode relies on to evict the oldest entry.  Contiguous buffers in
        every case: B5 and the in-place decode writes need them."""
        if t_alloc == s:
            return KVCache(k=k.contiguous(), v=v.contiguous(),
                           pos=pos.contiguous())
        b = k.shape[0]
        keep = min(s, t_alloc)
        k_t, v_t, p_t = k[:, s - keep:], v[:, s - keep:], pos[:, s - keep:]
        slots = (p_t % t_alloc).long()
        bidx = torch.arange(b, device=k.device)[:, None]
        k_buf = torch.zeros((b, t_alloc) + tuple(k.shape[2:]), dtype=k.dtype,
                            device=k.device)
        v_buf = torch.zeros_like(k_buf)
        p_buf = torch.full((b, t_alloc), -1, dtype=torch.int32,
                           device=k.device)
        k_buf[bidx, slots] = k_t
        v_buf[bidx, slots] = v_t
        p_buf[bidx, slots] = p_t.to(torch.int32)
        return KVCache(k=k_buf, v=v_buf, pos=p_buf)

    def _prefill_fused(self, params, batch: dict, max_len: int):
        """dense/vlm/moe prefill: one pass computing the last logits AND the
        cache.  Each layer's K/V is laid into its cache as the layer ends
        (window layers keep only their last ``w`` positions, in rotating
        slot order)."""
        cfg = self.cfg
        s = batch["tokens"].shape[1]
        x, positions = self._embed_inputs(params, batch)
        x = self._constrain(x)
        pos1d = positions[0] if cfg.m_rope_sections else positions
        tiles = self._tiles(positions, batch)
        layers = []
        for l, w in enumerate(self.layer_windows()):
            bp = self._constrain_bp(_at(params["blocks"], l))
            h = rmsnorm(x, bp["ln1"]["w"])
            out, k, v = attn_full(bp["attn"], h, cfg, positions, w,
                                  tiles=tiles, return_kv=True)
            x = residual_add(x, out)
            h = rmsnorm(x, bp["ln2"]["w"])
            if cfg.family == "moe":
                hh, _ = moe_apply(bp["moe"], h, cfg)
            else:
                hh = mlp(bp["mlp"], h, cfg)
            x = self._constrain(residual_add(x, hh))
            layers.append(self._cache_layout(
                k, v, pos1d, min(w, max_len) if w else max_len, s))
        x = rmsnorm(x, params["final_norm"]["w"])
        logits = unembed(params["embed"], x[:, -1], cfg)
        return logits, {"layers": tuple(layers), "len": s}

    def _prefill_fused_ssm(self, params, batch: dict, max_len: int):
        """ssm/hybrid prefill: each layer's SSM state (and, for the hybrid,
        the shared block's K/V) taken as the layer runs."""
        cfg = self.cfg
        s = batch["tokens"].shape[1]
        x, positions = self._embed_inputs(params, batch)
        pos1d = positions[0] if cfg.m_rope_sections else positions
        tiles = self._tiles(positions, batch)
        layers = []
        for l in range(cfg.n_layers):
            bp = _at(params["blocks"], l)
            h = rmsnorm(x, bp["ln"]["w"])
            y, st = mamba2_full(bp["ssm"], h, cfg, return_state=True)
            x = residual_add(x, y)
            if cfg.family == "ssm":
                layers.append(st)
                continue
            entry = {"ssm": st}
            if self._has_shared_attn(l):
                x, k, v = self._shared_block(params["shared"], x, positions,
                                             tiles)
                entry["attn"] = self._cache_layout(k, v, pos1d, max_len, s)
            layers.append(entry)
        x = rmsnorm(x, params["final_norm"]["w"])
        logits = unembed(params["embed"], x[:, -1], cfg)
        return logits, {"layers": tuple(layers), "len": s}

    def _prime_cache(self, params, batch, cache):
        """The encoder-decoder's cache: re-run the decoder stack to fill each
        layer's self K/V (at ``slot == pos % T``) and its cross K/V, as the
        reference's prefill does after its forward."""
        cfg = self.cfg
        enc_out = self.encode(params, batch)
        x, positions = self._embed_decoder(params, batch)
        b, s = positions.shape
        tiles = self._tiles(positions, batch)
        layers = list(cache["layers"])
        for l in range(cfg.n_layers):
            x, k, v, ek, ev = self._dec_layer(_at(params["blocks"], l), x,
                                              positions, tiles, enc_out)
            sc = layers[l]["self"]
            t = sc.pos.shape[1]
            take = min(t, s)
            slots = (positions[:, s - take:] % t).long()
            bidx = torch.arange(b, device=x.device)[:, None]
            sc.k[bidx, slots] = k[:, s - take:]
            sc.v[bidx, slots] = v[:, s - take:]
            sc.pos[bidx, slots] = positions[:, s - take:]
            layers[l] = dict(layers[l], cross_k=ek, cross_v=ev)
        return {"layers": tuple(layers), "len": s}

    # ------------------------------------------------------------ helpers
    def _tiles(self, positions, batch: dict):
        """The live flash tiles of a forward's self-attention (None below
        ``FLASH_MIN_SEQ``, where attention is dense).  The model's own
        positions (``arange(S)``: no ``batch["positions"]``, and always on
        the encoder-decoder) give the table without a device read;
        caller-given ones are read once."""
        pos1d = positions[0] if self.cfg.m_rope_sections else positions
        s = pos1d.shape[1]
        if s < FLASH_MIN_SEQ:
            return None
        cq, ck = pick_chunk(s, 512), pick_chunk(s, 1024)
        if self.cfg.family == "encdec" or batch.get("positions") is None:
            return TileTable.of_arange(pos1d, cq, ck)
        return TileTable(pos1d, pos1d, cq, ck)

    def _embed_inputs(self, params, batch: dict):
        cfg = self.cfg
        tokens = batch["tokens"]
        if cfg.family == "encdec":
            return self._embed_decoder(params, batch)
        b, s = tokens.shape
        x = embed(params["embed"], tokens, cfg)
        if cfg.family == "vlm" and "vision_embeds" in batch:
            ve = batch["vision_embeds"].to(x.dtype)
            x = torch.cat([ve, x[:, ve.shape[1]:]], dim=1)
        positions = batch.get("positions")
        if positions is None:
            positions = _default_positions(tokens)
            if cfg.m_rope_sections:
                positions = positions[None].expand(3, b, s)
        if cfg.pos == "learned":
            x = x + params["embed"]["pos"][:s][None]
        return x, positions

    def _embed_decoder(self, params, batch: dict):
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed(params["embed"], tokens, cfg)
        if cfg.pos == "learned":
            x = x + params["embed"]["pos"][:tokens.shape[1]][None]
        return x, _default_positions(tokens)


def build_model(cfg: ModelConfig, device=None,
                attention: Callable = decode_attention) -> Model:
    return Model(cfg, device, attention)
