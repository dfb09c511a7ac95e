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
path where its ``model`` dim is > 1), and ``_constrain_logits`` pins the
logits (the identity on plain tensors).

Under a scope with a plan (a step's ``param_shardings``), the parameters
are this rank's blocks of it: each layer gathers its leaves on use inside
its body (:func:`_gathered`; the remat recompute gathers again, ZeRO-3's
backward), so one layer's gathered leaves live at a time.  Attention's
heads, the MLP's ffn, the vocabulary, the experts and the SSD mixer's
heads run on the rank's block over 'model' where the plan splits them;
every other leaf is gathered whole and its compute replicated over
'model'.  Between
sublayers each rank holds its block of the sequence over 'model' where the
sequence divides (sequence parallelism, :meth:`Model._seq_split`).  The
decode cache is then held as the scope's cache plan (``cache_pspecs``)
lays it out, and prefill lays its cache out so.
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
    CacheLayout,
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
    MODEL_BLOCKS,
    embed,
    init_embedding,
    init_mlp,
    init_rmsnorm,
    mlp,
    on_model_block,
    residual_add,
    rmsnorm,
    stream_inputs,
    stream_output,
    unembed,
)
from .mamba2 import (head_columns, init_mamba2, init_ssm_cache, mamba2_decode,
                     mamba2_full)
from .moe import init_moe, moe_apply
from .param import AxesMk, Mk
from .shard_ctx import (
    batch_axes,
    constrain_m,
    current_cache_plan,
    current_mesh,
    current_plan,
    rescoped,
    seq_scope,
    seq_split,
    shard_scope,
)

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


# The leaves whose compute runs on a rank's block over 'model' where the
# plan splits them: attention's projections (heads, kv), the MLP's (ffn),
# the vocabulary's rows and columns.
_SPLIT = frozenset({"wq", "wk", "wv", "wo", "up", "gate", "down", "table",
                    "head"})


def _on_model_block(name: str, spec, mesh) -> bool:
    """Whether leaf ``name``, laid out by ``spec`` (one layer's) on
    ``mesh``, is computed with as the rank's block over 'model': a leaf of
    :data:`_SPLIT` that the plan lays over a 'model' dim of more than one
    rank.  The one place this is decided."""
    from ..distributed.sharding import _axes, _names

    return (name in _SPLIT and _axes(mesh).get("model", 1) > 1
            and any("model" in _names(e) for e in spec))


# The SSD mixer's leaves that the plan's 'inner' lays over 'model', and
# the dim it names in each (one layer's).
_SSD_INNER = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "norm_w": 0,
              "out_proj": 0}


def _ssd_on_heads(tree, specs, mesh) -> bool:
    """Whether the SSD mixer ``tree`` (one layer's blocks, laid out by
    ``specs``) runs on the rank's block of its heads over 'model': the
    plan lays every leaf of :data:`_SSD_INNER` over a 'model' dim of more
    than one rank, and the heads divide it.  Else (a divisibility
    fallback replicated a leaf, or the heads do not divide) the mixer is
    gathered whole and runs replicated.  The one place this is decided."""
    from ..distributed.sharding import _axes, _names

    m = _axes(mesh).get("model", 1)
    return (m > 1 and tree["A_log"].shape[-1] % m == 0
            and all("model" in _names(specs[k][d])
                    for k, d in _SSD_INNER.items()))


def _ssd_heads(tree, specs, mesh, data: tuple):
    """The SSD mixer's blocks as a rank computes with them on its block of
    the heads (:func:`_ssd_on_heads`): ``in_proj`` and the conv gathered
    over the data axes, then their columns of the rank's heads (z, x, dt)
    and B and C whole taken over 'model' (one all-to-all a leaf); the
    norm and ``out_proj`` its block as the plan holds it; ``A_log``,
    ``D`` and ``dt_bias`` its heads of the whole.  Every leaf is named
    under :data:`~.layers.MODEL_BLOCKS`.  The gradients: B's and C's
    columns summed over 'model' (each rank's from its heads), the heads'
    vectors too (zero off the rank's heads)."""
    from ..distributed.sharding import _axes, use

    m = _axes(mesh)["model"]
    r = mesh.get_local_rank("model")
    nh = tree["A_log"].shape[-1]
    di = tree["norm_w"].shape[-1] * m
    n = (tree["in_proj"].shape[-1] * m - 2 * di - nh) // 2
    cols = head_columns(di, n, nh, m)
    h = nh // m
    out = {}
    for k, t in tree.items():
        if k in cols:
            out[k] = use(t, mesh, specs[k], keep=("model",), partial=data,
                         columns=(_SSD_INNER[k], cols[k]))
        elif k in _SSD_INNER:
            out[k] = use(t, mesh, specs[k], keep=("model",), partial=data)
        else:
            out[k] = use(t, mesh, specs[k],
                         partial=data + ("model",))[r * h:(r + 1) * h]
    out[MODEL_BLOCKS] = frozenset(tree)
    return out


# The norms that act on the residual stream: under sequence parallelism
# each rank applies them to its block of the sequence.
_STREAM_NORMS = frozenset({"ln", "ln1", "ln2", "ln_x", "final_norm",
                           "enc_norm"})


def _gathered(tree, specs, mesh, data: tuple):
    """A layer's (or the embedding's) blocks as it computes with them: the
    leaves :func:`_on_model_block` picks gathered over the data axes alone
    (kept as the rank's block over 'model', and named under
    :data:`~.layers.MODEL_BLOCKS`, which the layer functions read), the
    SSD mixer's on its heads where :func:`_ssd_on_heads` says so
    (:func:`_ssd_heads`), every other leaf gathered whole; a moe layer's
    leaves stay blocks (``moe_apply`` gathers them as its path needs).  Their gradients sum
    over ``data`` (the mesh dims of the rank's batch block) and over
    'model' too for the q/k norms of heads split over 'model' (each rank
    normed its own heads) and, under sequence parallelism, for the
    residual stream's norms (each rank normed its own positions)."""
    from ..distributed.sharding import use

    out, blocks = {}, set()
    for k, t in tree.items():
        s = specs[k]
        if k == "moe":
            out[k] = t
        elif k == "ssm" and _ssd_on_heads(t, s, mesh):
            out[k] = _ssd_heads(t, s, mesh, data)
        elif k in ("q_norm", "k_norm"):
            w = "wq" if k == "q_norm" else "wk"
            heads = _on_model_block(w, specs[w], mesh)
            out[k] = {"w": use(t["w"], mesh, s["w"],
                               partial=data + (("model",) if heads else ()))}
        elif isinstance(t, dict):
            stream = k in _STREAM_NORMS and seq_split()
            out[k] = _gathered(t, s, mesh,
                               data + (("model",) if stream else ()))
        else:
            block = _on_model_block(k, s, mesh)
            if block:
                blocks.add(k)
            out[k] = use(t, mesh, s, keep=("model",) if block else (),
                         partial=data)
    if blocks:
        out[MODEL_BLOCKS] = frozenset(blocks)
    return out


def _kv_split(attn_specs) -> bool:
    """Whether an attention's kv heads split over 'model' under the plan
    (its ``wk`` spec, one layer's)."""
    return _on_model_block("wk", attn_specs["wk"], current_mesh())


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
    is.  The recomputation runs in the scope of the forward (the mesh and
    the plan the body gathers its leaves by)."""
    if remat == "none" or not torch.is_grad_enabled():
        return body
    body = rescoped(body)
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def run(*args):
        return checkpoint(body, *args, use_reentrant=False, **kw)

    return run


def _mixer(p, h: torch.Tensor, cfg: ModelConfig, return_state: bool = False):
    """The SSD mixer over the residual stream's ``h``: on the rank's block
    of its heads where ``p`` is (the column-parallel input; under sequence
    parallelism the gathered sequence, and ``out_proj``'s reduce-scatter
    gives the rank's block of the output; the state, with
    ``return_state``, holds the rank's heads), else whole on every rank
    (under sequence parallelism on the gathered sequence, keeping its own
    block of the output; the state whole)."""
    split = on_model_block(p, "out_proj")
    hw = stream_inputs(h, split)[0]
    if return_state:
        y, st = mamba2_full(p, hw, cfg, return_state=True)
        return (y if split else stream_output(y)), st
    y = mamba2_full(p, hw, cfg)
    return y if split else stream_output(y)


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
        self._plan_specs = None  # (the plan in scope, its spec trees)

    # ------------------------------------------------------- distribution
    def set_mesh(self, mesh):
        """Install the layout hooks for ``mesh`` (a ``DeviceMesh``): each
        call runs in the mesh's scope (the expert-parallel moe, the layout
        pins of the residual stream, batch x ('pod','data') and sequence x
        'model', and of the logits' vocabulary x 'model').  Returns the
        model.  The parameters stay global unless a scope with a plan is
        open (the steps' ``param_shardings``)."""
        self._mesh = mesh
        return self

    def _specs(self):
        """The plan in scope as spec trees (the stacked ones without their
        layer dim), or None: no plan, the parameters are global."""
        from ..distributed.sharding import PartitionSpec

        plan = current_plan()
        if plan is None:
            return None
        if self._plan_specs is not None and self._plan_specs[0] is plan:
            return self._plan_specs[1]

        def strip(t, stacked):
            if isinstance(t, dict):
                return {k: strip(v, stacked) for k, v in t.items()}
            return PartitionSpec(*t.spec[1:]) if stacked else t.spec

        specs = {k: strip(v, k in ("blocks", "encoder"))
                 for k, v in plan.items()}
        self._plan_specs = (plan, specs)
        return specs

    def vocab_mesh(self):
        """The mesh in scope where the plan in scope computes the
        vocabulary on the rank's block over 'model' (the logits are then
        its block of the vocabulary), else None."""
        specs = self._specs()
        if specs is None:
            return None
        name = "table" if self.cfg.tie_embeddings else "head"
        mesh = current_mesh()
        return mesh if _on_model_block(name, specs["embed"][name],
                                       mesh) else None

    def _use(self, tree, specs, key: str):
        """``tree[key]`` as a layer computes with it (:meth:`_use_tree`;
        ``specs``: the plan's spec tree beside ``tree``, or None)."""
        if specs is None:
            return tree[key]
        return self._use_tree({key: tree[key]}, {key: specs[key]})[key]

    @staticmethod
    def _use_tree(tree, specs):
        """The global leaves as they are without a plan (``specs`` None),
        else the rank's blocks gathered on use (:func:`_gathered`)."""
        if specs is None:
            return tree
        return _gathered(tree, specs, current_mesh(), batch_axes())

    @staticmethod
    def _want(ndim: int, kv_split: bool = False,
              heads: bool = False) -> tuple:
        """The layout a step computes with a cache tensor of ``ndim`` dims
        in: this rank's batch block, and its kv heads (dim 2 of a K or V)
        where the plan splits them, or its SSD heads (dim 1 of a state)
        where the mixer runs on them."""
        from ..distributed.sharding import _entry

        want = [_entry(batch_axes())] + [None] * (ndim - 1)
        if kv_split:
            want[2] = "model"
        if heads:
            want[1] = "model"
        return tuple(want)

    def _kv_layout(self, spec: KVCache, attn_specs) -> CacheLayout:
        """An attention cache's :class:`CacheLayout` (``spec``: its specs
        under the cache plan; ``attn_specs``: the layer's attention
        specs)."""
        return CacheLayout(current_mesh(), tuple(spec.k),
                           self._want(4, _kv_split(attn_specs)))

    def _hold(self, entry, spec, attn_specs=None, back: bool = False,
              heads: bool = False):
        """One layer's cache ``entry`` (a ``KVCache``, an ``SSMCache`` or a
        cross K or V) made in a step's layout, as the cache plan holds it
        (``spec``: its specs there; None: no plan, as it is); ``back``: the
        other way.  ``heads``: the step holds an ``SSMCache``'s state as
        the rank's SSD heads over 'model' (the conv whole); between that
        and the plan's layout the state moves by all-to-alls over 'model'
        (``sharding.relayout``), never whole."""
        from ..distributed.sharding import relayout

        if spec is None:
            return entry
        mesh = current_mesh()
        split = attn_specs is not None and _kv_split(attn_specs)

        def one(t, sp, kv, on_heads=False):
            want = self._want(t.dim(), kv and split, on_heads)
            src, dst = (tuple(sp), want) if back else (want, tuple(sp))
            return relayout(t, mesh, src, dst).contiguous()

        if isinstance(entry, KVCache):
            return KVCache(one(entry.k, spec.k, True),
                           one(entry.v, spec.v, True),
                           one(entry.pos, spec.pos, False))
        if isinstance(entry, tuple):  # SSMCache
            return type(entry)(one(entry.conv, spec.conv, False),
                               one(entry.state, spec.state, False, heads))
        return one(entry, spec, True)

    def _scope(self):
        """The mesh's sharding scope for a model call, keeping the batch
        axes and the plans of an enclosing scope (a step's); no mesh set:
        the enclosing scope, if any, stays."""
        if self._mesh is None:
            return contextlib.nullcontext()
        return shard_scope(self._mesh, batch_axes=batch_axes(),
                           plan=current_plan(),
                           cache_plan=current_cache_plan())

    def _seq_split(self, s: int) -> bool:
        """Whether a stack over ``s`` positions holds its residual stream
        as each rank's block of the sequence over 'model' (the reference's
        ``seq -> model`` pin, ``_act_ns``): under a plan, on a 'model' dim
        of more than one rank, where ``s`` divides over it; else the
        stream is whole on every rank (``_act_ns_noseq``; decode, s = 1,
        never splits)."""
        from ..distributed.sharding import _axes

        mesh = current_mesh()
        if mesh is None or self._specs() is None:
            return False
        m = _axes(mesh).get("model", 1)
        return m > 1 and s > 1 and s % m == 0

    def _constrain(self, x, seq: bool):
        """The residual stream's layout at the start of a stack: this
        rank's block of the sequence over 'model' where ``seq``
        (:meth:`_seq_split`; its gradient gathered back), else ``x``."""
        if not seq:
            return x
        from ..distributed.sharding import split

        return split(x, current_mesh(), ("model",), 1)

    @staticmethod
    def _whole(x, seq: bool):
        """The residual stream whole again (its gradient this rank's
        block), where ``seq`` held a block of it."""
        if not seq:
            return x
        from ..distributed.sharding import gather

        return gather(x, current_mesh(), ("model",), 1, partial=False)

    @staticmethod
    def _last(x, seq: bool):
        """The last position's row ``[B, d]`` of the residual stream (held
        as a block of the sequence where ``seq``: the last rank's)."""
        if seq:
            from ..distributed.sharding import _gather

            x = _gather(x[:, -1:].contiguous(), current_mesh(), ("model",),
                        1)
        return x[:, -1]

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
        specs = self._specs()
        enc_out = None
        if cfg.family == "encdec":
            enc_out = self.encode(params, batch)
            x, positions = self._embed_decoder(params, batch, specs)
        else:
            x, positions = self._embed_inputs(params, batch, specs)
        seq = self._seq_split(x.shape[1])
        with seq_scope(seq):
            return self._stack(params, specs, self._constrain(x, seq),
                               positions, batch, remat, return_hidden,
                               enc_out, seq)

    def _stack(self, params, specs, x, positions, batch, remat: str,
               return_hidden: bool, enc_out, seq: bool):
        """The forward's layers, final norm and unembedding over the
        residual stream ``x`` (a block of the sequence where ``seq``)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        tiles = self._tiles(positions, batch)
        blocks = _layers(params["blocks"], cfg.n_layers)
        bspecs = specs and specs["blocks"]

        if cfg.family in _ATTN:
            windows = self.layer_windows()

            def layer(x, aux, bp, window):
                bp = self._use_tree(bp, bspecs)
                h = rmsnorm(x, bp["ln1"]["w"])
                x = residual_add(x, attn_full(bp["attn"], h, cfg, positions,
                                              window, tiles=tiles))
                h = rmsnorm(x, bp["ln2"]["w"])
                if cfg.family == "moe":
                    h, a = moe_apply(bp["moe"], h, cfg,
                                     bspecs and bspecs["moe"])
                    aux = aux + a
                else:
                    h = mlp(bp["mlp"], h, cfg)
                return residual_add(x, h), aux

            layer = _maybe_remat(layer, remat)
            for bp, window in zip(blocks, windows):
                x, aux = layer(x, aux, bp, window)
        elif cfg.family in ("ssm", "hybrid"):
            def ssm_layer(x, bp):
                bp = self._use_tree(bp, bspecs)
                h = rmsnorm(x, bp["ln"]["w"])
                return residual_add(x, _mixer(bp["ssm"], h, cfg))

            def shared_block(x):
                shared = self._use(params, specs, "shared")
                return self._shared_block(shared, x, positions, tiles)[0]

            ssm_layer = _maybe_remat(ssm_layer, remat)
            shared_block = _maybe_remat(shared_block, remat)
            for l, bp in enumerate(blocks):
                x = ssm_layer(x, bp)
                if cfg.family == "hybrid" and self._has_shared_attn(l):
                    x = shared_block(x)
        else:  # encdec
            def dec_layer(x, bp):
                bp = self._use_tree(bp, bspecs)
                return self._dec_layer(bp, x, positions, tiles, enc_out)[0]

            dec_layer = _maybe_remat(dec_layer, remat)
            for bp in blocks:
                x = dec_layer(x, bp)

        x = rmsnorm(x, self._use(params, specs, "final_norm")["w"])
        if return_hidden:
            return self._whole(x, seq), aux
        return self._constrain_logits(
            unembed(self._use(params, specs, "embed"), x, cfg)), aux

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
        specs = self._specs()
        x = batch["frames"].to(torch.bfloat16)
        b, s = x.shape[:2]
        if cfg.pos == "learned":
            x = x + self._use(params, specs, "embed")["pos"][:s][None]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        seq = self._seq_split(s)
        x = self._constrain(x, seq)
        with seq_scope(seq):
            for bp in _layers(params["encoder"], cfg.encoder_layers):
                bp = self._use_tree(bp, specs and specs["encoder"])
                h = rmsnorm(x, bp["ln1"]["w"])
                x = residual_add(x, attn_full(bp["attn"], h, cfg, positions,
                                              causal=False))
                h = rmsnorm(x, bp["ln2"]["w"])
                x = residual_add(x, mlp(bp["mlp"], h, cfg))
            x = rmsnorm(x, self._use(params, specs, "enc_norm")["w"])
        return self._whole(x, seq)

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
        specs = self._specs()
        cspecs = None
        if specs is not None:
            cspecs = current_cache_plan()
            if cspecs is None:
                raise ValueError("a decode step under a plan needs its "
                                 "cache's specs (shard_scope(cache_plan=))")
            cspecs = cspecs["layers"]
        pos = cache["len"]
        b = tokens.shape[0]
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=tokens.device)
        if cfg.m_rope_sections:
            positions = positions[None].expand(3, b, 1)

        emb = self._use(params, specs, "embed")
        x = embed(emb, tokens, cfg)
        if cfg.pos == "learned":
            x = x + emb["pos"][pos][None, None]
        del emb

        attend = self.attention
        windows = self.layer_windows()
        bspecs = specs and specs["blocks"]
        new_layers = []
        for l in range(cfg.n_layers):
            bp = self._use_tree(_at(params["blocks"], l), bspecs)
            lc = cache["layers"][l]
            cs = cspecs and cspecs[l]
            if cfg.family in _ATTN:
                h = rmsnorm(x, bp["ln1"]["w"])
                h, lc = attn_decode(
                    bp["attn"], h, lc, cfg, positions, windows[l],
                    attend=attend,
                    layout=cs and self._kv_layout(cs, bspecs["attn"]))
                x = residual_add(x, h)
                h = rmsnorm(x, bp["ln2"]["w"])
                if cfg.family == "moe":
                    h, _ = moe_apply(bp["moe"], h, cfg,
                                     bspecs and bspecs["moe"])
                else:
                    h = mlp(bp["mlp"], h, cfg)
                x = residual_add(x, h)
            elif cfg.family == "ssm":
                heads = on_model_block(bp["ssm"], "out_proj")
                h = rmsnorm(x, bp["ln"]["w"])
                h, st = mamba2_decode(
                    bp["ssm"], h, self._hold(lc, cs, back=True, heads=heads),
                    cfg)
                x = residual_add(x, h)
                lc = self._hold(st, cs, heads=heads)
            elif cfg.family == "hybrid":
                heads = on_model_block(bp["ssm"], "out_proj")
                h = rmsnorm(x, bp["ln"]["w"])
                h, st = mamba2_decode(
                    bp["ssm"], h, self._hold(lc["ssm"], cs and cs["ssm"],
                                             back=True, heads=heads), cfg)
                x = residual_add(x, h)
                lc = dict(lc, ssm=self._hold(st, cs and cs["ssm"],
                                             heads=heads))
                if "attn" in lc:
                    shared = self._use(params, specs, "shared")
                    h = rmsnorm(x, shared["ln1"]["w"])
                    h, _ = attn_decode(
                        shared["attn"], h, lc["attn"], cfg, positions,
                        attend=attend,
                        layout=cs and self._kv_layout(
                            cs["attn"], specs["shared"]["attn"]))
                    x = residual_add(x, h)
                    h = rmsnorm(x, shared["ln2"]["w"])
                    x = residual_add(x, mlp(shared["mlp"], h, cfg))
            else:  # encdec
                h = rmsnorm(x, bp["ln1"]["w"])
                h, _ = attn_decode(
                    bp["self_attn"], h, lc["self"], cfg, positions,
                    attend=attend,
                    layout=cs and self._kv_layout(cs["self"],
                                                  bspecs["self_attn"]))
                x = residual_add(x, h)
                h = rmsnorm(x, bp["ln_x"]["w"])
                x = residual_add(x, attn_cross(
                    bp["cross_attn"], h, lc["cross_k"], lc["cross_v"], cfg,
                    layout=cs and CacheLayout(
                        current_mesh(), tuple(cs["cross_k"]),
                        self._want(4, _kv_split(bspecs["cross_attn"])))))
                h = rmsnorm(x, bp["ln2"]["w"])
                x = residual_add(x, mlp(bp["mlp"], h, cfg))
            new_layers.append(lc)

        x = rmsnorm(x, self._use(params, specs, "final_norm")["w"])
        logits = unembed(self._use(params, specs, "embed"), x[:, 0], cfg)
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
        enc_len = batch.get("frames", tokens).shape[1]
        with self._scope():
            cspecs = self._prefill_cache_plan(b, max_len, enc_len)
            if cfg.family in _ATTN:
                return self._prefill_fused(params, batch, max_len, cspecs)
            if cfg.family in ("ssm", "hybrid"):
                return self._prefill_fused_ssm(params, batch, max_len,
                                               cspecs)
            return self._prefill_encdec(params, batch, max_len, enc_len,
                                        cspecs)

    def _prefill_cache_plan(self, b: int, max_len: int, enc_len: int):
        """The per-layer specs the primed cache is held under: the scope's
        cache plan, else ``cache_pspecs`` of the cache a global batch of
        ``b`` rows a rank makes; None without a plan."""
        from ..distributed.sharding import _axis_size, cache_pspecs

        if self._specs() is None:
            return None
        cspecs = current_cache_plan()
        if cspecs is None:
            mesh = current_mesh()
            gb = b * _axis_size(mesh, batch_axes())
            shapes = Model(self.cfg, "meta").init_cache(gb, max_len, enc_len)
            cspecs = cache_pspecs(shapes, mesh, gb)
        return cspecs["layers"]

    def _prefill_encdec(self, params, batch: dict, max_len: int,
                        enc_len: int, cspecs):
        """The encoder-decoder's prefill: the forward's last hidden state
        unembedded, then the cache (:meth:`_prime_cache`)."""
        hidden, _ = self.forward(params, batch, return_hidden=True)
        logits = unembed(self._use(params, self._specs(), "embed"),
                         hidden[:, -1], self.cfg)
        return logits, self._prime_cache(params, batch, max_len, cspecs)

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

    def _prefill_fused(self, params, batch: dict, max_len: int, cspecs):
        """dense/vlm/moe prefill: one pass computing the last logits AND the
        cache.  Each layer's K/V is laid into its cache as the layer ends
        (window layers keep only their last ``w`` positions, in rotating
        slot order); under a plan, as ``cspecs`` (its per-layer specs) hold
        it."""
        cfg = self.cfg
        specs = self._specs()
        bspecs = specs and specs["blocks"]
        s = batch["tokens"].shape[1]
        x, positions = self._embed_inputs(params, batch, specs)
        seq = self._seq_split(s)
        x = self._constrain(x, seq)
        pos1d = positions[0] if cfg.m_rope_sections else positions
        tiles = self._tiles(positions, batch)
        layers = []
        with seq_scope(seq):
            for l, w in enumerate(self.layer_windows()):
                bp = self._use_tree(_at(params["blocks"], l), bspecs)
                h = rmsnorm(x, bp["ln1"]["w"])
                out, k, v = attn_full(bp["attn"], h, cfg, positions, w,
                                      tiles=tiles, return_kv=True)
                x = residual_add(x, out)
                h = rmsnorm(x, bp["ln2"]["w"])
                if cfg.family == "moe":
                    hh, _ = moe_apply(bp["moe"], h, cfg,
                                      bspecs and bspecs["moe"])
                else:
                    hh = mlp(bp["mlp"], h, cfg)
                x = residual_add(x, hh)
                layers.append(self._hold(
                    self._cache_layout(k, v, pos1d,
                                       min(w, max_len) if w else max_len, s),
                    cspecs and cspecs[l], bspecs and bspecs["attn"]))
        x = rmsnorm(x, self._use(params, specs, "final_norm")["w"])
        logits = unembed(self._use(params, specs, "embed"),
                         self._last(x, seq), cfg)
        return logits, {"layers": tuple(layers), "len": s}

    def _prefill_fused_ssm(self, params, batch: dict, max_len: int, cspecs):
        """ssm/hybrid prefill: each layer's SSM state (and, for the hybrid,
        the shared block's K/V) taken as the layer runs."""
        cfg = self.cfg
        specs = self._specs()
        bspecs = specs and specs["blocks"]
        s = batch["tokens"].shape[1]
        x, positions = self._embed_inputs(params, batch, specs)
        seq = self._seq_split(s)
        x = self._constrain(x, seq)
        pos1d = positions[0] if cfg.m_rope_sections else positions
        tiles = self._tiles(positions, batch)
        layers = []
        with seq_scope(seq):
            for l in range(cfg.n_layers):
                bp = self._use_tree(_at(params["blocks"], l), bspecs)
                cs = cspecs and cspecs[l]
                h = rmsnorm(x, bp["ln"]["w"])
                y, st = _mixer(bp["ssm"], h, cfg, return_state=True)
                x = residual_add(x, y)
                heads = on_model_block(bp["ssm"], "out_proj")
                if cfg.family == "ssm":
                    layers.append(self._hold(st, cs, heads=heads))
                    continue
                entry = {"ssm": self._hold(st, cs and cs["ssm"],
                                           heads=heads)}
                if self._has_shared_attn(l):
                    x, k, v = self._shared_block(
                        self._use(params, specs, "shared"), x, positions,
                        tiles)
                    entry["attn"] = self._hold(
                        self._cache_layout(k, v, pos1d, max_len, s),
                        cs and cs["attn"], specs and specs["shared"]["attn"])
                layers.append(entry)
        x = rmsnorm(x, self._use(params, specs, "final_norm")["w"])
        logits = unembed(self._use(params, specs, "embed"),
                         self._last(x, seq), cfg)
        return logits, {"layers": tuple(layers), "len": s}

    def _prime_cache(self, params, batch, max_len: int, cspecs):
        """The encoder-decoder's cache: re-run the decoder stack to fill each
        layer's self K/V (at ``slot == pos % T``) and its cross K/V, as the
        reference's prefill does after its forward."""
        cfg = self.cfg
        specs = self._specs()
        bspecs = specs and specs["blocks"]
        enc_out = self.encode(params, batch)
        x, positions = self._embed_decoder(params, batch, specs)
        s = positions.shape[1]
        seq = self._seq_split(s)
        x = self._constrain(x, seq)
        tiles = self._tiles(positions, batch)
        layers = []
        for l in range(cfg.n_layers):
            bp = self._use_tree(_at(params["blocks"], l), bspecs)
            with seq_scope(seq):
                x, k, v, ek, ev = self._dec_layer(bp, x, positions, tiles,
                                                  enc_out)
            cs = cspecs and cspecs[l]
            cross = bspecs and bspecs["cross_attn"]
            layers.append({
                "self": self._hold(
                    self._cache_layout(k, v, positions, max_len, s),
                    cs and cs["self"], bspecs and bspecs["self_attn"]),
                "cross_k": self._hold(ek, cs and cs["cross_k"], cross),
                "cross_v": self._hold(ev, cs and cs["cross_v"], cross)})
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

    def _embed_inputs(self, params, batch: dict, specs=None):
        cfg = self.cfg
        tokens = batch["tokens"]
        if cfg.family == "encdec":
            return self._embed_decoder(params, batch, specs)
        b, s = tokens.shape
        emb = self._use(params, specs, "embed")
        x = embed(emb, tokens, cfg)
        if cfg.family == "vlm" and "vision_embeds" in batch:
            ve = batch["vision_embeds"].to(x.dtype)
            x = torch.cat([ve, x[:, ve.shape[1]:]], dim=1)
        positions = batch.get("positions")
        if positions is None:
            positions = _default_positions(tokens)
            if cfg.m_rope_sections:
                positions = positions[None].expand(3, b, s)
        if cfg.pos == "learned":
            x = x + emb["pos"][:s][None]
        return x, positions

    def _embed_decoder(self, params, batch: dict, specs=None):
        cfg = self.cfg
        tokens = batch["tokens"]
        emb = self._use(params, specs, "embed")
        x = embed(emb, tokens, cfg)
        if cfg.pos == "learned":
            x = x + emb["pos"][:tokens.shape[1]][None]
        return x, _default_positions(tokens)


def build_model(cfg: ModelConfig, device=None,
                attention: Callable = decode_attention) -> Model:
    return Model(cfg, device, attention)
