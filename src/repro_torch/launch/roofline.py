"""Roofline terms of a step on the card: the torch twin of the JAX package's
``repro/launch/roofline.py``.

Per (arch x shape) on the single-pod 16x16 mesh, three terms in seconds:

  compute    = FLOPs_global / (chips x the card's dense bf16 peak)
               FLOPs from a record's probe (the port's dry run,
               ``launch/dryrun.py``, counts them with ``FlopCounterMode``
               over the unpartitioned step on meta tensors).
  memory     = two columns: mem_hlo (the probe's bytes accessed, an upper
               bound) and mem_model (:func:`_model_traffic`, the analytic
               HBM traffic model the bottleneck call uses), over the card's
               memory rate.
  collective = each mesh dim's per-card link bytes over the rate of the
               links its rings cross (:func:`_coll_seconds`): NVLink 4 for a
               dim whose groups stay within one node of 8 cards, the
               node's network for one that leaves it.

Also reported: MODEL_FLOPS = 6·N·D (train dense) / 6·N_active·D (MoE) plus
the exact causal attention term (:func:`model_flops`), and MODEL_FLOPS /
probe FLOPs (usefulness).

:func:`model_flops` and :func:`_model_traffic` are arithmetic over the
configurations, as in the reference.  :func:`roofline_terms` and
:func:`analyze` read dry-run records of the reference's shape: the port's
(``experiments/dryrun_torch``), or the reference's, which carry no
per-dim bytes and are put on NVLink whole, as the reference does.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..configs import SHAPES, get_config

__all__ = ["analyze", "main", "model_flops", "roofline_terms", "to_markdown"]

# NVIDIA H100 SXM5 80GB HBM3 at its 700 W power limit (a card set lower
# runs slower under load):
PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12  # B/s of device memory
LINK_BW = 25e9  # B/s one way on one NVLink 4 link
ICI_LINKS = 18  # NVLink 4 links per card (450 GB/s one way in all)
NODE_CARDS = 8  # cards of one NVLink domain (an HGX / DGX H100 node)
# B/s one way a card over the nodes' network: one 400 Gb/s NDR InfiniBand
# port (ConnectX-7) a card, eight a node, as in a DGX H100
NET_BW = 50e9
CHIPS = 256  # single-pod 16x16
MSIZE = 16  # the mesh's model dim


def _windows(cfg) -> list:
    """Per-layer sliding windows (``Model.layer_windows``, on the meta
    device: no card needed)."""
    from ..models.model import Model

    return Model(cfg, "meta").layer_windows()


def model_flops(arch: str, shape_name: str, *, cfg=None,
                shape=None) -> float:
    """Analytic useful FLOPs per step (dense 6ND conventions + exact
    causal/window attention term).  ``cfg`` / ``shape`` stand in for the
    registry's (a depth-cut configuration, a shape outside ``SHAPES``)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    n_active = cfg.active_param_count()
    b, s = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        tokens, mult = b * s, 6  # fwd 2 + bwd 4
    elif shape.kind == "prefill":
        tokens, mult = b * s, 2
    else:  # decode: one token per sequence
        tokens, mult = b, 2
    total = mult * n_active * tokens

    # attention score+value flops (per layer: 2*2*B*Sq*Skv*H*hd, causal /2)
    if cfg.has_attention:
        h, hd = cfg.n_heads, cfg.head_dim
        if cfg.family == "hybrid":
            layers = [0] * (cfg.n_layers // max(cfg.attn_every, 1))
        else:
            layers = _windows(cfg)
        attn = 0.0
        for w in layers:
            if shape.kind == "decode":
                skv = min(w, s) if w else s
                attn += 4 * b * 1 * skv * h * hd
            else:
                skv_eff = (min(w, s) if w else s) if w else s
                # causal band: sum over rows of min(row+1, window) ~= s*skv/2
                band = (s * skv_eff - (skv_eff * (skv_eff - 1)) / 2 if w
                        else s * s / 2)
                attn += 4 * b * band * h * hd
        if cfg.family == "encdec":
            if shape.kind == "decode":
                # decode reruns neither the encoder nor full self-attention;
                # per token: cross attention over the s-long encoder memory
                attn += cfg.n_layers * 4 * b * 1 * s * h * hd
            else:
                # encoder (non-causal, full) + decoder cross attention
                attn += cfg.encoder_layers * 4 * b * s * s * h * hd
                attn += cfg.n_layers * 4 * b * s * s * h * hd
        attn *= {"train": 3, "prefill": 1, "decode": 1}[shape.kind]
        total += attn
    return total


def _model_traffic(rec: dict) -> float:
    """Analytic per-device HBM bytes per step (documented estimate).

    train:   3x param sweep (fwd + bwd + remat-full recompute) over the
             model-shard x data-gathered weights (2N/msize bf16), grads
             f32 write+read (8N/chips), opt m/v read+write (16N/chips),
             remat-saved residuals (L x B_loc x S_loc x D x 2 x 2).
    prefill: 1x param sweep + KV cache write.
    decode:  param sweep (all weights touch HBM once per step; FSDP-
             gathered => 2N/msize) + live KV/SSM cache read + logits.
    """
    arch, shape_name = rec["arch"], rec["shape"]
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    msize = MSIZE
    n = rec["params"]
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    p_sweep = 2 * n / msize  # bf16, TP-sharded, FSDP-gathered
    if shape.kind == "train":
        grads_opt = (8 + 16) * n / CHIPS
        b_loc, s_loc = max(b // 16, 1), max(s // msize, 1)
        acts = cfg.n_layers * b_loc * s_loc * d * 2 * 2
        logits = b_loc * s * cfg.vocab_padded / msize * 4 * 2
        return 3 * p_sweep + grads_opt + acts + logits
    if shape.kind == "prefill":
        b_loc = max(b // 16, 1)
        kv_write = (
            cfg.n_layers * b_loc * s * cfg.n_kv_heads * cfg.head_dim * 2 * 2
            if cfg.has_attention
            else 0
        )
        return p_sweep + kv_write / msize + b_loc * s * d * 2 * 2
    # decode
    cache = 0.0
    if cfg.family in ("dense", "vlm", "moe", "encdec"):
        for w in _windows(cfg):
            t_live = min(w, s) if w else s
            cache += b * t_live * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    elif cfg.family == "hybrid":
        cache += (cfg.n_layers // max(cfg.attn_every, 1)) * (
            b * s * cfg.n_kv_heads * cfg.head_dim * 2 * 2
        )
        cache += cfg.n_layers * b * cfg.d_inner * cfg.ssm_state * 4
    else:  # ssm
        cache += cfg.n_layers * b * cfg.d_inner * cfg.ssm_state * 4
    return p_sweep + cache / CHIPS + b * cfg.vocab_padded * 4 / CHIPS


def _coll_seconds(coll: dict, mesh: str) -> float:
    """Seconds of a record's collectives on one card.  Per mesh dim
    (``by_dim``; the mesh ``"16x16"`` or ``"2x16x16"``, ranks laid out
    row-major over it, 8 cards a node): a dim whose groups span at most one
    node (its size times the sizes of the dims after it <= 8) moves its
    link bytes over NVLink 4 (18 x 25 GB/s), one that spans more over the
    network (:data:`NET_BW`).  On the (16, 16) mesh both dims leave the
    node.  A record without ``by_dim`` (the reference's) is put on NVLink
    whole."""
    by_dim = coll.get("by_dim")
    if not by_dim:
        link_b = coll.get("total_link_bytes", coll.get("total_bytes", 0))
        return link_b / (ICI_LINKS * LINK_BW)
    sizes = [int(n) for n in mesh.split("x")]
    names = ("pod", "data", "model")[3 - len(sizes):]
    span = {}
    for i, name in enumerate(names):
        span[name] = 1
        for size in sizes[i:]:
            span[name] *= size
    total = 0.0
    for dim, row in by_dim.items():
        inside = span.get(dim, NODE_CARDS + 1) <= NODE_CARDS
        total += row["link_bytes"] / (ICI_LINKS * LINK_BW if inside
                                      else NET_BW)
    return total


def roofline_terms(rec: dict) -> dict:
    """The three terms (seconds) + bottleneck for one dry-run record."""
    probe = rec.get("probe", {})
    flops = probe.get("flops")
    fallback = False
    if not flops:
        flops = rec["cost"].get("flops", 0.0) * rec["devices"]  # loops-once!
        fallback = True
    compute_s = flops / (CHIPS * PEAK_FLOPS)
    mem_hlo_s = probe.get("bytes accessed", 0.0) / (CHIPS * HBM_BW)
    mem_model_s = _model_traffic(rec) / HBM_BW
    coll = rec.get("collectives", {})
    coll_s = _coll_seconds(coll, rec.get("mesh", "16x16"))
    mf = model_flops(rec["arch"], rec["shape"])
    terms = {"compute": compute_s, "memory": mem_model_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    bound_s = max(terms.values())
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "compute_s": compute_s,
        "mem_hlo_s": mem_hlo_s,
        "mem_model_s": mem_model_s,
        "coll_s": coll_s,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops": flops,
        "useful_ratio": mf / flops if flops else 0.0,
        "roofline_fraction": compute_s / bound_s if bound_s else 0.0,
        "flops_fallback": fallback,
        "temp_gib": rec["memory"]["temp_size_in_bytes"] / 2**30,
        "coll_by_op": {
            k: v
            for k, v in coll.items()
            if isinstance(v, dict) and v.get("count")
        },
    }


_HINTS = {
    "compute": "compute-bound: raise tensor-core efficiency (tiling, fewer "
               "recompute FLOPs, causal-aware kernel)",
    "memory": "HBM-bound: cut parameter/cache sweeps (quantized KV, fused "
              "gathers, larger per-step batch)",
    "collective": "link-bound: reshard to kill per-step gathers "
                  "(serving-mode weight layout, bf16 collectives, overlap)",
}


def analyze(dryrun_dir: str, mesh: str = "pod") -> list[dict]:
    """Roofline rows of every ``*__<mesh>.json`` dry-run record in
    ``dryrun_dir`` with status ok (the reference's record shape)."""
    rows = []
    for f in sorted(Path(dryrun_dir).glob(f"*__{mesh}.json")):
        rec = json.loads(f.read_text())
        if rec.get("status") != "ok":
            continue
        r = roofline_terms(rec)
        r["hint"] = _HINTS[r["dominant"]]
        rows.append(r)
    return rows


def to_markdown(rows: list[dict]) -> str:
    out = [
        "| arch | shape | compute s | mem(model) s | mem(HLO) s | coll s | "
        "dominant | useful 6ND/HLO | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} | "
            f"{r['mem_model_s']:.4f} | {r['mem_hlo_s']:.4f} | "
            f"{r['coll_s']:.4f} | {r['dominant']} | "
            f"{r['useful_ratio']:.2f} | {r['roofline_fraction']:.2f} |"
        )
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dryrun-dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default="pod")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    rows = analyze(args.dryrun_dir, args.mesh)
    if args.json:
        print(json.dumps(rows, indent=1, default=float))
    else:
        print(to_markdown(rows))
        for r in rows:
            print(f"  {r['arch']} x {r['shape']}: {r['hint']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
