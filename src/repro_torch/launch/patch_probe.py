"""Recompute the FLOP probe of existing dry-run records: the torch twin of
the JAX package's ``repro/launch/patch_probe.py``.

The probe is mesh-independent (the unpartitioned step of the global batch
on meta tensors, its layers unrolled), so when only the probe's method
changes, the records' traces need not be redone.  ``main`` rewrites the
``probe`` field in place for every matching record.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

__all__ = ["main", "probe_cell"]


def probe_cell(arch: str, shape_name: str, *, cfg=None, shape=None) -> dict:
    """``flops``, ``bytes accessed`` and ``probe_s`` of one cell's step on
    the meta device (``cfg`` / ``shape`` stand in for the registry's):
    train with ``TrainConfig(microbatches=1, remat="full")``, prefill,
    and decode on a full cache at position ``seq_len - 1``."""
    import torch  # noqa: F401  (the meta tensors below)
    from torch.utils.flop_counter import FlopCounterMode

    from ..configs import SHAPES, TrainConfig, get_config
    from ..models import build_model
    from .dryrun import _BytesAccessed
    from .specs import cache_specs, input_specs, state_specs
    from .steps import make_decode_step, make_prefill_step, make_train_step

    shape = shape or SHAPES[shape_name]
    cfg = cfg or get_config(arch)
    pmodel = build_model(cfg, "meta")
    params_s, opt_s, _ = state_specs(pmodel)
    batch = input_specs(cfg, shape)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, _BytesAccessed() as acc:
        if shape.kind == "train":
            step = make_train_step(
                pmodel, TrainConfig(microbatches=1, remat="full"),
                unroll=True)
            step(params_s, opt_s, batch)
        elif shape.kind == "prefill":
            make_prefill_step(pmodel, unroll=True)(params_s, batch)
        else:
            cache = dict(cache_specs(pmodel, shape), len=shape.seq_len - 1)
            make_decode_step(pmodel)(params_s, cache, batch["tokens"])
    return {"flops": float(flops.get_total_flops()),
            "bytes accessed": float(acc.bytes),
            "probe_s": round(time.perf_counter() - t0, 2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dryrun-dir", default="experiments/dryrun_torch")
    ap.add_argument("--kind", default="prefill",
                    help="substring of shape name")
    args = ap.parse_args(argv)
    d = Path(args.dryrun_dir)
    cache: dict = {}
    for f in sorted(d.glob("*.json")):
        rec = json.loads(f.read_text())
        if rec.get("status") != "ok" or args.kind not in rec["shape"]:
            continue
        key = (rec["arch"], rec["shape"])
        if key not in cache:
            print(f"[probe] {key[0]} x {key[1]} ...", flush=True)
            try:
                cache[key] = probe_cell(*key)
            except Exception as e:
                print(f"[probe] {key}: FAILED {e}")
                continue
        rec["probe"] = cache[key]
        f.write_text(json.dumps(rec, indent=1))
        print(f"[probe] {f.name}: flops={cache[key].get('flops', 0):.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
