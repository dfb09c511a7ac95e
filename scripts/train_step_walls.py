"""ms a step of gemma-2b's train step at full width (B=2, S=1,024, the
lm_train and lm_mesh (b) shape of ``chip_smoke.py``), without a plan and
blocked under ``param_shardings`` on a one-rank NCCL mesh, for comparing
two trees on one card.

Each step is built and run once from one seeded state, then timed with
CUDA events over ``--steps`` steps of ``sharded_batches``; in the order
plain, blocked, blocked, plain.  One JSON line, after the card's name and
power limit.

    python3 scripts/train_step_walls.py [--src DIR] [--tag NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported, so two
checkouts compare in one call: run them in turn, A B B A.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("train_step_walls: no CUDA device", file=sys.stderr)
        return 2
    import torch.distributed as dist
    from torch.utils._pytree import tree_map

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import TokenStream, sharded_batches
    from repro_torch.distributed.sharding import (batch_pspec,
                                                  param_shardings,
                                                  shard_params)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"{args.tag}: repro_torch from {args.src} on {smi}", flush=True)
    store = ROOT / "build" / "mesh" / f"train_step_walls_{args.tag}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    mesh = make_local_mesh(1, 1, init_file=str(store))
    try:
        cfg = get_config("gemma-2b")
        model = build_model(cfg, "cuda")
        params0 = model.init(torch.Generator(device="cuda").manual_seed(0))
        plan = param_shardings(model.logical_axes(), params0, mesh)
        stream = TokenStream(vocab=cfg.vocab, seq_len=1024, global_batch=2)
        batches = sharded_batches(stream, mesh, batch_pspec(2, mesh))
        feed = [next(batches) for _ in range(args.steps + 1)]
        row = {"tag": args.tag}
        for name in ("plain", "blocked", "blocked2", "plain2"):
            params = tree_map(lambda t: t.clone(), params0)
            if name.startswith("blocked"):
                step = make_train_step(model, TrainConfig(),
                                       param_shardings=plan, donate=True)
                params = shard_params(params, plan)
            else:
                step = make_train_step(model, TrainConfig(), donate=True)
            opt = adamw_init(params)
            params, opt, _ = step(params, opt, feed[0])
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for batch in feed[1:]:
                params, opt, _ = step(params, opt, batch)
            stop.record()
            torch.cuda.synchronize()
            row[name] = start.elapsed_time(stop) / args.steps
            del params, opt, step
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
