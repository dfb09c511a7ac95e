"""Time of B5 (the decode-attention kernel) through its wrapper, for
comparing two trees on one card.

At ``chip_smoke.py``'s lm_time shapes: the serve shape (B=4, KV=1, G=8,
hd=256, T=1024, full caches, 18 copies taken in turn, as the serve loop
finds them cold in L2) and decode_32k (B=128, T=32,768 at gemma-2b's
heads).  For each: ms a call of ``decode_attention`` as an event loop over
``--reps`` calls (``chip_smoke.cuda_ms``, the kernels line's ``ms``),
repeated ``--repeats`` times, and the device ms of one call in a CUDA
graph (``chip_smoke.device_ms``).  One JSON line a shape, after the card's
name and power limit.

    python3 scripts/decode_walls.py [--src DIR] [--tag NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (B5 is
built from that tree's ``csrc``), so two checkouts compare in one call: run
them in turn, A B B A.
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
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))

    import torch

    if not torch.cuda.is_available():
        print("decode_walls: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from chip_smoke import _attn_case, attn_bound, cuda_ms, device_ms
    from repro_torch.kernels import decode_attn as tda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"{args.tag}: repro_torch from "
          f"{Path(repro_torch.__file__).parent} on {smi}", flush=True)
    bf16 = torch.bfloat16
    shapes = (("serve", 4, 1024, 18), ("decode_32k", 128, 32768, 1))
    for name, b, t, copies in shapes:
        sets = [_attn_case("cuda", torch, b, 1, 8, 256, t, bf16, (t,) * b,
                           seed=100 + i) for i in range(copies)]
        turn = [0]

        def call():
            turn[0] += 1
            return tda.decode_attention(*sets[turn[0] % len(sets)])

        ms = [cuda_ms(call, reps=args.reps) for _ in range(args.repeats)]
        q, k, _, pos, cur = sets[0]
        bound_ms, bound_by = attn_bound(q, k, pos, cur, 0, torch)
        print(json.dumps({"tag": args.tag, "shape": name, "b": b, "t": t,
                          "copies": copies, "ms": ms,
                          "device_ms": device_ms(call, torch),
                          "bound_ms": bound_ms, "bound_by": bound_by}),
              flush=True)
        del sets, q, k, pos, cur
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
