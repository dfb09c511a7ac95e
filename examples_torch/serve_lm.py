"""Serve a model with batched requests (continuous batching) on the
PyTorch port (the twin of ``examples/serve_lm.py``).

    PYTHONPATH=src python examples_torch/serve_lm.py [--arch gemma3-4b] [--full] [--device cpu]

gemma3's 5:1 local:global layout makes the SEM point concrete: five of
every six layers keep only a window-sized rotating KV cache, so long
contexts cost a fraction of the full-attention bytes.  The reduced (smoke)
configuration serves by default; ``--full`` serves the published width and
depth (gemma3-4b: 34 layers), as ``python -m repro_torch.launch.serve
--full`` does.  Each layer's decode attention runs through the
hand-written CUDA kernel on the card.  Runs on the CUDA device unless
``--device`` says otherwise.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import resolve_device
from repro_torch.launch.serve import serve_batch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="the published configuration")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    res = serve_batch(
        args.arch, smoke=not args.full, n_requests=args.requests,
        max_batch=4, max_new=8, device=device,
    )
    for rid, toks in sorted(res["outputs"].items())[:4]:
        print(f"request {rid}: {toks}")
    return 0 if res["tokens"] > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
