"""End-to-end driver on the PyTorch port: train a gemma-family model (the
smoke configuration of gemma-2b: 2 layers at d_model 64) for a few hundred
steps on the synthetic pipeline, with checkpointing, a mid-run simulated
crash + restore, and loss-curve verification (the twin of
``examples/train_lm.py``).

    PYTHONPATH=src python examples_torch/train_lm.py [--steps 300] [--device cpu]

Runs on the CUDA device unless ``--device`` says otherwise.  Checkpoints go
to ``repro_torch_example_ckpt`` under the temporary directory unless
``--ckpt`` names another; the directory is emptied first.
"""
import argparse
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import resolve_device
from repro_torch.launch.train import train_loop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--ckpt", default=str(Path(tempfile.gettempdir())
                                          / "repro_torch_example_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    shutil.rmtree(args.ckpt, ignore_errors=True)

    res = train_loop(
        args.arch,
        smoke=True,  # the reduced config of the same family
        steps=args.steps,
        batch=8,
        seq=128,
        microbatches=2,
        ckpt_dir=args.ckpt,
        ckpt_every=50,
        inject_failures=True,  # crash at 1/3, straggler at 2/3 — must recover
        device=device,
    )
    ok = res["loss_last10"] < res["loss_first10"] and res["restarts"] >= 1
    print(
        f"loss {res['loss_first10']:.3f} -> {res['loss_last10']:.3f}; "
        f"survived {res['restarts']} restart(s): {'OK' if ok else 'FAIL'}"
    )
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
