"""End-to-end training driver (the torch twin of the JAX package's
``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch gemma-2b --steps 300
    python -m repro_torch.launch.train --arch gemma-2b --inject-failures
    python -m repro_torch.launch.train --arch mamba2-370m --device cpu

trains the reduced (smoke) configuration of any architecture of the
registry on the synthetic token pipeline, with checkpoints, resumption from
the newest complete one, optional fault injection (a crash at a third of
the steps and a straggling step at two thirds) and optional int8 gradient
compression: the reference's production loop at small scale.  ``--full``
trains the published configuration.  Runs on the CUDA device unless
``--device`` (or ``device=``) says otherwise.  The step updates the
parameters and moments in place, as the reference's jitted step donates
them.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import torch

from .._device import resolve_device
from ..checkpoint import CheckpointManager
from ..configs import TrainConfig, get_config, get_smoke
from ..data import TokenStream
from ..distributed.fault import FailurePlan, Supervisor
from ..models import build_model
from ..optim import adamw_init
from .steps import make_train_step

__all__ = ["main", "train_loop"]


def _default_ckpt_dir() -> str:
    return str(Path(tempfile.gettempdir()) / "repro_torch_ckpt")


def train_loop(
    arch: str,
    *,
    smoke: bool = True,
    steps: int = 300,
    batch: int = 8,
    seq: int = 128,
    microbatches: int = 1,
    grad_compress: bool = False,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    inject_failures: bool = False,
    log_every: int = 10,
    device=None,
) -> dict:
    """Train ``arch`` for ``steps`` steps under the :class:`Supervisor`;
    returns the reference's dict (``arch``, ``loss_first10``,
    ``loss_last10``, ``steps``, ``restarts``, ``straggler_events``,
    ``seconds``).  ``ckpt_dir`` defaults to ``repro_torch_ckpt`` under the
    temporary directory; a run resumes from the newest checkpoint there."""
    device = resolve_device(device)
    cfg = get_smoke(arch) if smoke else get_config(arch)
    model = build_model(cfg, device)
    tc = TrainConfig(microbatches=microbatches, grad_compress=grad_compress,
                     warmup_steps=min(50, steps // 4))
    stream = TokenStream(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    mgr = CheckpointManager(ckpt_dir or _default_ckpt_dir(), keep=2)

    def init_state(scale: float):
        params = model.init(torch.Generator(device=device).manual_seed(0))
        return {"params": params, "opt": adamw_init(params)}

    def make_step(scale: float):
        step = make_train_step(model, tc, donate=True)

        def run(state, batch_np):
            b = {k: torch.from_numpy(v).to(device)
                 for k, v in batch_np.items() if k in ("tokens", "labels")}
            params, opt, metrics = step(state["params"], state["opt"], b)
            return {"params": params, "opt": opt}, metrics

        return run

    plan = (FailurePlan({steps // 3: "crash", 2 * steps // 3: "straggle"})
            if inject_failures else None)
    sup = Supervisor(
        mgr,
        make_step,
        init_state,
        lambda s: stream.batch(s),
        checkpoint_every=ckpt_every,
        plan=plan,
    )

    losses = []
    t0 = time.time()
    # Wrap make_step to record losses without touching the supervisor
    orig_make = sup.make_step

    def make_step_logged(scale):
        inner = orig_make(scale)

        def run(state, b):
            state, m = inner(state, b)
            losses.append(float(m["loss"]))
            if len(losses) % log_every == 0:
                print(
                    f"[train] step={len(losses):4d} loss={losses[-1]:.4f} "
                    f"lr={float(m['lr']):.2e} "
                    f"gnorm={float(m['grad_norm']):.2f}",
                    flush=True,
                )
            return state, m

        return run

    sup.make_step = make_step_logged
    state, report = sup.run(steps)
    dt = time.time() - t0
    first = sum(losses[:10]) / max(len(losses[:10]), 1)
    last = sum(losses[-10:]) / max(len(losses[-10:]), 1)
    print(
        f"[train] {arch}: {report.steps_run} steps in {dt:.1f}s | "
        f"loss {first:.3f} -> {last:.3f} | restarts={report.restarts} "
        f"stragglers={report.straggler_events}"
    )
    return {
        "arch": arch,
        "loss_first10": first,
        "loss_last10": last,
        "steps": report.steps_run,
        "restarts": report.restarts,
        "straggler_events": report.straggler_events,
        "seconds": dt,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="the published configuration")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_torch_ckpt "
                         "under the temporary directory)")
    ap.add_argument("--inject-failures", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    res = train_loop(
        args.arch,
        smoke=not args.full,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        microbatches=args.microbatches,
        grad_compress=args.grad_compress,
        ckpt_dir=args.ckpt_dir,
        inject_failures=args.inject_failures,
        device=args.device,
    )
    ok = res["loss_last10"] < res["loss_first10"]
    print(f"[train] loss decreased: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
