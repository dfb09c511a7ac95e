"""Batched serving driver: continuous-batching decode over a request queue
(the torch twin of the JAX package's ``repro/launch/serve.py``).

    python -m repro_torch.launch.serve --arch gemma-2b          # smoke config
    python -m repro_torch.launch.serve --arch gemma-2b --full   # published width

Every family of ``configs/registry.py`` serves (``--arch whisper-base``,
``mamba2-370m``, ...).  Requests arrive with different prompt lengths, are prefilled by stepping
their prompt through the decode step, join the in-flight decode batch, and
leave when they emit ``max_new`` tokens; slot reuse keeps the decode batch
full.  The encoder-decoder's cross K/V are ``max_len`` zero frames, as the
reference's.  The schedule is the reference's exactly: the same numpy prompt queue
from ``seed``, every slot stepping together on one shared cache position,
and a refilled slot keeping the previous request's cache rows.  Each
layer's attention runs through kernel B5 on the card.

Runs on the CUDA device unless ``device`` says otherwise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .._device import resolve_device
from ..configs import get_config, get_smoke
from ..models import build_model
from .steps import make_decode_step

__all__ = ["main", "serve_batch"]


@torch.inference_mode()
def serve_batch(
    arch: str,
    *,
    smoke: bool = True,
    n_requests: int = 16,
    max_batch: int = 4,
    max_new: int = 16,
    max_len: int = 128,
    seed: int = 0,
    device=None,
    params=None,
) -> dict:
    """Serve ``n_requests`` random prompts; returns the reference's dict
    (``arch``, ``requests``, ``tokens``, ``decode_steps``, ``seconds``, and
    each request's first 8 generated tokens under ``outputs``).

    ``params`` (a tree on ``device``, e.g. carried across from the JAX
    package by ``repro_torch.convert.model_params``) replaces the model's
    own ``init`` from a generator seeded 0."""
    device = resolve_device(device)
    cfg = get_smoke(arch) if smoke else get_config(arch)
    model = build_model(cfg, device)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(seed)

    # request queue: (id, prompt tokens)
    queue = [
        (i, rng.integers(1, cfg.vocab, size=int(rng.integers(4, max_len // 2))))
        for i in range(n_requests)
    ]
    decode = make_decode_step(model, sample=False)

    # Slots: continuous batching over a fixed decode batch.
    cache = model.init_cache(max_batch, max_len, enc_len=max_len)
    slot_req = [-1] * max_batch
    slot_remaining = [0] * max_batch
    done: dict = {}
    steps = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()

    def step(tok: np.ndarray):
        """One decode step of every slot; returns the next tokens [B] on the
        device (read on the host only where the serve loop needs them)."""
        nonlocal cache, steps
        tok = torch.as_tensor(tok, dtype=torch.long)
        if device.type == "cuda":
            # pinned and asynchronous: a pageable copy would wait for the
            # device on every step
            tok = tok.pin_memory().to(device, non_blocking=True)
        nxt, _, cache = decode(params, cache, tok.to(device))
        steps += 1
        return nxt[:, 0]

    def fill_slot(s):
        if not queue:
            return False
        rid, prompt = queue.pop(0)
        # prefill this slot by stepping through the prompt (slot-local
        # decode, as the reference); the prompt's outputs are never read, so
        # these steps do not wait for the device
        slot_req[s] = rid
        slot_remaining[s] = max_new
        done[rid] = []
        for t in prompt:
            tok = np.zeros((max_batch, 1), np.int64)
            tok[s, 0] = t
            step(tok)
        return True

    # This single-cache design steps every slot together; empty slots
    # decode a pad token whose output is discarded.
    for s in range(max_batch):
        fill_slot(s)
    active = sum(r >= 0 for r in slot_req)
    while active:
        tok = np.zeros((max_batch, 1), np.int64)
        for s in range(max_batch):
            if slot_req[s] >= 0 and done[slot_req[s]]:
                tok[s, 0] = done[slot_req[s]][-1]
            else:
                tok[s, 0] = 1
        nxt = step(tok).cpu().numpy()
        for s in range(max_batch):
            rid = slot_req[s]
            if rid < 0:
                continue
            done[rid].append(int(nxt[s]))
            slot_remaining[s] -= 1
            if slot_remaining[s] <= 0:
                slot_req[s] = -1
                fill_slot(s)
        active = sum(r >= 0 for r in slot_req)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(v) for v in done.values())
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else str(device))
    print(
        f"[serve] {arch}: {n_requests} requests, {total_tokens} tokens, "
        f"{steps} decode steps in {dt:.1f}s "
        f"({total_tokens / max(dt, 1e-9):.1f} tok/s, "
        f"{dt / max(steps, 1) * 1e3:.2f} ms/step on {where})"
    )
    return {
        "arch": arch,
        "requests": n_requests,
        "tokens": total_tokens,
        "decode_steps": steps,
        "seconds": dt,
        "outputs": {k: v[:8] for k, v in done.items()},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    res = serve_batch(
        args.arch,
        smoke=not args.full,
        n_requests=args.requests,
        max_batch=args.batch,
        max_new=args.max_new,
        device=args.device,
    )
    return 0 if res["tokens"] > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
