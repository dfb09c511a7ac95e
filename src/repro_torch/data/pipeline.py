"""Deterministic synthetic token pipeline: documents -> packing -> device
batches (torch port of ``repro.data.pipeline``; the generator and the
packing are the reference's numpy code, so every batch is byte-identical).

  * **Determinism / resumability** — every batch is a pure function of
    ``(seed, step)``: a restarted job resumes mid-epoch from the checkpoint
    step with byte-identical data (no iterator state to persist).
  * **Packing** — variable-length synthetic "documents" are packed into
    fixed ``seq_len`` rows; positions restart at document boundaries so the
    attention masks (``models/flash.py`` keys on positions) respect packing.
  * **Sharding** — ``sharded_batches`` puts each batch on one device, or,
    over a mesh, gives each rank the block of every batch that the
    reference's ``NamedSharding(mesh, batch_spec)`` puts on the device at
    the same mesh coordinates.

The generator is a mixture of Zipf-distributed unigrams with a short
Markov flavor — enough structure that cross-entropy visibly drops within a
few hundred steps of ``python -m repro_torch.launch.train``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["SyntheticLM", "TokenStream", "pack_documents", "sharded_batches"]


def pack_documents(
    docs: list, seq_len: int, pad_id: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Greedy-pack documents into rows of ``seq_len``.

    Returns (tokens [rows, seq_len], positions [rows, seq_len]) where
    positions restart at 0 on each document boundary (packing-aware
    attention masking).
    """
    rows, prows = [], []
    cur, curp = [], []
    for d in docs:
        d = list(d)
        while d:
            space = seq_len - len(cur)
            take = d[:space]
            cur.extend(take)
            curp.extend(range(len(take)))
            d = d[space:]
            if len(cur) == seq_len:
                rows.append(cur)
                prows.append(curp)
                cur, curp = [], []
    if cur:
        pad = seq_len - len(cur)
        rows.append(cur + [pad_id] * pad)
        prows.append(curp + list(range(len(curp), seq_len)))
    return np.asarray(rows, np.int32), np.asarray(prows, np.int32)


@dataclasses.dataclass
class SyntheticLM:
    """Learnable synthetic language: Zipf unigrams + first-order structure."""

    vocab: int
    zipf_a: float = 1.3
    markov_jump: int = 7  # next token ~ (prev * jump + noise) mod vocab

    def sample_doc(self, rng: np.random.Generator, length: int) -> np.ndarray:
        base = rng.zipf(self.zipf_a, size=length).astype(np.int64)
        tok = np.minimum(base, self.vocab - 1)
        # mix in deterministic structure the model can learn
        structured = (np.roll(tok, 1) * self.markov_jump + 3) % self.vocab
        use = rng.random(length) < 0.5
        tok = np.where(use, structured, tok)
        tok[0] = 1  # BOS-ish
        return tok.astype(np.int32)


@dataclasses.dataclass
class TokenStream:
    """Stateless stream: ``batch(step)`` is pure in (seed, step)."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 384

    def batch(self, step: int) -> dict:
        """tokens/labels/positions (int32 numpy) for one step — next-token
        prediction with packing."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, 0xDA7A])
        )
        lang = SyntheticLM(self.vocab)
        need = self.global_batch * (self.seq_len + 1)
        docs, total = [], 0
        while total < need:
            ln = int(rng.geometric(1.0 / self.mean_doc_len)) + 8
            d = lang.sample_doc(rng, ln)
            docs.append(d)
            total += len(d)
        rows, pos = pack_documents(docs, self.seq_len + 1)
        rows = rows[: self.global_batch]
        pos = pos[: self.global_batch]
        if rows.shape[0] < self.global_batch:  # pad short final batch
            reps = -(-self.global_batch // rows.shape[0])
            rows = np.tile(rows, (reps, 1))[: self.global_batch]
            pos = np.tile(pos, (reps, 1))[: self.global_batch]
        return {
            "tokens": rows[:, :-1].copy(),
            "labels": rows[:, 1:].copy(),
            "positions": pos[:, :-1].copy(),
        }

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def sharded_batches(
    stream: TokenStream,
    mesh=None,
    batch_spec=None,
    start_step: int = 0,
    *,
    device=None,
) -> Iterator[dict]:
    """Each batch of ``stream`` from ``start_step`` on as tensors on
    ``device`` — with the stateless stream this is exact replay-free
    resumption.  Without a mesh, the whole batch on ``device`` (default:
    the CUDA device).  With a ``DeviceMesh`` and ``batch_spec`` (a
    ``PartitionSpec`` of the batch's leading dims, as ``batch_pspec``
    makes), this rank's block of every array, on the mesh's device type
    (``device`` may name another)."""
    from ..distributed.sharding import _block

    if mesh is not None:
        if device is None:
            device = mesh.device_type
            if device == "cuda":
                device = torch.device("cuda", torch.cuda.current_device())
        spec = tuple(batch_spec) if batch_spec is not None else ()
    device = resolve_device(device)
    step = start_step
    while True:
        host = stream.batch(step)
        out = {k: torch.from_numpy(v) for k, v in host.items()}
        if mesh is not None:
            out = {k: _block(v, mesh, spec) for k, v in out.items()}
        yield {k: v.contiguous().to(device) for k, v in out.items()}
        step += 1
