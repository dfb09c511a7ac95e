"""Sharded, atomic, async-capable, streaming + delta checkpointing (torch
port of ``repro.checkpoint.store``; the on-disk format is the reference's,
byte for byte).

  * **Atomicity** — a checkpoint is written to ``step_<n>.tmp`` and renamed
    only after every shard file + the manifest are fsync'd (and the parent
    directory is fsync'd after the rename, so the publish itself is
    durable).  Restore scans for the highest *complete* step, skipping
    ``.tmp`` partials, stray non-step entries, and steps whose
    ``extra.json`` is torn.
  * **Streaming sharded saves** — with ``max_shard_bytes`` set, leaves are
    flattened and cut into *pieces* of at most that many bytes, packed
    into fsync'd ``shard_<k>.npz`` files of at most one budget each; a
    tensor leaf is sliced before its copy to the host, so peak staging is
    one shard, not the O(n) state.
  * **Delta snapshots** — with ``delta=True``, pieces whose content hash
    matches the previous complete step's are not rewritten; the manifest
    references the step that physically stores them (depth one).
  * **Async save** — ``CheckpointManager.save(..., blocking=False)`` hands
    serialization to a background thread.  torch tensors are mutable and
    the drivers may update state in place, so the save first copies every
    leaf off the live state (a clone on the tensor's device, then an event
    the writer thread waits on before it reads the clones): no background
    thread ever touches a tensor the next superstep writes.
  * **Restore target** — ``restore_checkpoint(..., device=...)`` places
    tensor leaves on a device (default: the target leaf's);
    ``as_numpy=True`` keeps host numpy arrays.
  * **Retention** — ``keep`` bounds disk usage; the newest ``keep`` steps
    survive, plus any older step a surviving delta manifest references.

Trees are flattened in JAX's leaf order (dict keys sorted, tuple, list and
NamedTuple fields in order, ``None`` holding no leaf), and the manifest's
``treedef`` is JAX's ``str(treedef)`` of the same structure, so a snapshot
written by either package restores through the other leaf for leaf.
bfloat16 and float8 leaves are stored as ``uint16``/``uint8`` views under
their dtype names, as the reference stores them; a restore with
``as_numpy=True`` returns such a leaf as that integer view (numpy has no
bfloat16 here).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Iterator, Optional

import numpy as np
import torch

__all__ = [
    "CheckpointCorruptionError",
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "load_extra",
    "CheckpointManager",
]

_MANIFEST = "manifest.json"
_EXTRA = "extra.json"


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint directory passed the completeness scan (manifest
    present, not ``.tmp``) but its contents do not match the manifest —
    e.g. a shard file holding fewer leaves than ``num_leaves``, a missing
    delta-referenced shard, or a torn ``extra.json``.  Raised instead of
    unflattening a short leaf list into garbage."""


def _step_num(name: str) -> Optional[int]:
    """``step_<n>`` -> n, or None for stray non-step entries."""
    tail = name.split("_", 1)[1] if "_" in name else ""
    return int(tail) if tail.isdigit() else None


def _fsync_path(path: Path) -> None:
    """fsync a file (or directory) by path."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# --------------------------------------------------------------------------
# pytree flattening in JAX's order
# --------------------------------------------------------------------------
def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _flatten(tree: Any) -> tuple[list, str]:
    """``(leaves, treedef string)``: the leaves in ``jax.tree_util``'s
    order and ``str(treedef)`` as JAX prints it."""
    leaves: list = []
    return leaves, f"PyTreeDef({_walk_flat(tree, leaves)})"


# The walks are module-level functions: a recursive closure is a reference
# cycle that keeps its leaves (whole parameter or gradient trees) alive
# until Python's cyclic collector runs.
def _walk_flat(t, leaves: list) -> str:
    if t is None:
        return "None"
    if _is_namedtuple(t):
        kids = ", ".join(_walk_flat(c, leaves) for c in t)
        return f"CustomNode(namedtuple[{type(t).__name__}], [{kids}])"
    if isinstance(t, tuple):
        kids = [_walk_flat(c, leaves) for c in t]
        return "(" + kids[0] + ",)" if len(kids) == 1 \
            else "(" + ", ".join(kids) + ")"
    if isinstance(t, list):
        return "[" + ", ".join(_walk_flat(c, leaves) for c in t) + "]"
    if isinstance(t, dict):
        return "{" + ", ".join(f"{k!r}: {_walk_flat(t[k], leaves)}"
                               for k in sorted(t)) + "}"
    leaves.append(t)
    return "*"


def _unflatten(tree: Any, leaves: list) -> Any:
    """``tree``'s structure with its leaves replaced, in flatten order."""
    return _walk_unflat(tree, iter(leaves))


def _walk_unflat(t, it):
    if t is None:
        return None
    if _is_namedtuple(t):
        return type(t)(*(_walk_unflat(c, it) for c in t))
    if isinstance(t, (tuple, list)):
        return type(t)(_walk_unflat(c, it) for c in t)
    if isinstance(t, dict):
        out = {k: _walk_unflat(t[k], it) for k in sorted(t)}
        return {k: out[k] for k in t}
    return next(it)


# --------------------------------------------------------------------------
# dtypes numpy cannot save
# --------------------------------------------------------------------------
# numpy (without ml_dtypes) has no bfloat16/float8: round-trip them through
# a same-width integer view, recording the true dtype in the manifest.
_VIEW_AS = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
            "float8_e5m2": np.uint8}
_TORCH_VIEW = {"bfloat16": torch.int16, "float8_e4m3fn": torch.uint8,
               "float8_e5m2": torch.uint8}


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return np.asarray(leaf).dtype.name


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor (or a slice of one) as a host numpy array, bfloat16 and
    float8 as their integer views."""
    name = _dtype_name(t)
    t = t.detach()
    if name in _TORCH_VIEW:
        return t.view(_TORCH_VIEW[name]).cpu().numpy().view(_VIEW_AS[name])
    return t.cpu().numpy()


def _savable(a: np.ndarray, name: str) -> tuple[np.ndarray, str]:
    if name in _VIEW_AS and a.dtype != _VIEW_AS[name]:
        return a.view(_VIEW_AS[name]), name
    return a, name


def _extra_ok(step_dir: Path) -> bool:
    """True when the step's ``extra.json`` is absent or parseable."""
    epath = step_dir / _EXTRA
    if not epath.exists():
        return True
    try:
        json.loads(epath.read_text())
        return True
    except (json.JSONDecodeError, OSError):
        return False


def _fsync_json(path: Path, obj: Any) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())


# --------------------------------------------------------------------------
# streaming piece iteration
# --------------------------------------------------------------------------
def _piece_hash(piece: np.ndarray, dtype_name: str) -> str:
    h = hashlib.sha1()
    h.update(dtype_name.encode())
    h.update(np.int64(piece.size).tobytes())
    h.update(np.ascontiguousarray(piece).tobytes())
    return h.hexdigest()


def _leaf_pieces(leaf: Any, max_bytes: Optional[int]) -> Iterator[np.ndarray]:
    """Yield host-resident flat pieces of ``leaf``, each at most
    ``max_bytes`` (or the whole leaf when None).  Tensor leaves are sliced
    *before* their copy to the host, so one piece is staged at a time."""
    is_t = isinstance(leaf, torch.Tensor)
    flat = leaf.reshape(-1) if is_t else np.ravel(np.asarray(leaf))
    n = int(flat.shape[0])
    itemsize = flat.element_size() if is_t else flat.dtype.itemsize
    epp = max(n, 1) if max_bytes is None \
        else max(1, int(max_bytes) // max(itemsize, 1))
    if n == 0:
        yield _host(flat) if is_t else flat
        return
    for a in range(0, n, epp):
        piece = flat[a:a + epp]
        yield _host(piece) if is_t else np.asarray(piece)


def _prev_manifest(directory: Path, step: int) -> Optional[dict]:
    """Newest complete step's manifest strictly below ``step`` (the delta
    base), or None."""
    best, best_d = None, None
    if not directory.exists():
        return None
    for d in directory.iterdir():
        if not d.name.startswith("step_") or d.name.endswith(".tmp"):
            continue
        s = _step_num(d.name)
        if s is None or s >= step or not (d / _MANIFEST).exists():
            continue
        if best is None or s > best:
            best, best_d = s, d
    if best_d is None:
        return None
    try:
        return json.loads((best_d / _MANIFEST).read_text())
    except (json.JSONDecodeError, OSError):
        return None


def save_checkpoint(
    directory: str | Path, step: int, tree: Any, *, process: int = 0,
    extra: Optional[dict] = None, max_shard_bytes: Optional[int] = None,
    delta: bool = False, telemetry: Optional[dict] = None,
) -> Path:
    """Write one atomic checkpoint; returns the final step directory.

    ``extra``: an optional JSON-serializable dict written as ``extra.json``
    inside the step directory (published under the same atomic rename).
    ``max_shard_bytes`` streams the state out in shards of at most this
    many bytes; ``delta=True`` skips pieces unchanged since the previous
    complete step.  Both default off: the legacy single-``npz`` layout.
    ``telemetry`` receives the streaming writer's ``stage_peak_bytes``,
    ``bytes_written`` and ``shard_files``.
    """
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves, treedef = _flatten(tree)
    if max_shard_bytes is None and not delta:
        _write_legacy(tmp, leaves, treedef, process)
    else:
        _write_streaming(tmp, directory, step, leaves, treedef,
                         max_shard_bytes=max_shard_bytes, delta=delta,
                         telemetry=telemetry)
    if extra is not None:
        _fsync_json(tmp / _EXTRA, extra)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    # fsync the parent directory so the rename itself survives a crash.
    _fsync_path(directory)
    return final


def _write_legacy(tmp: Path, leaves: list, treedef: str,
                  process: int) -> None:
    names = [_dtype_name(l) for l in leaves]
    host = [_host(l) if isinstance(l, torch.Tensor) else np.asarray(l)
            for l in leaves]
    pairs = [_savable(a, name) for a, name in zip(host, names)]
    shard = tmp / f"proc{process}.npz"
    # write + fsync the shard through one descriptor (np.savez(path) would
    # close the file without a durability barrier).
    with open(shard, "wb") as f:
        np.savez(f, **{f"a{i}": a for i, (a, _) in enumerate(pairs)})
        f.flush()
        os.fsync(f.fileno())
    manifest = {
        "step": _step_num(tmp.name.removesuffix(".tmp")),
        "num_leaves": len(leaves),
        "treedef": treedef,
        "dtypes": [name for _, name in pairs],
        "shapes": [list(a.shape) for a in host],
        "processes": 1,
    }
    _fsync_json(tmp / _MANIFEST, manifest)


def _write_streaming(
    tmp: Path, directory: Path, step: int, leaves: list, treedef: str,
    *, max_shard_bytes: Optional[int], delta: bool,
    telemetry: Optional[dict],
) -> None:
    """The format 2 writer: leaves cut into <=``max_shard_bytes`` pieces,
    packed greedily into fsync'd shard files, unchanged pieces
    (``delta``) referenced from their physical home step."""
    prev = _prev_manifest(directory, step) if delta else None
    prev_leaves = (prev or {}).get("leaves")

    budget = int(max_shard_bytes) if max_shard_bytes is not None else None
    pending: dict = {}          # key -> host piece, the open shard
    pending_bytes = 0
    shard_files: list[str] = []
    peak_stage = 0
    bytes_written = 0
    entries = []
    dtype_names = []

    def _flush() -> None:
        nonlocal pending, pending_bytes
        if not pending:
            return
        name = f"shard_{len(shard_files):05d}.npz"
        with open(tmp / name, "wb") as f:
            np.savez(f, **pending)
            f.flush()
            os.fsync(f.fileno())
        shard_files.append(name)
        pending = {}
        pending_bytes = 0

    for i, leaf in enumerate(leaves):
        leaf_name = _dtype_name(leaf)
        first = None
        pieces = []
        for j, piece in enumerate(_leaf_pieces(leaf, budget)):
            view, dtype_name = _savable(piece, leaf_name)
            if first is None:
                first = dtype_name
            h = _piece_hash(view, dtype_name)
            ref = None
            if prev_leaves is not None and i < len(prev_leaves):
                pl = prev_leaves[i]
                if (pl.get("dtype") == dtype_name
                        and j < len(pl.get("pieces", []))
                        and pl["pieces"][j].get("h") == h
                        and pl["pieces"][j].get("n") == int(view.size)):
                    ref = pl["pieces"][j]
            if ref is not None:
                # unchanged since the delta base: reference its physical
                # home (the base's entry already points there).
                pieces.append({"h": h, "n": int(view.size),
                               "step": int(ref["step"]),
                               "shard": ref["shard"], "key": ref["key"]})
            else:
                key = f"a{i}_p{j}"
                if (budget is not None and pending
                        and pending_bytes + view.nbytes > budget):
                    _flush()
                pending[key] = view
                pending_bytes += int(view.nbytes)
                peak_stage = max(peak_stage, pending_bytes)
                bytes_written += int(view.nbytes)
                pieces.append({"h": h, "n": int(view.size), "step": step,
                               "shard": None, "key": key})
            del piece, view
        entries.append({"dtype": first, "pieces": pieces})
        dtype_names.append(first)
    _flush()
    # shard names are only known once flushed: resolve the fresh pieces'
    # shard field from the shards' members.
    key_to_shard = {}
    for name in shard_files:
        with np.load(tmp / name) as z:
            for k in z.files:
                key_to_shard[k] = name
    for e in entries:
        for p in e["pieces"]:
            if p["shard"] is None:
                p["shard"] = key_to_shard[p["key"]]

    for e, leaf in zip(entries, leaves):
        e["shape"] = list(leaf.shape) if isinstance(leaf, torch.Tensor) \
            else list(np.shape(leaf))
    manifest = {
        "format": 2,
        "step": step,
        "num_leaves": len(leaves),
        "treedef": treedef,
        "dtypes": dtype_names,
        "shapes": [e["shape"] for e in entries],
        "leaves": entries,
        "shards": shard_files,
        "delta_base": (prev or {}).get("step"),
        "stored_bytes": bytes_written,
        "processes": 1,
    }
    _fsync_json(tmp / _MANIFEST, manifest)
    if telemetry is not None:
        telemetry["stage_peak_bytes"] = max(
            int(telemetry.get("stage_peak_bytes", 0)), peak_stage)
        telemetry["bytes_written"] = (
            int(telemetry.get("bytes_written", 0)) + bytes_written)
        telemetry["shard_files"] = (
            int(telemetry.get("shard_files", 0)) + len(shard_files))


def latest_step(directory: str | Path) -> Optional[int]:
    """Highest step with a complete manifest (ignores .tmp partials, stray
    non-numeric ``step_*`` entries, and steps whose ``extra.json`` is
    torn)."""
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for d in directory.iterdir():
        if d.name.startswith("step_") and not d.name.endswith(".tmp"):
            s = _step_num(d.name)
            if s is not None and (d / _MANIFEST).exists() and _extra_ok(d):
                steps.append(s)
    return max(steps) if steps else None


def load_extra(directory: str | Path, step: int) -> Optional[dict]:
    """The ``extra`` dict saved with a step, or None if none was.  A
    present-but-unparseable ``extra.json`` raises
    :class:`CheckpointCorruptionError` naming the step."""
    epath = Path(directory) / f"step_{step:08d}" / _EXTRA
    if not epath.exists():
        return None
    try:
        return json.loads(epath.read_text())
    except json.JSONDecodeError as e:
        raise CheckpointCorruptionError(
            f"checkpoint step {step} under {directory} has a torn "
            f"extra.json ({e.msg} at char {e.pos}); the step cannot be "
            f"fingerprint-checked.  latest_step() skips such steps — "
            f"resume from an earlier complete snapshot or delete the "
            f"corrupt step directory."
        ) from e


def _load_v2_leaves(directory: Path, manifest: dict) -> list:
    """Assemble leaves from a streaming/delta manifest, following each
    piece to the step that physically stores it.  Leaves keep their
    stored (integer-view) dtype; :func:`_as_target` restores the rest."""
    handles: dict = {}

    def shard(step: int, name: str):
        key = (step, name)
        z = handles.get(key)
        if z is None:
            p = directory / f"step_{step:08d}" / name
            if not p.exists():
                raise CheckpointCorruptionError(
                    f"checkpoint under {directory} is corrupt: shard "
                    f"{name} of step {step} (referenced by a delta "
                    f"manifest) is missing — was the base step deleted "
                    f"outside the manager's retention?"
                )
            z = handles[key] = np.load(p)
        return z

    leaves = []
    try:
        for e in manifest["leaves"]:
            n = int(np.prod(e["shape"], dtype=np.int64)) if e["shape"] \
                else 1
            stored_dtype = np.dtype(_VIEW_AS.get(e["dtype"], e["dtype"]))
            flat = np.empty(max(n, sum(p["n"] for p in e["pieces"])),
                            stored_dtype)
            off = 0
            for p in e["pieces"]:
                z = shard(int(p["step"]), p["shard"])
                if p["key"] not in z.files:
                    raise CheckpointCorruptionError(
                        f"checkpoint under {directory} is corrupt: shard "
                        f"{p['shard']} of step {p['step']} has no entry "
                        f"{p['key']} promised by the manifest"
                    )
                piece = z[p["key"]]
                if int(piece.size) != int(p["n"]):
                    raise CheckpointCorruptionError(
                        f"checkpoint under {directory} is corrupt: piece "
                        f"{p['key']} holds {int(piece.size)} elements, "
                        f"manifest promises {p['n']}"
                    )
                flat[off:off + piece.size] = piece.reshape(-1)
                off += int(piece.size)
            leaves.append(flat[:max(n, 0)].reshape(e["shape"]))
    finally:
        for z in handles.values():
            z.close()
    return leaves


def _as_target(a: np.ndarray, name: str, target, device, as_numpy: bool):
    """A stored leaf in the form its restore target asks for: numpy
    (``as_numpy``, or a numpy/Python target), else a tensor on ``device``
    (default: the target tensor's device, else the CPU)."""
    if as_numpy or not isinstance(target, torch.Tensor):
        if not as_numpy and isinstance(target, (bool, int, float)):
            return a.item() if name not in _VIEW_AS else a
        return a
    t = torch.from_numpy(np.array(a, order="C"))
    if name in _TORCH_VIEW:
        t = t.view(_TORCH_VIEW[name]).view(getattr(torch, name))
    dev = device if device is not None else target.device
    return t.to(dev)


def restore_checkpoint(
    directory: str | Path,
    target_tree: Any,
    step: Optional[int] = None,
    *,
    device=None,
    as_numpy: bool = False,
) -> tuple[Any, int]:
    """Restore into the structure of ``target_tree``: ``(tree, step)``.

    Each leaf comes back in its target leaf's kind: a tensor target gives
    a tensor (on ``device`` when given, else on the target's device), a
    numpy target a numpy array, a Python scalar target a Python scalar;
    ``as_numpy`` keeps every leaf a host numpy array with its exact saved
    dtype.  Both layouts restore: the legacy single-``npz`` step and the
    streaming/delta manifest.
    """
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / _MANIFEST).read_text())
    if manifest.get("format") == 2:
        stored = _load_v2_leaves(directory, manifest)
    else:
        with np.load(d / "proc0.npz") as data:
            if len(data.files) != manifest["num_leaves"]:
                raise CheckpointCorruptionError(
                    f"checkpoint {d} is corrupt: shard holds "
                    f"{len(data.files)} leaves but the manifest promises "
                    f"{manifest['num_leaves']}"
                )
            stored = [data[f"a{i}"] for i in range(len(data.files))]
    targets, _ = _flatten(target_tree)
    if len(targets) != len(stored):
        raise CheckpointCorruptionError(
            f"checkpoint {d} holds {len(stored)} leaves but the restore "
            f"target has {len(targets)}"
        )
    leaves = [_as_target(a, name, t, device, as_numpy)
              for a, name, t in zip(stored, manifest["dtypes"], targets)]
    return _unflatten(target_tree, leaves), step


def _snapshot(leaves: list) -> tuple[list, Optional[list]]:
    """Copies of ``leaves`` that the caller may go on mutating: tensors
    cloned on their device, numpy arrays copied.  Returns the copies and
    one event per CUDA device that the reader must wait on before it
    reads the clones (they were enqueued on the current streams)."""
    out, events = [], {}
    for l in leaves:
        if isinstance(l, torch.Tensor):
            out.append(l.detach().clone())
            if l.is_cuda and l.device not in events:
                events[l.device] = None
        elif isinstance(l, np.ndarray):
            out.append(np.array(l, copy=True))
        else:
            out.append(l)
    ready = []
    for dev in events:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ready.append(ev)
    return out, ready


class CheckpointManager:
    """Retention + async save around the atomic writer.

    ``max_shard_bytes`` / ``delta`` select the streaming layout for every
    save through this manager (see :func:`save_checkpoint`); ``telemetry``
    receives the writer's staging/bytes odometers."""

    def __init__(self, directory: str | Path, keep: int = 3, *,
                 max_shard_bytes: Optional[int] = None, delta: bool = False,
                 telemetry: Optional[dict] = None):
        self.directory = Path(directory)
        self.keep = keep
        self.max_shard_bytes = max_shard_bytes
        self.delta = bool(delta)
        self.telemetry = telemetry
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        """Block until the in-flight async save (if any) completes."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, *, blocking: bool = True,
             extra: Optional[dict] = None):
        """Write a snapshot, optionally in the background.

        A blocking save writes straight from ``tree``.  A background save
        first copies every leaf (device clones, host copies) so that the
        caller may mutate ``tree`` as soon as this returns; the writer
        thread waits on the clones' events, then stages them piece by
        piece."""
        self.wait()

        def _write(snapshot, ready):
            try:
                for ev in ready:
                    ev.synchronize()
                save_checkpoint(self.directory, step, snapshot, extra=extra,
                                max_shard_bytes=self.max_shard_bytes,
                                delta=self.delta, telemetry=self.telemetry)
                self._gc()
            except BaseException as e:  # surfaced on next wait()/save()
                self._error = e

        if blocking:
            _write(tree, [])
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            return
        leaves, _ = _flatten(tree)
        copies, ready = _snapshot(leaves)
        self._thread = threading.Thread(
            target=_write, args=(_unflatten(tree, copies), ready),
            daemon=True)
        self._thread.start()

    def restore(self, target_tree: Any, *, device=None):
        return restore_checkpoint(self.directory, target_tree, device=device)

    def _gc(self):
        steps = sorted(
            s
            for d in self.directory.iterdir()
            if d.name.startswith("step_") and not d.name.endswith(".tmp")
            and (s := _step_num(d.name)) is not None
            and (d / _MANIFEST).exists()
        )
        retained = set(steps[-self.keep:]) if self.keep else set()
        # Delta manifests reference earlier steps' shards: a retained
        # step's physical homes survive retention too.
        for s in sorted(retained, reverse=True):
            mpath = self.directory / f"step_{s:08d}" / _MANIFEST
            try:
                manifest = json.loads(mpath.read_text())
            except (json.JSONDecodeError, OSError):  # pragma: no cover
                continue
            for e in manifest.get("leaves") or []:
                for p in e["pieces"]:
                    retained.add(int(p["step"]))
        for s in steps:
            if s not in retained:
                shutil.rmtree(self.directory / f"step_{s:08d}",
                              ignore_errors=True)
