"""Build a kernel source of ``repro_torch/csrc/`` with ``nvcc`` at first use.

Each source compiles on its own, for ``sm_90a``, into a shared library with
a plain C interface under ``build/kernels/`` at the repository root
(git-ignored), keyed by the source's hash; ``nvcc``'s ``-Xptxas -v``
report is kept beside it as ``<lib>.log``.  The wrappers load the library
with ``ctypes``.  Nothing here runs when a module is imported.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "build_library"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"


def build_library(source: str) -> Path:
    """Compile ``csrc/<source>.cu`` (once per source hash) and return the
    shared library's path.  Safe to call for several sources at once from
    threads: each writes its own temporary file and renames it."""
    src = CSRC / f"{source}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"lib{source}_{digest}.so"
    if out.exists():
        return out
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {src.name} failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out
