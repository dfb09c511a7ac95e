#!/usr/bin/env python3
"""Where B5's time goes on the card: variants of the bf16 decode-attention
kernel, built side by side from ``src/repro_torch/csrc/decode_attn.cu``.

    python3 scripts/b5_probe.py [--reps N]

Each variant is the committed source with one part cut out by a text
substitution (the script fails if the source no longer has the text):

  kernel      the source as it is;
  copy_only   consumers wait for each stage and release it, no math: the
              copy path alone;
  math_only   the producer releases stages without copying: the math alone
              (on whatever the ring holds; its output is not checked);
  no_merge    every block returns before the split merge (no workspace
              write, ticket or merge);
  launch      every block returns at entry: the launch floor.

Each is timed as one call's device time inside a CUDA graph
(``chip_smoke.device_ms``) at the serve shape (B=4, KV=1, G=8, hd=256,
T=1024, 18 copies taken in turn), at the serve shape with every slot dead
(cur = -1), and at decode_32k (B=128, T=32768); then the kernel at the
serve shape with the split forced to 4, 8, 16 and 32.  Prints the card's
name and power limit first.  Needs a CUDA device and ``nvcc``; builds into
the git-ignored ``build/b5_probe/``.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

MATH_START = "      // S = q . K^T: 16 heads x 16 slots (two 8-slot tiles)."
MATH_END = ("      __syncwarp();\n"
            "      if (lane == 0) mbar_arrive(smem_u32(&empty[st]));")
TMA_COPY = """            mbar_arrive_expect_tx(bar, 2 * KV_BYTES);
            tma_load(smem_u32(stage), &km, b * t_len + ct0, h, bar);
            tma_load(smem_u32(stage + KV_BYTES), &vm, b * t_len + ct0, h,
                     bar);"""
ENTRY = ("  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;\n"
         "  const int nsplit = gridDim.x;\n")
MERGE = ("  // Merge the warps in warp order: into out (one split) or the "
         "workspace.")


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"b5_probe: the source lacks {old[:60]!r}")
    return src.replace(old, new, 1)


def _cut_math(src: str) -> str:
    for text in (MATH_START, MATH_END):
        if text not in src:
            raise SystemExit(f"b5_probe: the source lacks {text[:60]!r}")
    return src[:src.index(MATH_START)] + src[src.index(MATH_END):]


VARIANTS = {
    "kernel": lambda s: s,
    "copy_only": _cut_math,
    "math_only": lambda s: _sub(s, TMA_COPY, "            mbar_arrive(bar);"),
    "no_merge": lambda s: _sub(s, MERGE,
                               "  if (nsplit > 0) return;\n" + MERGE),
    "launch": lambda s: _sub(s, ENTRY, ENTRY + "  if (nsplit > 0) return;\n"),
}


def build(name: str, out: Path) -> Path:
    src = (ROOT / "src/repro_torch/csrc/decode_attn.cu").read_text()
    cu = out / f"{name}.cu"
    cu.write_text(VARIANTS[name](src))
    lib = out / f"lib{name}.so"
    cmd = ["/usr/local/cuda/bin/nvcc", "-gencode",
           "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", str(lib), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode:
        raise SystemExit(f"b5_probe: nvcc {name} failed:\n{proc.stderr}")
    return lib


def use(lib: Path, K) -> None:
    """Point the wrapper at ``lib`` (the same C interface)."""
    handle = ctypes.CDLL(str(lib))
    for fn in K._ENTRY.values():
        getattr(handle, fn).argtypes = K._ARGTYPES
        getattr(handle, fn).restype = ctypes.c_int
    handle.decode_attn_bf16_ctas_per_sm.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    handle.decode_attn_bf16_ctas_per_sm.restype = ctypes.c_int
    handle.decode_attn_bf16_maps.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    handle.decode_attn_bf16_maps.restype = ctypes.c_int
    K._lib = handle
    K._slots.clear()
    K._maps.clear()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20,
                    help="calls captured in each timed CUDA graph")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("b5_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import decode_attn as tda
    from repro_torch.kernels.decode_attn import kernel as K

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    out = ROOT / "build" / "b5_probe"
    out.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # one nvcc each
        libs = dict(zip(VARIANTS, pool.map(lambda n: build(n, out),
                                           VARIANTS)))
    bf16 = torch.bfloat16
    serve = [cs._attn_case("cuda", torch, 4, 1, 8, 256, 1024, bf16,
                           (1024,) * 4, seed=300 + i) for i in range(18)]
    shapes = {
        "serve": serve,
        "serve_dead": [(q, k, v, pos, torch.full_like(cur, -1))
                       for q, k, v, pos, cur in serve],
        "decode_32k": [cs._attn_case("cuda", torch, 128, 1, 8, 256, 32768,
                                     bf16, (32768,) * 128, seed=7)],
    }

    def device_ms(sets) -> float:
        turn = [0]

        def run():
            turn[0] += 1
            return tda.decode_attention(*sets[turn[0] % len(sets)])
        return cs.device_ms(run, torch, calls=args.reps)

    for name, lib in libs.items():
        use(lib, K)
        row = {shape: round(device_ms(sets), 5)
               for shape, sets in shapes.items()}
        print(f"b5_probe {name}: device_ms {row}", flush=True)
    use(libs["kernel"], K)
    split_count = K.split_count
    for n in (4, 8, 16, 32):
        K.split_count = lambda rows, units, slots, n=n: n
        print(f"b5_probe kernel serve nsplit={n}: device_ms "
              f"{device_ms(serve):.5f}", flush=True)
    K.split_count = split_count
    return 0


if __name__ == "__main__":
    sys.exit(main())
