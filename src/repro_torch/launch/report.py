"""Print the dry run's per-cell table and the roofline from the records:
the torch twin of the JAX package's ``repro/launch/report.py``.

``python -m repro_torch.launch.report [--dryrun-dir DIR]`` reads the
records of ``launch/dryrun.py`` (default ``experiments/dryrun_torch``).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..configs import SHAPES, list_archs
from .roofline import _HINTS, analyze, to_markdown

__all__ = ["HBM_BYTES", "dryrun_table", "main"]

# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 (700.00 W power limit), as chip_smoke.py's lm_dryrun phase reads it:
# 79.179 GiB
HBM_BYTES = 85_017_493_504
HBM_GIB = HBM_BYTES / 2**30


def dryrun_table(d: Path, mesh: str) -> str:
    """One row a registry cell: the reference's columns (``compile s`` is
    0: the port traces and compiles nothing), the fit against the card's
    memory, then the arguments one rank holds as the port holds them today
    and as the sharding plan would lay them out."""
    rows = [
        "| arch | shape | compile s | temp GiB/dev | fits 80G | coll GB/dev "
        "(link) | probe GFLOPs (global) | args GiB/dev | plan args GiB/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in list_archs():
        for shape in SHAPES:
            f = Path(d) / f"{arch}__{shape}__{mesh}.json"
            if not f.exists():
                rows.append(f"| {arch} | {shape} | MISSING | | | | | | |")
                continue
            r = json.loads(f.read_text())
            if r.get("status") == "skipped":
                rows.append(f"| {arch} | {shape} | — skipped: "
                            f"{r['reason'][:40]} | | | | | | |")
                continue
            if r.get("status") != "ok":
                rows.append(f"| {arch} | {shape} | ERROR | | | | | | |")
                continue
            mem = r["memory"]
            temp = mem["temp_size_in_bytes"] / 2**30
            args_b = mem["argument_size_in_bytes"] / 2**30
            plan_b = mem.get("plan_argument_bytes", 0) / 2**30
            fits = ("yes" if (temp + args_b) <= HBM_GIB
                    else f"NO ({temp + args_b:.0f}G)")
            link = r["collectives"].get("total_link_bytes", 0) / 1e9
            fl = r.get("probe", {}).get("flops", 0) / 1e9
            rows.append(
                f"| {arch} | {shape} | {r['compile_s']:.0f} | {temp:.2f} | "
                f"{fits} | {link:.1f} | {fl:,.0f} | {args_b:.2f} | "
                f"{plan_b:.2f} |"
            )
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dryrun-dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    d = Path(args.dryrun_dir)

    print("### Dry-run, single-pod 16x16 (256 cards)\n")
    print(dryrun_table(d, "pod"))
    print("\n### Dry-run, multi-pod 2x16x16 (512 cards)\n")
    print(dryrun_table(d, "multipod"))

    print("\n### Roofline (single-pod)\n")
    rows = analyze(str(d), "pod")
    print(to_markdown(rows))
    print()
    for r in rows:
        print(
            f"* **{r['arch']} x {r['shape']}** — dominant: {r['dominant']}; "
            f"{_HINTS[r['dominant']]}"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
