"""Print PERF.md §4's dry-run rows from the records of
``python -m repro_torch.launch.dryrun`` (one JSON file a cell and mesh).

    python3 scripts/dryrun_rows.py DIR [--arch ARCH ...]

For each cell with a record on both meshes (``pod``: (16, 16),
``multipod``: (2, 16, 16)): rank 0's arguments (= the plan's bytes) and
temp bytes on both, link bytes by mesh dim, and the roofline's terms
(``launch.roofline.roofline_terms``: compute and memory on (16, 16),
collective seconds on both) with the (16, 16) bound.  CPU counts, no
device time.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import SHAPES, list_archs  # noqa: E402
from repro_torch.launch.roofline import roofline_terms  # noqa: E402

GIB = 2**30


def _link(rec: dict, dims: tuple) -> str:
    by = rec["collectives"].get("by_dim", {})
    return " / ".join(f"{by.get(d, {}).get('link_bytes', 0) / 1e9:.1f}"
                      for d in dims)


def row(pod: dict, multi: dict) -> str:
    mp, mm = pod["memory"], multi["memory"]
    for m in (mp, mm):
        assert m["argument_size_in_bytes"] == m["plan_argument_bytes"]
    tp, tm = roofline_terms(pod), roofline_terms(multi)
    return (f"| {pod['arch']} | {pod['shape']} | "
            f"{mp['argument_size_in_bytes'] / GIB:.2f} / "
            f"{mm['argument_size_in_bytes'] / GIB:.2f} | "
            f"{mp['temp_size_in_bytes'] / GIB:.2f} / "
            f"{mm['temp_size_in_bytes'] / GIB:.2f} | "
            f"{_link(pod, ('data', 'model'))} | "
            f"{_link(multi, ('pod', 'data', 'model'))} | "
            f"{tp['compute_s']:.4f} | {tp['mem_model_s']:.4f} / "
            f"{tp['mem_hlo_s']:.4f} | {tp['coll_s']:.4f} / "
            f"{tm['coll_s']:.4f} | {tp['dominant']} |")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dir")
    ap.add_argument("--arch", action="append")
    args = ap.parse_args(argv)
    d = Path(args.dir)
    for arch in args.arch or list_archs():
        for shape in SHAPES:
            recs = [d / f"{arch}__{shape}__{m}.json"
                    for m in ("pod", "multipod")]
            if not all(f.exists() for f in recs):
                continue
            pod, multi = (json.loads(f.read_text()) for f in recs)
            if pod.get("status") == "ok" and multi.get("status") == "ok":
                print(row(pod, multi))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
