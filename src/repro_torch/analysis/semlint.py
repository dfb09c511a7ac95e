"""semlint — the source-level (AST) companion of
:mod:`repro_torch.analysis`, torch port of ``tools/semlint.py``.

The analyzer sees what runs; this lint sees the source patterns that
would synchronize with the device every superstep, or that break a
contract, before anything runs.  Four rules:

S1  host reads of traced values: ``int()`` / ``float()`` / ``bool()`` /
    ``np.asarray()`` applied to, or ``.item()`` / ``.tolist()`` /
    ``.numpy()`` / ``.cpu()`` called on, a value derived from a hook's
    tensor arguments inside a VertexProgram hook (``frontier`` /
    ``gather`` / ``apply`` / ``activate`` / ``converged`` /
    ``converged_cols``).  Each waits for the device once per superstep
    (the runtime symptom is rule R2); casts of policy fields, graph dims
    and literals are fine.
S2  frozen-policy mutation: attribute assignment on an
    ``ExecutionPolicy`` value (``pol.backend = ...``): the policy is a
    frozen dataclass and a cache key; use ``dataclasses.replace``.
S3  bare ``ValueError`` in engine dispatch: ``raise ValueError`` inside
    ``repro_torch/core/engine.py``; dispatch errors are the typed
    ``PolicyError`` / ``ResidencyError``.
S4  wall-clock reads in hooks: ``time.time()`` / ``time.monotonic()`` /
    ``time.perf_counter()`` (and ``_ns`` variants) inside a hook.  Clocks
    belong in the eager drivers (work queue, checkpoint telemetry).

Usage::

    python -m repro_torch.analysis.semlint [paths...]   # default: src/repro_torch
    python -m repro_torch.analysis.semlint --analyze    # + the analyzer's
        # zero-findings gate over the built-in programs (on the CUDA
        # device; --device cpu runs it on the CPU)

The exit status is the number of findings, capped at 125 (0 == clean).
"""
from __future__ import annotations

import argparse
import ast
import os
import sys
from typing import List, Optional, Set

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HOOKS = ("frontier", "gather", "apply", "activate", "converged",
         "converged_cols")
# Hook parameters that carry no tensor state (everything else does).
UNTRACED_PARAMS = {"self", "cls", "sg", "pol", "policy", "seeds"}
CASTS = {"int", "float", "bool"}
HOST_METHODS = {"item", "tolist", "numpy", "cpu"}
POLICY_NAMES = {"pol", "policy"}
CLOCK_FNS = {"time", "monotonic", "perf_counter", "time_ns",
             "monotonic_ns", "perf_counter_ns"}


def _is_clock_call(call: ast.Call) -> Optional[str]:
    """``time.<clock>()`` or a bare from-imported ``monotonic()`` etc.
    (a bare ``time()`` alone is too ambiguous to flag)."""
    f = call.func
    if (isinstance(f, ast.Attribute) and f.attr in CLOCK_FNS
            and isinstance(f.value, ast.Name) and f.value.id == "time"):
        return f"time.{f.attr}"
    if isinstance(f, ast.Name) and f.id in CLOCK_FNS - {"time"}:
        return f.id
    return None


def _host_read(call: ast.Call) -> Optional[tuple]:
    """``(kind, operand)`` when ``call`` reads a value to the host."""
    f = call.func
    if isinstance(f, ast.Name) and f.id in CASTS and call.args:
        return f"{f.id}()", call.args[0]
    if (isinstance(f, ast.Attribute) and f.attr == "asarray"
            and isinstance(f.value, ast.Name)
            and f.value.id in ("np", "numpy") and call.args):
        return "np.asarray()", call.args[0]
    if isinstance(f, ast.Attribute) and f.attr in HOST_METHODS:
        return f".{f.attr}()", f.value
    return None


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


class _HookScope(ast.NodeVisitor):
    """One hook body: seed the tainted names from the hook's tensor
    parameters, propagate through assignments, and flag host reads whose
    operand touches a tainted name."""

    def __init__(self, path: str, scope: str, tainted: Set[str],
                 findings: List[tuple]):
        self.path = path
        self.scope = scope
        self.tainted = set(tainted)
        self.findings = findings

    def visit_Assign(self, node: ast.Assign):
        self.generic_visit(node)
        if _names_in(node.value) & self.tainted:
            for t in node.targets:
                self.tainted |= _names_in(t)

    def visit_Call(self, node: ast.Call):
        clock = _is_clock_call(node)
        if clock is not None:
            self.findings.append((
                "S4", self.path, node.lineno,
                f"{clock}() in {self.scope} — a hook runs once a "
                "superstep on device state; move timing and leases to "
                "the eager driver"))
        read = _host_read(node)
        if read is not None:
            touched = _names_in(read[1]) & self.tainted
            if touched:
                self.findings.append((
                    "S1", self.path, node.lineno,
                    f"{read[0]} on traced value "
                    f"({', '.join(sorted(touched))}) in {self.scope} — "
                    "waits for the device every superstep; keep it a "
                    "tensor"))
        self.generic_visit(node)

    def visit_FunctionDef(self, node):  # noqa: N802 - nested defs: own scope
        pass

    visit_AsyncFunctionDef = visit_FunctionDef


class _FileLint(ast.NodeVisitor):
    def __init__(self, path: str, findings: List[tuple]):
        self.path = path
        self.findings = findings
        self._in_program_class = False

    def visit_ClassDef(self, node: ast.ClassDef):
        bases = {b.id if isinstance(b, ast.Name) else
                 getattr(b, "attr", "") for b in node.bases}
        is_prog = "VertexProgram" in bases or any(
            isinstance(s, ast.FunctionDef) and s.name in ("apply",
                                                          "converged")
            for s in node.body)
        prev, self._in_program_class = self._in_program_class, is_prog
        self.generic_visit(node)
        self._in_program_class = prev

    def visit_FunctionDef(self, node: ast.FunctionDef):
        if self._in_program_class and node.name in HOOKS:
            params = {a.arg for a in node.args.args + node.args.kwonlyargs}
            scope = _HookScope(self.path, f"hook {node.name}()",
                               params - UNTRACED_PARAMS, self.findings)
            for stmt in node.body:
                scope.visit(stmt)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    # ---- S2: frozen-policy mutation -------------------------------------
    def visit_Assign(self, node: ast.Assign):
        for t in node.targets:
            if (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id in POLICY_NAMES):
                self.findings.append((
                    "S2", self.path, node.lineno,
                    f"mutation of frozen policy `{t.value.id}.{t.attr}` — "
                    "ExecutionPolicy is frozen and a cache key; use "
                    "dataclasses.replace() or policy.with_()"))
        self.generic_visit(node)

    # ---- S3: bare ValueError in engine dispatch --------------------------
    def visit_Raise(self, node: ast.Raise):
        if self.path.replace("\\", "/").endswith("repro_torch/core/engine.py"):
            exc = node.exc
            name = None
            if isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name):
                name = exc.func.id
            elif isinstance(exc, ast.Name):
                name = exc.id
            if name == "ValueError":
                self.findings.append((
                    "S3", self.path, node.lineno,
                    "bare ValueError in engine dispatch — raise "
                    "PolicyError (bad knob) or ResidencyError (missing "
                    "view) instead"))
        self.generic_visit(node)


def lint_file(path: str, findings: List[tuple]) -> None:
    with open(path, "r", encoding="utf-8") as fh:
        src = fh.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        findings.append(("S0", path, e.lineno or 0, f"syntax error: {e.msg}"))
        return
    _FileLint(path, findings).visit(tree)


def iter_py(paths: List[str]):
    for p in paths:
        if os.path.isfile(p):
            yield p
        else:
            for root, _dirs, files in os.walk(p):
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


# --------------------------------------------------------------------------
# --analyze: the analyzer's zero-findings gate
# --------------------------------------------------------------------------
def _readme_wcc():
    """The README's port example: weakly connected components by
    min-label propagation, on a tuple state."""
    import torch

    import repro_torch

    class WCC(repro_torch.VertexProgram):
        semiring = repro_torch.core.MIN_PLUS

        def init(self, sg, seeds):
            return (torch.arange(sg.n, dtype=torch.float32, device=sg.device),
                    torch.ones(sg.n, dtype=torch.bool, device=sg.device))

        def frontier(self, sg, s):
            return repro_torch.Frontier(x=s[0], active=s[1])

        def apply(self, sg, s, gathered):
            labels = torch.minimum(s[0], gathered)
            changed = labels < s[0]
            return (labels, changed), changed

        def finalize(self, sg, s):
            return s[0].to(torch.int32)

    return WCC()


def gate_programs(g):
    """``(name, program, seeds)`` of the zero-findings gate on session
    ``g``: every built-in program and the README's WCC."""
    import torch

    from ..algs import (
        BCBackwardProgram,
        BCForwardProgram,
        BFSProgram,
        CorenessProgram,
        PageRankPullProgram,
        PageRankPushProgram,
        PersonalizedPageRankProgram,
    )

    srcs = torch.tensor([0, 7], dtype=torch.int32)
    fwd = g.run(BCForwardProgram(), seeds=srcs)
    dist = fwd.state.dist
    max_level = torch.max(torch.where(dist < 0, -1, dist))
    return [
        ("bfs", BFSProgram(), [0, 5]),
        ("pr_push", PageRankPushProgram(), None),
        ("pr_pull", PageRankPullProgram(), None),
        ("coreness", CorenessProgram(), None),
        ("bc_fwd", BCForwardProgram(), srcs),
        ("bc_bwd", BCBackwardProgram(), (fwd.state.sigma, dist, max_level)),
        ("wcc", _readme_wcc(), None),
        ("ppr", PersonalizedPageRankProgram(), [0, 3, 7]),
    ]


GATE_POLICIES = (
    ("scan", {}),
    ("compact", {"backend": "compact"}),
    ("blocked", {"backend": "blocked"}),
    ("scan_host", {"residency": "host", "switch_fraction": None}),
)


def run_analyzer_gate(device=None) -> int:
    """The analyzer over every gate program and policy on
    ``rmat(8, symmetrize)``; prints one line a pair and returns the
    number of findings."""
    from .. import Graph, analysis
    from ..core import ExecutionPolicy
    from ..graph.generators import rmat

    g = Graph(rmat(8, edge_factor=16, seed=3, symmetrize=True),
              chunk_size=256, device=device)
    progs = gate_programs(g)
    bad = 0
    for polname, kw in GATE_POLICIES:
        pol = ExecutionPolicy(**kw)
        for name, p, s in progs:
            rep = analysis.check(g, p, pol, seeds=s)
            status = "clean" if rep.ok else "FINDINGS"
            print(f"analyze {polname:10s} {name:8s} mode={rep.mode:5s} "
                  f"{status}")
            if not rep.ok:
                bad += len(rep.findings)
                print(rep.render())
    print(f"analyzer gate: {bad} finding(s) across "
          f"{len(GATE_POLICIES) * len(progs)} program x policy combos")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", default=[PACKAGE])
    ap.add_argument("--analyze", action="store_true",
                    help="also run the analyzer as a zero-findings gate "
                         "over the built-in programs")
    ap.add_argument("--device", default=None,
                    help="device of the gate's graph (default: CUDA)")
    args = ap.parse_args(argv)

    findings: List[tuple] = []
    nfiles = 0
    for path in iter_py(args.paths):
        nfiles += 1
        lint_file(path, findings)
    for rule, path, line, msg in findings:
        print(f"{rule} {os.path.relpath(path)}:{line}: {msg}")
    print(f"semlint: {len(findings)} finding(s) in {nfiles} file(s)")

    total = len(findings)
    if args.analyze:
        total += run_analyzer_gate(args.device)
    return min(total, 125)


if __name__ == "__main__":
    sys.exit(main())
