"""``repro_torch.analysis`` — the SEM contract checker ("semlint"), torch
port of ``repro.analysis``.

Graphyti's SEM guarantees — O(n) vertex state on the device, O(m) edge
data streamed, no hidden synchronization, order-invariant I/O accounting —
are checked before a run, on the hooks the driver would run::

    import repro_torch
    from repro_torch import analysis

    g = repro_torch.Graph.from_edges(...)
    report = analysis.check(g, MyProgram(), policy, seeds=0)
    print(report.render())          # rule table, file:line diagnostics
    report.raise_if_errors()        # or: g.run(MyProgram(), analyze=True)

Six rules ship (see :mod:`repro_torch.analysis.rules`): R1 residency, R2
host-sync, R3 retrace audit, R4 IOStats order-invariance, R5 semiring
lawfulness, R6 convergence guard.  The port has no jaxpr: the O(n) hooks
run on fake tensors and one superstep runs for real under a recorder
(:mod:`repro_torch.analysis.inspect`).  The source-level AST companion is
:mod:`repro_torch.analysis.semlint`.
"""
from .report import RULES, AnalysisError, AnalysisReport, Finding
from .rules import analyze

__all__ = [
    "RULES",
    "AnalysisError",
    "AnalysisReport",
    "Finding",
    "analyze",
    "check",
]


def check(graph, program, policy=None, *, seeds=None,
          raise_on_error: bool = False) -> AnalysisReport:
    """``analyze()`` with the session façade's argument order (graph
    first, like ``Graph.run``).  With ``raise_on_error`` the report raises
    :class:`AnalysisError` when any error-severity finding exists: this is
    what ``Graph.run(analyze=True)`` calls before it dispatches the run."""
    report = analyze(program, graph, policy, seeds=seeds)
    if raise_on_error:
        report.raise_if_errors()
    return report
