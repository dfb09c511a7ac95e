"""Findings, severities, and the :class:`AnalysisReport` container (a copy
of ``repro.analysis.report``: rule IDs, severities and the render format
are the reference's).

The analyzer (:mod:`repro_torch.analysis.rules`) emits :class:`Finding` records
— one per rule violation, each carrying a stable rule ID, a severity, a
human message, and a source location — collected into an
:class:`AnalysisReport`.  The report is the whole public result surface:
``report.ok`` is the CI gate, ``report.render()`` the human face, and
``report.raise_if_errors()`` the ``Graph.run(analyze=True)`` pre-flight
(raising :class:`AnalysisError` with the rendered report as its message).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = [
    "RULES",
    "AnalysisError",
    "AnalysisReport",
    "Finding",
]

# Stable rule registry: id -> (default severity, one-line title).  IDs are
# API — tests, CI logs, and the README table key on them; never renumber.
RULES = {
    "R1": ("error", "residency: O(m) aval materialized on device under "
                    "residency='host'"),
    "R2": ("error", "host-sync: concretization or callback inside the "
                    "traced BSP body"),
    "R3": ("warning", "retrace: carry aval drift across supersteps, or a "
                      "non-hashable program/policy config defeating the "
                      "trace caches"),
    "R4": ("error", "iostats: order-invariant IOStats field (or program "
                    "state) depends on a schedule-sensitive counter"),
    "R5": ("error", "semiring: identity/absorption/dtype law violated"),
    "R6": ("error", "convergence: converged() is constant — the loop "
                    "exits at superstep 0 or only at the budget"),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation.

    ``rule`` is the stable ID (``'R1'``..``'R6'``), ``severity`` is
    ``'error'`` or ``'warning'``, ``location`` is a clickable
    ``file:line`` string (the offending op's innermost user frame, or the
    offending hook's ``def`` site when the violation is not tied to one
    op), and ``hook`` names the program hook the diagnostic points at
    (``'gather'``, ``'converged'``, ...) when one is identifiable.
    """

    rule: str
    severity: str
    message: str
    location: str = ""
    hook: Optional[str] = None

    def render(self) -> str:
        where = f" [{self.location}]" if self.location else ""
        who = f" ({self.hook})" if self.hook else ""
        return f"{self.rule} {self.severity}{who}{where}: {self.message}"


@dataclasses.dataclass(frozen=True)
class AnalysisReport:
    """The result of :func:`repro_torch.analysis.analyze`.

    ``mode`` keeps the reference's values: ``'body'`` for a
    device-resident view (the recorded superstep is the one the driver
    runs, and rule R4 follows the IOStats through it), ``'hooks'`` for a
    host view (the hooks are recorded, and R4 is left to the runtime
    parity gates, as in the reference).  ``notes`` records what was
    skipped or narrowed and why — an analyzer that silently narrows its
    coverage would read as a clean bill it never issued.
    """

    program: str
    policy: str
    mode: str
    findings: Tuple[Finding, ...] = ()
    notes: Tuple[str, ...] = ()

    @property
    def errors(self) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == "error")

    @property
    def warnings(self) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == "warning")

    @property
    def ok(self) -> bool:
        """True when nothing was found (warnings included: the built-in
        zero-findings CI gate means *zero*, not 'no errors')."""
        return not self.findings

    def render(self) -> str:
        head = (f"semlint: {self.program} under {self.policy} "
                f"(mode={self.mode})")
        if self.ok:
            lines = [head + ": clean"]
        else:
            lines = [head + f": {len(self.errors)} error(s), "
                            f"{len(self.warnings)} warning(s)"]
            lines += ["  " + f.render() for f in self.findings]
        lines += ["  note: " + n for n in self.notes]
        return "\n".join(lines)

    def raise_if_errors(self) -> "AnalysisReport":
        if self.errors:
            raise AnalysisError(self)
        return self


class AnalysisError(ValueError):
    """``Graph.run(analyze=True)`` pre-flight failure: the program breaks
    at least one SEM contract.  Carries the full :class:`AnalysisReport`
    as ``.report``; the message is the rendered report."""

    def __init__(self, report: AnalysisReport):
        super().__init__(report.render())
        self.report = report
