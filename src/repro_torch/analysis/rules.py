"""``analyze()`` and the six SEM contract rules (R1–R6), torch port of
``repro.analysis.rules``.

The reference traces the superstep body into a jaxpr and walks it.  The
port records instead (:class:`~repro_torch.analysis.inspect.Recorder`),
in two passes:

1. **Fake pass, before any edge byte moves.**  The O(n) hooks (``init``,
   ``frontier``, ``apply``, ``converged``, ``finalize``) run on fake
   tensors (``FakeTensorMode(allow_non_fake_inputs=True)``) with the
   recorder on top; ``apply`` gets a fake gathered value shaped as the
   frontier's ``x``, as the reference's host mode traces it.  Nothing is
   allocated, so an O(m) tensor that rule R1 catches cannot run the card
   out of memory, and a host read raises where it stands.
2. **Recorded superstep.**  The hooks that reach the engine (``gather``,
   ``activate``) cannot run on fakes: the engine reads the device while
   it dispatches.  So one superstep runs for real, from a fresh initial
   state, under the recorder, with engine frames exempt; ``report.notes``
   says so and names the kernels it launched.  It is skipped when the
   fake pass found an R1 error.

Rules (stable IDs; severities in :data:`~repro_torch.analysis.report.RULES`):

R1 residency
    Under ``residency='host'`` no op in a user frame may make a tensor
    with a dimension equal to ``sg.m`` on the view's device: the
    accidental full-edge allocation that undoes semi-external memory.
    Engine frames (``repro_torch/core``, ``repro_torch/kernels``) are
    exempt; they stream their O(m) work.
R2 host-sync
    A host read (``item``, ``tolist``, ``numpy``, ``np.asarray``,
    ``bool``/``int``/``float`` of a tensor, ``.cpu()``), an op whose
    output shape depends on the data (``nonzero``, boolean-mask indexing,
    ``unique``, ``repeat_interleave`` without ``output_size``), or a
    ``DataDependentOutputException`` of the fake pass, in a user frame of
    ``frontier``/``gather``/``apply``/``activate``/``converged``: each is
    a device round trip every superstep.  The finding names the hook and
    the line.
R3 retrace audit
    A carried state leaf that changes across one superstep.  A change of
    tree structure or shape is an error.  A dtype change is a warning:
    it is the port's counterpart of the reference's weak-type flip.  The
    port's loop is a Python loop, so it carries any dtype, and a
    checkpoint restores each leaf at the dtype it was saved with (not at
    ``init``'s), so a resumed run still equals an uninterrupted one; what
    the change costs is that the state the run carries is not the one
    ``init`` declared (another precision, another size on the card, and
    a snapshot schema that differs between superstep 0 and the rest), so
    it is reported and ``analyze=True`` still runs the program.  Also a
    non-hashable program or policy config, which defeats the analysis
    and checkpoint fingerprints keyed on it.
R4 IOStats order-invariance
    Only ``x_fetches`` (schedule-sensitive) and ``host_bytes``
    (residency-sensitive) may depend on tile or batch order.  Every
    ``IOStats`` built during the recorded ``gather``/``apply``/
    ``activate`` marks those two fields tainted at construction, and the
    taint follows the data: any other field, or any state leaf, it
    reaches breaks the ledger contract.  Device views only (mode
    ``'body'``); under host residency the runtime parity gates cover it,
    as in the reference.
R5 semiring lawfulness
    ``combine(identity, v) == v``, ``edge_op(identity, w) == identity``
    and a dtype-stable ``edge_op`` at the frontier dtype.
R6 convergence guard
    ``converged()``'s output must be reached by a state leaf or the
    superstep's activations; otherwise the exit is decided before the
    run starts.
"""
from __future__ import annotations

import contextlib
import inspect as _src
from collections import OrderedDict
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..core.engine import ExecutionPolicy
from ..core.program import VertexProgram
from ..core.sem import IOStats
from .inspect import (
    Recorder,
    kernel_launches,
    leaves_with_paths,
    location_from_exception,
)
from .report import RULES, AnalysisReport, Finding

__all__ = ["analyze"]

_HOOKS = ("init", "frontier", "gather", "apply", "activate", "converged",
          "finalize")
# The hooks that run inside the BSP loop (R2's scope, as the reference's
# traced body): init and finalize run once, outside it.
_BODY_HOOKS = ("frontier", "gather", "apply", "activate", "converged")


def _fake_errors() -> tuple:
    from torch._subclasses.fake_tensor import (
        DataDependentOutputException,
        DynamicOutputShapeException,
    )

    return DataDependentOutputException, DynamicOutputShapeException


def _finding(rule: str, message: str, location: str = "",
             hook: Optional[str] = None,
             severity: Optional[str] = None) -> Finding:
    return Finding(rule, severity or RULES[rule][0], message, location, hook)


def _def_site(prog, hook: Optional[str] = None) -> str:
    """``file:line`` of a hook override (or the program class): where a
    finding points when it is a property of the hook, not of one op."""
    try:
        obj = getattr(type(prog), hook) if hook else type(prog)
        obj = _src.unwrap(obj)
        file = _src.getsourcefile(obj)
        _, line = _src.getsourcelines(obj)
        return f"{file}:{line}"
    except (OSError, TypeError):
        return ""


def _overridden(prog, hook: str) -> bool:
    return getattr(type(prog), hook, None) is not \
        getattr(VertexProgram, hook, None)


class _TraceFail(Exception):
    """Internal: a fake-pass hook failed; the rest of the pass is off."""


def _run_fake(rec: Recorder, notes: list, hook: str, fn):
    """Run one hook of the fake pass.  A host read or a data-dependent
    shape raises on fake tensors: it becomes a sync event (R2 if the hook
    is in the loop) and ends the pass; any other failure becomes a note
    (the fake inputs are the analyzer's guess, the recorded superstep
    runs the hook for real)."""
    try:
        with rec.hook(hook):
            return fn()
    except _fake_errors() as e:
        rec.sync_at(f"a data-dependent value ({type(e).__name__})",
                    location_from_exception(e), hook)
        raise _TraceFail from e
    except Exception as e:  # noqa: BLE001 - becomes a coverage note
        if not any(ev.hook == hook for ev in rec.events):
            notes.append(f"{hook} not run on fake tensors: "
                         f"{type(e).__name__}: {e}")
        raise _TraceFail from e


# --------------------------------------------------------------------------
# individual rules
# --------------------------------------------------------------------------
def _rule_r1(rec: Recorder, m: int) -> List[Finding]:
    return [_finding(
        "R1", f"O(m)-shaped tensor {e.what} on the device under "
              f"residency='host' (m={m}; edge-sized data must stream)",
        e.location, e.hook) for e in rec.events if e.kind == "om"]


def _rule_r2(rec: Recorder) -> List[Finding]:
    return [_finding(
        "R2", f"host synchronization in the BSP superstep: {e.what} in "
              f"{e.hook}() waits for the device every superstep (keep the "
              "value a tensor)", e.location, e.hook)
        for e in rec.hook_events("sync", _BODY_HOOKS)]


def _rule_r3_hashability(prog, pol) -> List[Finding]:
    out = []
    for k in sorted(prog.__dict__):
        try:
            hash((k, prog.__dict__[k]))
        except TypeError:
            out.append(_finding(
                "R3", f"program config attribute {k!r} "
                      f"({type(prog.__dict__[k]).__name__}) is not "
                      "hashable: every run misses the analysis cache and "
                      "the run fingerprint cannot key on it",
                _def_site(prog), None))
    try:
        hash(pol)
    except TypeError:
        out.append(_finding(
            "R3", "policy is not hashable (a mutable value reached a "
                  "policy field): the analysis cache is defeated",
            _def_site(prog), None))
    return out


def _sig(leaf) -> Tuple[tuple, str]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).removeprefix("torch.")
    return (), type(leaf).__name__


def _structure(tree) -> list:
    return [p for p, _ in leaves_with_paths(tree)]


def _rule_r3_drift(before, after, hook: str, where: str,
                   what: str) -> List[Finding]:
    a_leaves, b_leaves = leaves_with_paths(before), leaves_with_paths(after)
    if _structure(before) != _structure(after) \
            or type(before) is not type(after):
        return [_finding(
            "R3", f"{what} tree structure changes across supersteps "
                  f"({[p for p, _ in a_leaves]} -> "
                  f"{[p for p, _ in b_leaves]}): the loop cannot carry it",
            where, hook, severity="error")]
    out = []
    for (name, a), (_, b) in zip(a_leaves, b_leaves):
        (sa, da), (sb, db) = _sig(a), _sig(b)
        if sa != sb:
            out.append(_finding(
                "R3", f"{what} leaf {name} changes shape across "
                      f"supersteps: {da}{list(sa)} -> {db}{list(sb)} — "
                      "the loop cannot carry it", where, hook,
                severity="error"))
        elif da != db:
            out.append(_finding(
                "R3", f"{what} leaf {name} changes dtype across "
                      f"supersteps: {da}{list(sa)} -> {db}{list(sb)} — "
                      "the run carries another state than init declares "
                      "(make init produce the dtype the loop keeps)",
                where, hook, severity="warning"))
    return out


def _rule_r5_semiring(prog, sg, x_dtype) -> List[Finding]:
    sr = getattr(prog, "semiring", None)
    if sr is None:
        return []
    loc = _def_site(prog)
    if sr.combine not in ("add", "min", "max"):
        return [_finding("R5", f"unknown combine {sr.combine!r}: the "
                               "engine's scatter paths implement "
                               "add/min/max", loc)]
    d = x_dtype if x_dtype is not None else torch.tensor(sr.identity).dtype
    dname = str(d).removeprefix("torch.")
    ident = torch.tensor(sr.identity, dtype=d)
    out = []
    if d == torch.bool:
        probes = [False, True]
    elif not d.is_floating_point:
        probes = [0, 1, 2]
    else:
        probes = [-3.5, -1.0, 0.0, 1.0, 2.75]
    # identity law: combine(identity, v) == v
    for v in probes:
        got = sr.combine_elem(ident, torch.tensor(v, dtype=d))
        if not bool(got == v):
            out.append(_finding(
                "R5", f"identity {sr.identity!r} is not neutral for "
                      f"combine={sr.combine!r} at {dname}: "
                      f"combine(identity, {v!r}) == {got.item()} != "
                      f"{v!r} — skipped chunks and padding lanes would "
                      "corrupt results", loc))
            break
    # absorption: edge_op(identity, w) == identity (padding lanes vanish)
    weighted = bool(getattr(sg, "weighted", False))
    w = torch.tensor(2.0) if weighted else None
    try:
        got = sr.edge_op(ident, w)
        if not bool(got == ident):
            out.append(_finding(
                "R5", f"edge_op does not absorb the identity: "
                      f"edge_op({sr.identity!r}, {w}) == {got} — inactive "
                      "lanes would contribute non-identity terms", loc))
    except TypeError:
        pass
    # dtype stability of edge_op at the frontier dtype
    if x_dtype is not None:
        with contextlib.suppress(Exception):  # edge_op may reject a scalar
            y = sr.edge_op(torch.zeros((), dtype=d), w)
            if y.dtype != d:
                out.append(_finding(
                    "R5", f"edge_op changes dtype: {dname} -> "
                          f"{str(y.dtype).removeprefix('torch.')} — the "
                          "scatter accumulator is allocated at the "
                          "frontier dtype", loc))
    return out


def _rule_r6(out, rec: Recorder, hook_loc: str) -> List[Finding]:
    if isinstance(out, torch.Tensor) and rec.tainted(out):
        return []
    val = bool(torch.as_tensor(out).all())
    return [_finding(
        "R6", "converged() does not read carried state or the superstep's "
              f"activations: it is the constant {val!r}, decided before "
              "the run starts, so the loop "
              + ("exits at superstep 0" if val else
                 "can only stop at the superstep budget"),
        hook_loc, "converged")]


@contextlib.contextmanager
def _tainted_iostats(rec: Recorder):
    """While active, every IOStats built carries fresh, tainted copies of
    ``x_fetches`` and ``host_bytes``.  ``IOStats(...)``, ``zero()`` and
    ``__add__`` build through ``__new__``, ``_replace`` through ``_make``:
    both are wrapped, so the taint marks the schedule-sensitive slots at
    their source (the copies keep the other fields, which may share one
    zero tensor, untainted)."""
    orig_new, raw_make = IOStats.__new__, IOStats.__dict__["_make"]
    orig_make = IOStats._make

    def mark(fields):
        fields = list(fields)
        for i in (6, 7):  # x_fetches, host_bytes
            if isinstance(fields[i], torch.Tensor):
                fields[i] = fields[i].clone()
                rec.taint(fields[i])
        return fields

    def tainted_new(cls, *fields, **kw):
        full = list(fields) + [kw[f] for f in IOStats._fields[len(fields):]
                               if f in kw]
        if len(full) < len(IOStats._fields):  # defaults: retries, queries
            return orig_new(cls, *fields, **kw)
        return orig_new(cls, *mark(full))

    IOStats.__new__ = tainted_new
    IOStats._make = classmethod(lambda cls, it: orig_make(mark(it)))
    try:
        yield
    finally:
        IOStats.__new__ = orig_new
        IOStats._make = raw_make


def _rule_r4(prog, state, io, rec: Recorder) -> List[Finding]:
    names = [(f"state{p}", leaf, False)
             for p, leaf in leaves_with_paths(state)] \
        + [(f"IOStats.{f}", v, f in ("x_fetches", "host_bytes"))
           for f, v in zip(IOStats._fields, io)]
    hook = "gather" if _overridden(prog, "gather") else (
        "activate" if _overridden(prog, "activate") else None)
    where = _def_site(prog, hook) if hook else _def_site(prog)
    out = []
    for name, leaf, ok in names:
        if not ok and rec.tainted(leaf):
            kind = "order-invariant IOStats field" \
                if name.startswith("IOStats") else "program state leaf"
            out.append(_finding(
                "R4", f"{kind} {name} depends on the schedule-sensitive "
                      "counters (x_fetches/host_bytes): its value would "
                      "change with tile/batch order, breaking the "
                      "order-invariant ledger contract", where, hook))
    return out


# --------------------------------------------------------------------------
# the two passes
# --------------------------------------------------------------------------
def _fake_pass(prog, sg, pol, seeds, rec, findings, notes, sites):
    """The O(n) hooks on fake tensors.  Returns the frontier's ``x``
    dtype (R5), or None when the pass did not get that far."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    x_dtype = None
    with FakeTensorMode(allow_non_fake_inputs=True):
        try:
            s0 = _run_fake(rec, notes, "init", lambda: prog.init(sg, seeds))
            fr = _run_fake(rec, notes, "frontier",
                           lambda: prog.frontier(sg, s0))
            x_dtype = fr.x.dtype
            gathered = torch.empty_like(fr.x)
            if _overridden(prog, "gather"):
                notes.append("fake pass: apply ran on a gathered value "
                             "shaped as the frontier's x (gather is "
                             "overridden; the recorded superstep runs it)")
            s1, act = _run_fake(rec, notes, "apply",
                                lambda: prog.apply(sg, s0, gathered))
            findings += _rule_r3_drift(s0, s1, "apply", sites["apply"],
                                       "state carry")
            _run_fake(rec, notes, "converged",
                      lambda: prog.converged(sg, s1, act))
            _run_fake(rec, notes, "finalize", lambda: prog.finalize(sg, s1))
        except _TraceFail:
            pass
    return x_dtype


def _real_pass(prog, sg, pol, seeds, rec, findings, notes, sites,
               body: bool) -> None:
    """One superstep for real, recorded (rules R1, R2, R3 drift, R4 on a
    device view, R6)."""
    before = kernel_launches()
    with rec.hook("init"):
        s0 = prog.init(sg, seeds)
    with rec.hook("frontier"):
        fr = prog.frontier(sg, s0)
    with _tainted_iostats(rec) if body else contextlib.nullcontext():
        with rec.hook("gather"):
            gathered, st = prog.gather(sg, s0, fr, pol)
        with rec.hook("apply"):
            s2, act = prog.apply(sg, s0, gathered)
        with rec.hook("activate"):
            s3, st2 = prog.activate(sg, s2, pol)
            io = st if st2 is None else st + st2
    if body:
        findings += _rule_r4(prog, s3, io, rec)
    findings += _rule_r3_drift(s0, s3, "apply", sites["apply"],
                               "state carry")
    findings += _rule_r3_drift(IOStats.zero(), io, "gather",
                               sites["gather"], "IOStats carry")
    rec.clear_taint()
    for _, leaf in leaves_with_paths((s3, act)):
        rec.taint(leaf)
    with rec.hook("converged"):
        done = prog.converged(sg, s3, act)
    findings += _rule_r6(done, rec, sites["converged"])
    rec.clear_taint()
    ran = {k: v - before.get(k, 0) for k, v in kernel_launches().items()
           if v != before.get(k, 0)}
    notes.append(
        "gather/activate reach the engine, so one superstep ran for real "
        "under the recorder (engine frames exempt); kernel launches in it: "
        + (", ".join(f"{k} {v}" for k, v in sorted(ran.items()))
           if ran else "none"))


# --------------------------------------------------------------------------
# analyze()
# --------------------------------------------------------------------------
_ANALYSIS_CACHE: "OrderedDict[Any, Tuple[Any, AnalysisReport]]" = \
    OrderedDict()
_ANALYSIS_CACHE_SIZE = 32


def _seeds_key(seeds):
    """A hashable key for ``seeds``: tensors and arrays by their bytes
    (a tensor hashes by identity, so its content must be the key)."""
    if seeds is None:
        return None
    leaves = leaves_with_paths(seeds)
    if not any(isinstance(v, (torch.Tensor, np.ndarray)) for _, v in leaves):
        try:
            hash(seeds)
            return seeds
        except TypeError:
            pass
    key = []
    for p, v in leaves:
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        key.append((p, a.shape, str(a.dtype), a.tobytes()))
    return tuple(key)


def _resolve_view(graph, prog, pol):
    if callable(getattr(graph, "_sem", None)) \
            and hasattr(graph, "host_view"):
        return graph._sem(pol, prog)
    return graph


def analyze(program, graph, policy: Optional[ExecutionPolicy] = None, *,
            seeds=None) -> AnalysisReport:
    """Check ``program`` against the SEM contracts it would run under on
    ``graph`` with ``policy``.

    ``graph`` may be a :class:`repro_torch.Graph` session (the view is
    resolved as ``Graph.run`` resolves it), a device
    :class:`~repro_torch.core.SemGraph` or a host
    :class:`~repro_torch.core.residency.HostGraph`; the analysis runs on
    that view's device.  ``seeds`` go to ``program.init``.  Results are
    cached per ``(view, program config, policy, seeds)``, so
    ``Graph.run(analyze=True)`` in a loop pays the analysis once.
    """
    prog = program() if isinstance(program, type) else program
    pol = policy if policy is not None else prog.default_policy
    pol = pol if pol is not None else ExecutionPolicy()
    sg = _resolve_view(graph, prog, pol)
    try:
        key = (id(sg), type(prog), tuple(sorted(prog.__dict__.items())),
               pol, _seeds_key(seeds))
        hit = _ANALYSIS_CACHE.get(key)
    except TypeError:
        key = hit = None
    if hit is not None:
        _ANALYSIS_CACHE.move_to_end(key)
        return hit[1]
    report = _analyze_uncached(prog, sg, pol, seeds)
    if key is not None:
        _ANALYSIS_CACHE[key] = (sg, report)  # sg ref pins id(sg) live
        while len(_ANALYSIS_CACHE) > _ANALYSIS_CACHE_SIZE:
            _ANALYSIS_CACHE.popitem(last=False)
    return report


def _analyze_uncached(prog, sg, pol, seeds) -> AnalysisReport:
    findings: List[Finding] = []
    notes: List[str] = []
    is_host = bool(getattr(sg, "is_host_view", False)) \
        or pol.residency == "host"
    mode = "hooks" if is_host else "body"
    polname = (f"ExecutionPolicy(backend={pol.backend!r}, "
               f"direction={pol.direction!r}, residency={pol.residency!r})")
    if is_host:
        notes.append("mode=hooks (residency='host'): R4 is covered by the "
                     "runtime order-invariance parity gates")

    pol = prog.prepare_policy(sg, pol)
    findings += _rule_r3_hashability(prog, pol)
    n, m = int(sg.n), int(sg.m)
    sites = {h: _def_site(prog, h) for h in _HOOKS}
    watch = pol.residency == "host"
    if watch and (m <= 1 or m == n):
        notes.append("R1 skipped: m and n are indistinguishable on this "
                     f"graph (n={n}, m={m})")
        watch = False

    def recorder():
        return Recorder(m=m if watch else None, device=sg.device)

    rec = recorder()
    x_dtype = _fake_pass(prog, sg, pol, seeds, rec, findings, notes, sites)
    r1 = _rule_r1(rec, m)
    findings += r1 + _rule_r2(rec)
    if r1:
        notes.append("the recorded superstep did not run: it would "
                     "allocate the O(m) tensors R1 reports; rules R4 and "
                     "R6 skipped")
    else:
        rec = recorder()
        _real_pass(prog, sg, pol, seeds, rec, findings, notes, sites,
                   body=not is_host)
        findings += _rule_r1(rec, m) + _rule_r2(rec)
    findings += _rule_r5_semiring(prog, sg, x_dtype)

    seen, uniq = set(), []
    for f in sorted(findings, key=lambda f: (f.rule, f.location, f.message)):
        k = (f.rule, f.location, f.message)
        if k not in seen:
            seen.add(k)
            uniq.append(f)
    return AnalysisReport(program=type(prog).__name__, policy=polname,
                          mode=mode, findings=tuple(uniq),
                          notes=tuple(notes))
