"""The port's SEM contract checker (``repro_torch.analysis``) against the
reference's (``repro.analysis``).

The reference's analyzer needs five ``jax.core`` names that JAX 0.9.0
moved (``Literal``, ``ClosedJaxpr``, ``Jaxpr``, ``jaxpr_as_fun`` to
``jax.extend.core``, ``trace_state_clean`` to ``jax._src.core``).  One
spawned subprocess restores them in that process only (an alias made in
this process would leak into other test files on the same worker), loads
``tests/test_analysis.py``'s fixture programs by path and returns the
reference's reports as JSON.  This file defines a torch twin of each
fixture; for every (fixture, policy) pair the port's report must have the
reference's multiset of ``(rule, severity, hook)`` and its ``mode``, but
for the divergences stated in ``DIVERGENCES``.  The rest of the
reference's analysis tests and the AST lint
(``python -m repro_torch.analysis.semlint``) are ported below.
"""
import json
import os
import subprocess
import sys
import textwrap
from collections import Counter
from typing import NamedTuple

import pytest
import torch

import repro_torch
from repro_torch import analysis
from repro_torch.analysis import AnalysisError
from repro_torch.analysis.inspect import leaves_with_paths
from repro_torch.core import MIN_PLUS, ExecutionPolicy
from repro_torch.core.semiring import Semiring
from repro_torch.graph.generators import rmat

pytestmark = pytest.mark.analysis

_THIS = os.path.abspath(__file__)
_REPO = os.path.dirname(os.path.dirname(_THIS))
_SRC = os.path.join(_REPO, "src")
_REF_TESTS = os.path.join(_REPO, "tests", "test_analysis.py")

HOST = ExecutionPolicy(residency="host", switch_fraction=None)
BACKENDS = ["scan", "compact", "blocked", "blocked_compact"]
RESIDENCIES = ["device", "host"]


def _policy(backend, residency):
    kw = {"backend": backend}
    if residency == "host":
        kw.update(residency="host", switch_fraction=None)
    return ExecutionPolicy(**kw)


@pytest.fixture(scope="module")
def g():
    return repro_torch.Graph(rmat(7, edge_factor=8, seed=11, symmetrize=True),
                             chunk_size=128, device="cpu")


class WState(NamedTuple):
    labels: torch.Tensor
    active: torch.Tensor


class GoodWCC(repro_torch.VertexProgram):
    """Min-label propagation; the known-clean baseline fixture."""

    semiring = MIN_PLUS

    def init(self, sg, seeds) -> WState:
        return WState(
            labels=torch.arange(sg.n, dtype=torch.float32, device=sg.device),
            active=torch.ones(sg.n, dtype=torch.bool, device=sg.device))

    def frontier(self, sg, s: WState) -> repro_torch.Frontier:
        return repro_torch.Frontier(x=s.labels, active=s.active)

    def apply(self, sg, s: WState, gathered):
        labels = torch.minimum(s.labels, gathered)
        changed = labels < s.labels
        return WState(labels, changed), changed


# --------------------------------------------------------------------------
# broken fixtures, one per rule (twins of tests/test_analysis.py's)
# --------------------------------------------------------------------------
class B1MaterializesEdges(GoodWCC):
    """R1: materializes an O(m) tensor on the device under
    residency='host'."""

    def apply(self, sg, s: WState, gathered):
        leak = torch.zeros(sg.m, device=sg.device)  # offends: R1
        labels = torch.minimum(s.labels, gathered) + leak.sum() * 0.0
        changed = labels < s.labels
        return WState(labels, changed), changed


class B2HostSync(GoodWCC):
    """R2: reads a device value to the host inside the superstep."""

    def apply(self, sg, s: WState, gathered):
        total = float(torch.sum(gathered))  # offends: R2
        labels = torch.minimum(s.labels, gathered + total * 0.0)
        changed = labels < s.labels
        return WState(labels, changed), changed


class B3WeakDrift(GoodWCC):
    """R3: init makes a float64 leaf, apply returns it as float32 (the
    port's counterpart of the reference's weak-type flip)."""

    def init(self, sg, seeds) -> WState:
        return WState(
            labels=torch.full((sg.n,), 1.0e9, dtype=torch.float64,
                              device=sg.device),
            active=torch.ones(sg.n, dtype=torch.bool, device=sg.device))

    def apply(self, sg, s: WState, gathered):
        labels = torch.minimum(s.labels, gathered).to(torch.float32)
        changed = labels < s.labels
        return WState(labels, changed), changed


class B4LedgerLeak(GoodWCC):
    """R4: an order-invariant IOStats field reads x_fetches."""

    def gather(self, sg, s: WState, fr, policy):
        gathered, st = super().gather(sg, s, fr, policy)
        return gathered, st._replace(records=st.records + st.x_fetches)


_BAD_SEMIRING = Semiring("bad_plus", combine="add", identity=1.0,
                         edge_op=lambda xv, w: xv if w is None else xv * w)


class B5UnlawfulSemiring(GoodWCC):
    """R5: combine='add' with identity=1.0 (not neutral)."""

    semiring = _BAD_SEMIRING


class B6ConstantConverged(GoodWCC):
    """R6: converged() ignores the carried state."""

    def converged(self, sg, s: WState, activated):
        return torch.tensor(False)


def _unhashable():
    p = GoodWCC()
    p.scratch = [1, 2, 3]  # a list attribute defeats the caches
    return p


FIXTURES = {
    "GoodWCC": GoodWCC,
    "B1MaterializesEdges": B1MaterializesEdges,
    "B2HostSync": B2HostSync,
    "B3WeakDrift": B3WeakDrift,
    "B4LedgerLeak": B4LedgerLeak,
    "B5UnlawfulSemiring": B5UnlawfulSemiring,
    "B6ConstantConverged": B6ConstantConverged,
    "unhashable": _unhashable,
}
# The rule each broken fixture must raise, and a phrase its message keeps.
EXPECT = {
    "B1MaterializesEdges": ("R1", "error", "O(m)"),
    "B2HostSync": ("R2", "error", "apply()"),
    "B3WeakDrift": ("R3", "warning", "dtype"),
    "B4LedgerLeak": ("R4", "error", "IOStats.records"),
    "B5UnlawfulSemiring": ("R5", "error", "not neutral"),
    "B6ConstantConverged": ("R6", "error", "converged()"),
}
# Broken fixtures whose rule does not apply under that policy, in both
# packages: R1 watches host residency only, and mode=hooks leaves R4 to
# the runtime gates.
CLEAN_HERE = {("B1MaterializesEdges", "default"), ("B4LedgerLeak", "host")}
SWEEP = {
    "BFSProgram": [0, 3],
    "PageRankPushProgram": None,
    "CorenessProgram": None,
    "GoodWCC": None,
}
FIXTURE_CASES = [(name, pol) for name in FIXTURES
                 for pol in ("default", "host")]
SWEEP_CASES = [(name, f"{b}-{r}") for name in SWEEP for b in BACKENDS
               for r in RESIDENCIES]

# Where the port departs from the reference's reports, and why.
DIVERGENCES = {
    ("B1MaterializesEdges", "host"):
        "the reference reports nothing on JAX 0.9.0 (mode=hooks, clean); "
        "the port reports the one R1 error that tests/test_analysis.py "
        "expects of it",
    ("B3WeakDrift", "*"):
        "torch has no weak types: the port's R3 message names the dtype "
        "change where the reference's names the weak_type flip",
}


def _case_policy(pol):
    if pol == "default":
        return None
    if pol == "host":
        return HOST
    return _policy(*pol.split("-"))


_REF_SCRIPT = textwrap.dedent(r"""
    import importlib.util, json, os, sys
    import jax
    import jax._src.core as _src_core
    import jax.extend.core as _ext_core
    # JAX 0.9.0 moved these five names; the reference's analyzer needs them.
    for name in ("Literal", "ClosedJaxpr", "Jaxpr", "jaxpr_as_fun"):
        setattr(jax.core, name, getattr(_ext_core, name))
    jax.core.trace_state_clean = _src_core.trace_state_clean

    spec = importlib.util.spec_from_file_location("ref_test_analysis",
                                                  sys.argv[1])
    ta = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = ta
    spec.loader.exec_module(ta)
    import repro
    from repro import analysis
    from repro.algs.bfs import BFSProgram
    from repro.algs.coreness import CorenessProgram
    from repro.algs.pagerank import PageRankPushProgram
    from repro.graph.generators import rmat

    g = repro.Graph(rmat(7, edge_factor=8, seed=11, symmetrize=True),
                    chunk_size=128)
    cases = json.loads(sys.argv[2])

    def program(name):
        if name == "unhashable":
            p = ta.GoodWCC()
            p.scratch = [1, 2, 3]
            return p
        return {"BFSProgram": BFSProgram,
                "PageRankPushProgram": PageRankPushProgram,
                "CorenessProgram": CorenessProgram}.get(
                    name, getattr(ta, name, None))()

    def policy(pol):
        if pol == "default":
            return None
        if pol == "host":
            return ta.HOST
        return ta._policy(*pol.split("-"))

    out = {}
    for name, pol, seeds in cases:
        r = analysis.check(g, program(name), policy(pol), seeds=seeds)
        out[f"{name}|{pol}"] = {
            "mode": r.mode, "notes": list(r.notes),
            "findings": [[f.rule, f.severity, f.hook, f.location, f.message]
                         for f in r.findings]}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_reports():
    """The reference's reports for every fixture and sweep case, from one
    subprocess that restores the five moved ``jax.core`` names."""
    cases = [[n, p, None] for n, p in FIXTURE_CASES] \
        + [[n, p, SWEEP[n]] for n, p in SWEEP_CASES]
    env = dict(os.environ, PYTHONPATH=_SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT, _REF_TESTS, json.dumps(cases)],
        env=env, capture_output=True, text=True, timeout=120, cwd=_REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _offending_line(rule: str) -> int:
    """Line of this file that carries the ``# offends: <rule>`` marker."""
    with open(_THIS) as fh:
        for i, line in enumerate(fh, 1):
            if line.rstrip().endswith(f"# offends: {rule}"):
                return i
    raise AssertionError(rule)


def _triples(findings):
    return Counter((f[0], f[1], f[2]) for f in findings)


def _port_report(g, name, pol):
    prog = FIXTURES[name]() if name in FIXTURES else getattr(
        repro_torch.algs, name)()
    return analysis.check(g, prog, _case_policy(pol), seeds=SWEEP.get(name))


@pytest.mark.parametrize("name,pol", FIXTURE_CASES)
def test_fixture_reports_match_reference(g, ref_reports, name, pol):
    """Each fixture under the default and the host policy: the port's
    report against the reference's, and each broken fixture flagged with
    exactly its rule, pointing into this file."""
    rep = _port_report(g, name, pol)
    ref = ref_reports[f"{name}|{pol}"]
    port = [[f.rule, f.severity, f.hook, f.location, f.message]
            for f in rep.findings]
    assert rep.mode == ref["mode"] == ("hooks" if pol == "host" else "body")
    if (name, pol) in DIVERGENCES:
        assert ref["findings"] == [], ref
    elif (name, pol) in CLEAN_HERE:
        assert ref["findings"] == [] and port == [], rep.render()
    else:
        assert _triples(port) == _triples(ref["findings"]), rep.render()
    if name in EXPECT and (name, pol) not in CLEAN_HERE:
        rule, severity, phrase = EXPECT[name]
        assert len(rep.findings) == 1, rep.render()
        f = rep.findings[0]
        assert (f.rule, f.severity) == (rule, severity), rep.render()
        assert phrase in f.message, rep.render()
        assert os.path.basename(f.location.split(":")[0]) \
            == "test_torch_analysis.py", rep.render()
        if rule in ("R1", "R2"):
            assert f.location.endswith(f":{_offending_line(rule)}")
        if name == "B3WeakDrift":
            assert "weak_type" in ref["findings"][0][4]
    if name == "unhashable":
        assert any(f.rule == "R3" and "hashable" in f.message
                   for f in rep.findings), rep.render()
        assert any("hashable" in f[4] for f in ref["findings"])
    if name == "GoodWCC":
        assert rep.ok, rep.render()


@pytest.mark.parametrize("name,pol", SWEEP_CASES)
def test_builtin_sweep_matches_reference(g, ref_reports, name, pol):
    """The reference's no-false-positive sweep: BFS, PageRank push,
    coreness and GoodWCC stay clean on 4 backends x 2 residencies, in
    both packages, with the reference's mode."""
    rep = _port_report(g, name, pol)
    ref = ref_reports[f"{name}|{pol}"]
    assert ref["findings"] == [], ref
    assert rep.ok, rep.render()
    assert rep.mode == ref["mode"] \
        == ("hooks" if pol.endswith("host") else "body")


def test_divergences_are_stated():
    assert all(why for why in DIVERGENCES.values())


# --------------------------------------------------------------------------
# Graph.run(analyze=True) wiring and the cache
# --------------------------------------------------------------------------
def test_run_analyze_true_passes_clean_program(g):
    res = g.run(GoodWCC(), analyze=True)
    assert res.state.labels.shape == (g.n,)


def test_run_analyze_true_rejects_broken_program(g):
    with pytest.raises(AnalysisError) as ei:
        g.run(B6ConstantConverged(), analyze=True)
    assert ei.value.report.findings[0].rule == "R6"
    assert "R6" in str(ei.value)


def test_warnings_do_not_block_run(g):
    # B3's dtype drift is warning severity: analyze=True reports it in the
    # report but does not raise.
    rep = analysis.check(g, B3WeakDrift())
    assert rep.warnings and not rep.errors
    res = g.run(B3WeakDrift(), analyze=True)
    assert res.state.labels.shape == (g.n,)


def test_analysis_cache_hits(g):
    p = GoodWCC()
    r1 = analysis.check(g, p)
    r2 = analysis.check(g, p)
    assert r1 is r2  # cached per (view, program config, policy, seeds)
    r3 = analysis.check(g, repro_torch.algs.BFSProgram(),
                        seeds=torch.tensor([0, 3]))
    assert analysis.check(g, repro_torch.algs.BFSProgram(),
                          seeds=torch.tensor([0, 3])) is r3
    assert analysis.check(g, repro_torch.algs.BFSProgram(),
                          seeds=torch.tensor([0, 4])) is not r3


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("residency", RESIDENCIES)
def test_run_analyze_true_is_bit_equal(backend, residency):
    """``analyze=True`` leaves the run as it is: values, supersteps and all
    ten IOStats fields bit-equal to the same run without it (a fresh
    session each, so the analysis is not cached)."""
    pol = _policy(backend, residency)
    h = rmat(7, edge_factor=8, seed=11, symmetrize=True)
    for prog, seeds in ((GoodWCC(), None),
                        (repro_torch.algs.PageRankPushProgram(), None),
                        (repro_torch.algs.BFSProgram(), [0, 3])):
        a, b = [repro_torch.Graph(h, chunk_size=128, device="cpu").run(
            prog, policy=pol, seeds=seeds, analyze=x) for x in (False, True)]
        av, bv = leaves_with_paths(a.values), leaves_with_paths(b.values)
        assert [p for p, _ in av] == [p for p, _ in bv]
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(av, bv))
        assert int(a.supersteps) == int(b.supersteps)
        assert [int(x) for x in a.iostats] == [int(x) for x in b.iostats]


def test_notes_name_the_recorded_superstep(g):
    """A clean report says what it ran for real, and under host residency
    that R4 is left to the runtime gates, as the reference's notes do."""
    rep = analysis.check(g, GoodWCC(), _policy("blocked", "device"))
    assert any("one superstep ran for real" in n for n in rep.notes), \
        rep.notes
    host = analysis.check(g, GoodWCC(), HOST)
    assert any("R4 is covered by the runtime" in n for n in host.notes)


def test_r2_sees_syncs_the_fake_pass_cannot_reach(g):
    """Host reads after the first one, and data-dependent shapes, are
    recorded in the superstep that runs for real."""

    class TwoSyncs(GoodWCC):
        def apply(self, sg, s, gathered):
            k = int(torch.sum(s.active))  # offends: R2 first
            labels = torch.minimum(s.labels, gathered)
            moved = labels[labels < s.labels]  # offends: R2 second
            changed = labels < s.labels
            return WState(labels + 0 * k * moved.numel(), changed), changed

    rep = analysis.check(g, TwoSyncs())
    assert [f.rule for f in rep.findings] == ["R2", "R2"], rep.render()
    assert {f.hook for f in rep.findings} == {"apply"}


def test_port_analysis_runs_with_jax_and_repro_blocked():
    """The analyzer and the lint run with ``jax`` and ``repro`` made
    unimportable."""
    code = textwrap.dedent("""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):
                    raise ImportError(f'blocked: {name}')
        sys.meta_path.insert(0, Block())
        import repro_torch
        from repro_torch.analysis import semlint
        sys.exit(semlint.main(['--analyze', '--device', 'cpu']))
    """)
    env = dict(os.environ, PYTHONPATH=_SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "analyzer gate: 0 finding(s) across 32" in out.stdout


# --------------------------------------------------------------------------
# python -m repro_torch.analysis.semlint (AST lint)
# --------------------------------------------------------------------------
def _semlint(*args):
    env = dict(os.environ, PYTHONPATH=_SRC)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.semlint", *args],
        env=env, cwd=_REPO, capture_output=True, text=True, timeout=120)


def test_semlint_clean_on_port():
    r = _semlint()
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 finding(s)" in r.stdout


# The reference's two broken sources (tests/test_analysis.py), a torch
# source, and an engine dispatch that raises a bare ValueError.
_BROKEN = {
    "reference_s1_s2": ("bad_prog.py", """
        import numpy as np
        class Bad:
            def apply(self, sg, state, gathered):
                total = float(gathered.sum())
                arr = np.asarray(state)
                return state, total
        def tweak(pol):
            pol.backend = "scan"
    """, 3, {"S1": 2, "S2": 1}),
    "reference_s4": ("bad_clock.py", """
        import time
        from time import monotonic
        class Bad:
            def apply(self, sg, state, gathered):
                stamp = time.time()
                lease = monotonic() + 30.0
                return state, stamp + lease
        def fine():
            return time.perf_counter()  # eager scope: allowed
    """, 2, {"S4": 2}),
    "torch_s1": ("bad_torch.py", """
        import torch
        class Bad:
            def apply(self, sg, state, gathered):
                total = gathered.sum().item()
                rows = state.labels.tolist()
                host = gathered.cpu()
                n = int(sg.n)  # a graph dimension: fine
                return state, total + len(rows) + host.numel() + n
    """, 3, {"S1": 3}),
    "engine_s3": ("repro_torch/core/engine.py", """
        def dispatch(backend):
            raise ValueError(f"unknown backend {backend!r}")
    """, 1, {"S3": 1}),
}


@pytest.mark.parametrize("case", sorted(_BROKEN))
def test_semlint_flags_broken_source(tmp_path, case):
    name, src, rc, counts = _BROKEN[case]
    bad = tmp_path / name
    bad.parent.mkdir(parents=True, exist_ok=True)
    bad.write_text(textwrap.dedent(src))
    r = _semlint(str(bad))
    assert r.returncode == rc, r.stdout + r.stderr
    for rule, k in counts.items():
        assert r.stdout.count(f"{rule} ") == k, r.stdout


def test_semlint_analyze_gate_exits_zero():
    r = _semlint("--analyze", "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "analyzer gate: 0 finding(s) across 32" in r.stdout
    assert r.stdout.count(" clean") == 32
