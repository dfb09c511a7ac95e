"""The LM twins of ``examples/`` (``examples_torch/serve_lm.py`` and
``train_lm.py``) on the CPU, and what every twin must keep: no import of
``jax``, ``repro`` or ``examples/``, and the card as its default device.

``serve_lm``'s printed outputs are the port's ``serve_batch`` at the same
arguments, and its schedule (requests, tokens, decode steps: what the
random weights do not decide) the reference's ``serve_batch``.
``train_lm`` runs a short schedule here; the card runs the reference's 300
steps (``chip_smoke.py``'s examples phase).
"""
import ast
import contextlib
import io
import math

import pytest
import torch

import repro.launch.serve as ref_serve
import repro_torch.launch.serve as serve
from torch_examples_common import (  # noqa: F401 (one_thread: fixture)
    ROOT, TWINS, Recorded, load_example, one_thread)

SERVE_ARGS = dict(smoke=True, n_requests=8, max_batch=4, max_new=8)
SCHEDULE = ("requests", "tokens", "decode_steps")
TRAIN_STEPS = 24  # a crash at 8, a straggling step at 16


def _twin_main(name, argv, *, record=None):
    """(exit code, stdout, recorded calls of ``record`` in the twin's
    module) of a twin's ``main``."""
    mod = load_example(name)
    out = io.StringIO()
    with Recorded(mod, [record] if record else [], method=False) as rec, \
            contextlib.redirect_stdout(out):
        rc = mod.main(argv)
    return rc, out.getvalue(), rec.calls


@pytest.fixture(scope="module")
def served():
    rc, out, calls = _twin_main("serve_lm", ["--device", "cpu"],
                                record="serve_batch")
    assert rc == 0
    (call,) = calls
    assert call.args == ("gemma3-4b",)
    assert {k: call.kwargs[k] for k in SERVE_ARGS} == SERVE_ARGS
    return out, call.result


def test_serve_lm_prints_the_ports_outputs(served):
    """The twin's request lines are the port's ``serve_batch`` at the
    reference's arguments, run again here."""
    out, _ = served
    want = serve.serve_batch("gemma3-4b", device="cpu", **SERVE_ARGS)
    lines = [f"request {rid}: {toks}"
             for rid, toks in sorted(want["outputs"].items())[:4]]
    assert [ln for ln in out.splitlines() if ln.startswith("request ")] \
        == lines


def test_serve_lm_schedule_equals_reference(served):
    """Requests, tokens and decode steps equal the reference's
    ``serve_batch`` at the same arguments; every request gets ``max_new``
    tokens."""
    _, res = served
    want = ref_serve.serve_batch("gemma3-4b", **SERVE_ARGS)
    assert {k: res[k] for k in SCHEDULE} == {k: want[k] for k in SCHEDULE}
    assert sorted(res["outputs"]) == sorted(want["outputs"])
    assert all(len(v) == SERVE_ARGS["max_new"]
               for v in res["outputs"].values())


def test_train_lm_short_run(tmp_path):
    """A short run of the twin: exit 0 (the loss fell and a restart
    happened), finite losses, at least one restart.  On one intra-op
    thread (``one_thread``), as
    ``tests/test_torch_train_step.py::test_train_loop_with_failures`` runs
    (the straggler detection times the steps)."""
    rc, out, calls = _twin_main(
        "train_lm", ["--steps", str(TRAIN_STEPS), "--ckpt",
                     str(tmp_path / "ckpt"), "--device", "cpu"],
        record="train_loop")
    assert rc == 0
    (call,) = calls
    res = call.result
    assert call.kwargs["inject_failures"] and call.kwargs["microbatches"] == 2
    assert math.isfinite(res["loss_first10"])
    assert math.isfinite(res["loss_last10"])
    assert res["restarts"] >= 1
    assert out.splitlines()[-1].endswith("OK")


# ------------------------------------------------------------ every twin
def _imports(name):
    tree = ast.parse((ROOT / "examples_torch" / f"{name}.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_neither_jax_nor_the_reference(name):
    """No import of ``jax``, ``repro`` or ``examples``; ``repro_torch``
    is imported."""
    mods = list(_imports(name))
    for mod in mods:
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "examples"), mod
    assert any(m.split(".")[0] == "repro_torch" for m in mods)


@pytest.mark.parametrize("name", TWINS)
def test_twin_defaults_to_the_card(monkeypatch, name):
    """With no ``--device`` a twin asks for the CUDA device and raises
    the port's no-card error where there is none (no CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        load_example(name).main([])
