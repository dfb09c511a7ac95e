"""Every public name of the JAX package's subpackages is served by the port's
counterpart (ROADMAP §C P25): each name in a reference package's
``__all__`` must be in the port's ``__all__`` and importable from it, save
the deliberate exceptions of ``ALLOWED``, each with its reason.  The
modules the training, multi-card and dry-run slices port are held the
same way (a reference module without ``__all__``, such as
``models/shard_ctx.py``, by the functions and classes it defines).
"""
import importlib
import os

import pytest

PACKAGES = ("", "algs", "analysis", "checkpoint", "configs", "core", "data",
            "graph", "kernels.decode_attn", "kernels.spmv", "models", "optim")
MODULES = ("data.pipeline", "distributed.sharding", "launch.dryrun",
           "launch.mesh", "launch.patch_probe", "launch.report",
           "launch.roofline", "launch.specs", "launch.steps", "launch.train",
           "models.flash", "models.moe", "models.shard_ctx", "optim.adamw",
           "optim.compress")

# (module, name): why the port does not serve it
ALLOWED = {
    ("kernels.decode_attn", "decode_attention_ref"):
        "the port calls it decode_attention_plain (ROADMAP §C P7)",
    ("kernels.spmv", "default_interpret"):
        "Pallas interpret mode has no counterpart on the card (§C P4)",
}


def _public(module) -> list:
    """``__all__``, or, for a module without one, the functions and classes
    it defines under public names."""
    if hasattr(module, "__all__"):
        return list(module.__all__)
    return [n for n, v in vars(module).items() if not n.startswith("_")
            and callable(v) and getattr(v, "__module__", None)
            == module.__name__]


def _import_reference(name: str):
    """``repro.<name>``, with ``XLA_FLAGS`` as it was: the reference's dry
    run and patch probe set it when imported, and it would reach the
    subprocesses of other test files on this worker."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro" + name)
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def _missing(name: str) -> list:
    suffix = "." + name if name else ""
    ref = _import_reference(suffix)
    port = importlib.import_module("repro_torch" + suffix)
    served = set(getattr(port, "__all__", ()))
    out = []
    for public in _public(ref):
        if (name, public) in ALLOWED:
            continue
        if public not in served or not hasattr(port, public):
            out.append(public)
    return out


@pytest.mark.parametrize("name", PACKAGES + MODULES)
def test_port_serves_every_public_name(name):
    assert _missing(name) == [], name


def test_allowed_exceptions_are_still_missing():
    """An exception that the port has since closed must leave the list."""
    for (name, public), why in ALLOWED.items():
        port = importlib.import_module("repro_torch." + name)
        assert public not in getattr(port, "__all__", ()), (name, public, why)
