"""Every public name of the JAX package's subpackages is served by the port's
counterpart (ROADMAP §C P25): each name in a reference package's
``__all__`` must be in the port's ``__all__`` and importable from it, save
the deliberate exceptions of ``ALLOWED``, each with its reason.  The
modules the training slice ports are held the same way.
"""
import importlib

import pytest

PACKAGES = ("", "algs", "analysis", "checkpoint", "configs", "core", "data",
            "graph", "kernels.decode_attn", "kernels.spmv", "models", "optim")
MODULES = ("data.pipeline", "launch.steps", "launch.train", "models.flash",
           "optim.adamw", "optim.compress")

# (module, name): why the port does not serve it
ALLOWED = {
    ("kernels.decode_attn", "decode_attention_ref"):
        "the port calls it decode_attention_plain (ROADMAP §C P7)",
    ("kernels.spmv", "default_interpret"):
        "Pallas interpret mode has no counterpart on the card (§C P4)",
    ("optim", "compressed_psum"):
        "a multi-card collective, ported with ROADMAP §A A15.4",
    ("optim.compress", "compressed_psum"):
        "a multi-card collective, ported with ROADMAP §A A15.4",
}


def _missing(name: str) -> list:
    suffix = "." + name if name else ""
    ref = importlib.import_module("repro" + suffix)
    port = importlib.import_module("repro_torch" + suffix)
    served = set(getattr(port, "__all__", ()))
    out = []
    for public in ref.__all__:
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
