"""Recording what an example script computes, for the tests of
``examples_torch/`` (``tests/test_torch_examples_*.py``) and the examples
phase of ``chip_smoke.py``, which hold the values behind the twins'
printed lines.  Imports nothing but the standard library.
"""
import functools
import importlib.util
from pathlib import Path
from typing import Any, NamedTuple

ROOT = Path(__file__).resolve().parents[1]


def load_example(name: str, folder: str = "examples_torch"):
    """``<folder>/<name>.py`` loaded by path (every example guards its
    ``main``)."""
    spec = importlib.util.spec_from_file_location(
        f"{folder}_{name}", ROOT / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Call(NamedTuple):
    name: str
    owner: Any  # the instance of a recorded method, None for a function
    args: tuple
    kwargs: dict
    result: Any


class Recorded:
    """Within the ``with`` block, wraps ``target.<name>`` for each name
    (methods of a class when ``method``, else functions of a module) and
    keeps each outermost call as a :class:`Call` in ``calls`` (calls that
    a recorded call makes itself are not kept): the values behind an
    example's printed lines."""

    def __init__(self, target, names, method: bool = True):
        self.target, self.names, self.method = target, tuple(names), method
        self.calls: list = []

    def __enter__(self):
        self._saved = {n: getattr(self.target, n) for n in self.names}
        depth = [0]

        def wrap(name, fn):
            @functools.wraps(fn)
            def inner(*args, **kwargs):
                depth[0] += 1
                try:
                    res = fn(*args, **kwargs)
                finally:
                    depth[0] -= 1
                if depth[0] == 0:
                    owner, rest = ((args[0], args[1:]) if self.method
                                   else (None, args))
                    self.calls.append(Call(name, owner, rest, kwargs, res))
                return res

            return inner

        for name, fn in self._saved.items():
            setattr(self.target, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.target, name, fn)
