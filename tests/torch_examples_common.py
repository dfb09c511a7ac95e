"""Shared set-up of ``tests/test_torch_examples_graph.py`` and
``tests/test_torch_examples_lm.py`` (not a test file).

The twins in ``examples_torch/`` print their results; the tests hold the
values behind those lines, which ``example_recording.Recorded`` keeps (the
examples phase of ``chip_smoke.py`` holds them on the card the same way).
``example_recording.load_example`` loads an example script by path.
"""
import pathlib

import pytest
import torch

from example_recording import Recorded, load_example  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
TWINS = ("batched_queries", "custom_program", "graph_analytics",
         "quickstart", "serve_lm", "train_lm")
PR_TOL = dict(atol=1e-6, rtol=1e-5)  # ROADMAP §C P17 (and P2/P5's values)


def io_fields(io) -> dict:
    return {f: int(v) for f, v in zip(io._fields, io)}


def assert_io_equal(a, b, skip=("queries",)):
    """``tests/test_api.py::assert_io_equal``'s rule across the packages:
    every counter but the batch-width label ``queries`` equal."""
    fa, fb = io_fields(a), io_fields(b)
    for f in fa:
        if f not in skip:
            assert fa[f] == fb[f], f"IOStats.{f}: {fa[f]} != {fb[f]}"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one intra-op thread for the module: the twins' tensors are
    small, and beside the other test workers a pool of threads a process
    oversubscribes the cores (the LM file's serve runs took six times as
    long there)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
