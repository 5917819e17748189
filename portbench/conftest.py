"""pytest settings of the benchmark's own tests (portbench/tests).

``card``: a test that needs a CUDA card; whether one is present is decided
inside the ``card`` fixture, never while a module is imported. ``tiny``
gives a cell's files cut to sizes that the CPU runs in seconds.
"""

import copy

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


def tiny_files(cell: str, files=None) -> dict:
    """A cell's files (harness.resolve) with every size cut for the CPU:
    the warm-up and the traced window here, the rest by the driver's own
    ``tiny(mix, config)``."""
    from portbench import harness
    f = copy.deepcopy(files or harness.resolve(cell, harness.manifest()))
    f["mix"].update(warm_requests=1, warm_seconds=0.0, trace_seconds=1)
    harness.load_module(f["driver"]).tiny(f["mix"], f["config"])
    return f


@pytest.fixture
def tiny():
    return tiny_files
