"""A run whose timed path is broken underneath comes out not correct: an
answer altered where it is produced (every cell), and half of a batch
left out with the rest standing in for it (the batch cells). Each cell's
driver names the faults it can have (``planted_faults``)."""

import pytest

from portbench import harness

MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def _faults(cell):
    return harness.load_module(
        harness.resolve(cell, MAN)["driver"]).planted_faults()


def _run_with(cell, fault, seed, tiny, monkeypatch):
    plant = _faults(cell)[fault]
    out, _ = harness.run_cell(
        cell, seed, 0.2, False, device="cpu", files=tiny(cell),
        setup_hook=lambda ctx, state: plant(monkeypatch))
    return out


@pytest.mark.parametrize("seed", [21, 2 ** 31 + 5])
@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer(cell, seed, tiny, monkeypatch):
    out = _run_with(cell, "altered", seed, tiny, monkeypatch)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize(
    "cell", [c for c in CELLS if "half_batch" in _faults(c)])
def test_half_batch(cell, tiny, monkeypatch):
    out = _run_with(cell, "half_batch", 22, tiny, monkeypatch)
    assert not out["correct"], out["check"]
