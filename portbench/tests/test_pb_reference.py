"""At tiny sizes on the CPU, the plain reference agrees with the port's
CPU path (the kernels' plain versions) to the bit, through a whole run of
each cell, traced and not; the bfloat16 control fails every cell's
check."""

import pytest
import torch

from portbench import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees(cell, trace, tiny):
    f = tiny(cell)
    out, w = harness.run_cell(cell, 2 ** 31 + 17, 0.3, trace, device="cpu",
                              files=f)
    assert out["correct"], out["check"]
    assert all(v["value"] == 0.0 for v in out["check"].values())
    assert w.failed == 0 and w.kept
    want = [m["name"] for m, _ in (f["per_layer"] if trace
                                   else f["end_to_end"])]
    assert set(out["metrics"]) <= set(want)
    if trace:
        assert out["device"]["window_s"] > 0
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == set(want)
        assert all(v["value"] > 0 for v in out["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, tiny):
    """A run with the control in the program's place comes out not
    correct; the program's readings of the same outputs stay nought."""
    out, _ = harness.run_cell(cell, 3, 0.3, False, device="cpu",
                              files=tiny(cell), control_dtype=torch.bfloat16)
    assert not out["correct"], out["check"]
    assert all(v == 0.0 for v in out["program_check"].values())
    assert any(v["value"] > v["limit"] for v in out["check"].values())
    assert list(out)[-1] == "check"
