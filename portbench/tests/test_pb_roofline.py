"""The roofline yardstick reproduces the bench shape's bounds (4096 x
1024, 360 degrees, zfar 40 km over a 3400^2 grid at 34.3 degrees, the
viewer at its centre): 708,651 DEM cells, a march of 12.40 MB and a
resolve of 47.25 MB."""

import math

import pytest

from portbench import roofline


def test_bench_shape_bytes():
    cells = roofline.reached_cells(3400, [1700.0], [1700.0], 40000.0, 1200,
                                   34.3)
    assert cells == 708651
    march = roofline.march_bound_s(3400, [1700.0], [1700.0], width=4096,
                                   zfar_m=40000.0, cpd=1200, lat_deg=34.3)
    assert march * roofline.HBM_BYTES_PER_S == pytest.approx(12.40e6,
                                                             abs=5e3)
    res = roofline.resolve_bound_s(3400, 1, width=4096, height=1024,
                                   zfar_m=40000.0, cpd=1200, lat_deg=34.3)
    assert res * roofline.HBM_BYTES_PER_S == pytest.approx(47.25e6, abs=5e3)


def test_union_and_windows():
    one = roofline.reached_cells(600, [300.0], [300.0], 5000.0, 1200, 34.3)
    assert roofline.reached_cells(600, [300.0, 300.0], [300.0, 300.0],
                                  5000.0, 1200, 34.3) == one
    half = roofline.reached_cells(600, [300.0], [300.0], 5000.0, 1200, 34.3,
                                  az0=[0.0], az1=[180.0])
    assert abs(half - one / 2) < 0.02 * one
    cell_n = 6371000.0 * math.pi / 180.0 / 1200
    disc = math.pi * (5000.0 / cell_n) ** 2 / math.cos(math.radians(34.3))
    assert abs(one - disc) < 0.01 * disc
