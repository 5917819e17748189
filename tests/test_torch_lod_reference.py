"""The port's LOD render against the benchmark's plain reference of it
(``portbench/reference/render_lod.py``), and the LOD march's spans and
counter.

On one seeded SRTM1 tile (the benchmark's SRTM1 relief) at 64 columns and a
41 km clip, which needs 1600 crossing steps, so the API swaps to the LOD
march:

- the API's render at two viewpoints, and ``render_panorama`` on a
  3200^2 grid whose plan has five levels, bitwise on image and ranges
  against the reference (the port's CPU path runs the kernels' plain
  versions, which the card's kernels equal bit for bit);
- the reference's level march on each level's crop against the same
  march on the level's whole grid: the viewer's rebase by whole cells
  and every distance are exact, the tangents need not be (the cross
  positions round at the grid's magnitude; some differ in their last
  bits), which is why the reference crops as the program does;
- ``hz.lod.renders`` counts each LOD render's viewpoints and nothing on
  the window path; the spans nest ``hz.render.march > hz.lod.march >
  hz.lod.level > hz.lod.crop``, the pyramid's build under the plan on the
  first render only, and a LOD render syncs twice, as a window render.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from horizonator_tpu_torch import horizonator, profiling
from horizonator_tpu_torch.render import lod, make_params, render_panorama
from portbench import terrain
from portbench.loader import load_module
from portbench.reference import render as ref
from portbench.reference import render_lod
from portbench.reference.dem import Window

REPO = Path(__file__).resolve().parent.parent
CPD = 3600
VIEW = (34.4278, -117.2944)      # a ridge of the seeded tile (~1050 m)
RADIUS, ZFAR, W, H = 800, 41000.0, 64, 64
AZ = (-30.0, 30.0)        # rows of 0.94 degrees: the far bands show
SEED = 2 ** 31 + 29
LAT_HINT, LAT_PLAN, ZNEAR_HINT = 30.0, 35.0, 128.0


@pytest.fixture(scope="module")
def tile(tmp_path_factory):
    """(mosaic, directory) of the seeded tile N34W118."""
    grid = load_module(REPO / "portbench/drivers/render_api_lod.py").mosaic(
        SEED, 1, 1, CPD)
    d = tmp_path_factory.mktemp("srtm1")
    terrain.write_tiles(grid, 34, -118, CPD, d)
    return grid, str(d)


@pytest.fixture(scope="module")
def api(tile):
    return horizonator(*VIEW, W, H, SRTM1=True, dir_dems=tile[1],
                       render_radius_cells=RADIUS, device="cpu",
                       strict_coverage=True)


def _view(win, lat, lon):
    ci, cj = win.cell(lat, lon)
    return ref.make_view("cpu", vi=ci, vj=cj, vz=win.viewer_z(lat, lon),
                         cos_lat=math.cos(math.radians(lat)),
                         az0=math.radians(AZ[0]), az1=math.radians(AZ[1]),
                         znear=100.0, zfar=ZFAR,
                         znear_color=100.0, zfar_color=ZFAR)


def _farthest_m(img) -> float:
    """The farthest terrain an image shows, m, from its red ramp (znear to
    zfar over 0-255), to within a step of the ramp."""
    return 100.0 + (ZFAR - 100.0) * (int(img[..., 2].max()) - 1) / 255.0


@pytest.mark.parametrize("move", [(0.0, 0.0), (0.031, -0.027)])
def test_api_render_equals_reference(tile, api, move):
    lat, lon = VIEW[0] + move[0], VIEW[1] + move[1]
    img, rng = api.render(*AZ, lat=lat, lon=lon, zfar=ZFAR)
    assert api._batch_render_plan(100.0, ZFAR)[1] == "lod"
    win = Window(tile[0], 34, -118, CPD, *VIEW, RADIUS)
    img_r, rng_r = render_lod.render(
        torch.from_numpy(win.grid.astype(np.float32)), _view(win, lat, lon),
        width=W, height=H, cells_per_deg=CPD, lat_hint_deg=LAT_HINT,
        lat_plan_deg=LAT_PLAN, znear_hint_m=ZNEAR_HINT)
    assert (rng > 0).mean() > 0.3
    assert _farthest_m(img) > api._batch_render_plan(100.0, ZFAR)[3][-1].d_lo
    np.testing.assert_array_equal(img, img_r.numpy())
    np.testing.assert_array_equal(rng, rng_r.numpy())


# the ridge of VIEW in the (3200, 3200) grid of _grid
VI, VJ = 2340.37, 1340.81


def _grid(tile, n):
    """The (n, n) float32 grid at the tile's centre."""
    o = (CPD + 1 - n) // 2
    return torch.from_numpy(tile[0][o:o + n, o:o + n].astype(np.float32))


def test_five_level_plan_equals_reference(tile):
    n = 3200
    dem = _grid(tile, n)
    plan = lod.lod_plan(ZFAR, W, CPD, LAT_PLAN, n)
    assert len(plan) == 5
    assert plan == render_lod.plan(ZFAR, W, CPD, LAT_PLAN, n)
    vi, vj = VI, VJ
    vz = float(dem[int(vj):int(vj) + 2, int(vi):int(vi) + 2].max()) + 1.0
    p = make_params(device="cpu", viewer_cell_i=vi, viewer_cell_j=vj,
                    viewer_z=vz, cos_viewer_lat=math.cos(math.radians(34.3)),
                    az_rad0=math.radians(AZ[0]), az_rad1=math.radians(AZ[1]),
                    znear=100.0,
                    zfar=ZFAR, znear_color=100.0, zfar_color=ZFAR)
    img, rng = render_panorama(
        lod.build_pyramid(dem, 5), p, width=W, height=H, nsteps=0,
        cells_per_deg=CPD, sampler="lod", lat_hint_deg=LAT_HINT,
        lod_plan=plan, znear_hint_m=ZNEAR_HINT)
    v = ref.make_view("cpu", vi=vi, vj=vj, vz=vz,
                      cos_lat=math.cos(math.radians(34.3)),
                      az0=math.radians(AZ[0]), az1=math.radians(AZ[1]),
                      znear=100.0, zfar=ZFAR,
                      znear_color=100.0, zfar_color=ZFAR)
    img_r, rng_r = render_lod.render(
        dem, v, width=W, height=H, cells_per_deg=CPD, lat_hint_deg=LAT_HINT,
        lat_plan_deg=LAT_PLAN, znear_hint_m=ZNEAR_HINT)
    assert _farthest_m(img.numpy()) > plan[-1].d_lo
    assert torch.equal(img, img_r) and torch.equal(rng, rng_r)


def test_crop_against_whole_grid(tile):
    """Each level's march on its crop and on the whole level grid: the
    rebased viewer and every distance bitwise; the tangents within the
    rounding of a cross position at the whole grid's magnitude (2 ulp of
    n cells, times the steepest cell-to-cell rise, over the shortest
    distance), and valid at the same samples."""
    n = 3200
    dem = _grid(tile, n)
    bands = render_lod.plan(ZFAR, W, CPD, LAT_PLAN, n)
    levels = render_lod.pyramid(dem, len(bands))
    v = ref.make_view("cpu", vi=VI, vj=VJ,
                      vz=float(dem[int(VJ), int(VI)]) + 1.0,
                      cos_lat=math.cos(math.radians(34.3)),
                      az0=math.radians(AZ[0]), az1=math.radians(AZ[1]),
                      znear=100.0, zfar=ZFAR,
                      znear_color=100.0, zfar_color=ZFAR)
    az = ref.column_az(v, W)
    cropped = 0
    for i, lv in enumerate(bands):
        cpd_l = CPD / 2 ** lv.level
        grid = levels[lv.level]
        v_l = render_lod.level_view(v, lv)
        c = render_lod.crop_size(lv, cpd_l, LAT_HINT)
        grid_c, v_c = render_lod.crop(grid, v_l, c)
        cropped += grid_c.shape[0] < grid.shape[0]
        off = (v_l.vi - v_c.vi, v_l.vj - v_c.vj)
        assert all(float(o) == int(o) for o in off)
        assert torch.equal(v_c.vi + off[0], v_l.vi)
        kw = dict(cells_per_deg=cpd_l, near=i == 0, lat_hint_deg=LAT_HINT,
                  znear_hint_m=ZNEAR_HINT)
        seg_c, geo_c, hi_c = render_lod.march_level(grid_c, v_c, az, lv,
                                                    **kw)
        seg_w, geo_w, hi_w = render_lod.march_level(grid, v_l, az, lv, **kw)
        assert torch.equal(geo_c.e, geo_w.e)
        assert torch.equal(geo_c.scale, geo_w.scale)
        assert torch.equal(hi_c, hi_w)
        valid = seg_w > -1e38
        assert torch.equal(seg_c > -1e38, valid) and valid.any()
        rise = float((grid[1:] - grid[:-1]).abs().max().clamp(min=1.0))
        tol = 2 * n * 2.0 ** -23 * rise / 100.0
        assert float((seg_c - seg_w)[valid].abs().max()) <= tol
    assert cropped >= 3


def test_lod_counter_and_spans(api):
    """A LOD render counts 1 in ``hz.lod.renders`` and nests its spans
    under ``hz.render.march``; a window render counts nothing there."""
    api._pyramid = None
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        api.render(*AZ, zfar=ZFAR)
        api.render(*AZ, zfar=ZFAR)
    snap = profiling.snapshot()
    profiling.reset()
    edges = set()
    for e in prof.events():
        if e.name.startswith("hz.") and e.device_type.name == "CPU":
            p = e.cpu_parent
            while p is not None and not p.name.startswith("hz."):
                p = p.cpu_parent
            edges.add((p and p.name, e.name))
    assert {("hz.api.render", "hz.render.march"),
            ("hz.render.march", "hz.lod.march"),
            ("hz.lod.march", "hz.lod.level"),
            ("hz.lod.level", "hz.lod.crop"),
            ("hz.lod.level", "hz.kernels.march"),
            ("hz.lod.level", "hz.render.near_band"),
            ("hz.api.plan", "hz.lod.pyramid")} <= edges
    assert ("hz.api.render", "hz.render.geometry") not in edges
    spans, counters = snap["spans"], snap["counters"]
    assert counters["hz.lod.renders"] == (2, 2)
    assert counters["hz.host_syncs"] == (4, 4)
    assert spans["hz.lod.march"][0] == 2
    assert spans["hz.lod.level"][0] == spans["hz.lod.crop"][0] == 8
    assert spans["hz.render.near_band"][0] == 2
    assert spans["hz.lod.pyramid"][0] == 1       # built on the first only
    assert api._pyramid is not None and len(api._pyramid) == 4

    with profile(activities=[ProfilerActivity.CPU]):
        api.render(*AZ, zfar=5000.0)
    snap = profiling.snapshot()
    profiling.reset()
    assert "hz.lod.renders" not in snap["counters"]
    assert "hz.lod.march" not in snap["spans"]
    assert snap["spans"]["hz.render.geometry"][0] == 1
