"""The viewshed resampler's kernel route on the CPU: ``resample_plain``, the
kernels' function op for op in plain PyTorch (the sorted columns, each
cell's own radius and its binary search, the quarter arcs' starts from
each viewpoint's window), stands in for the CUDA kernels through the route
the card takes (``ops/viewshed._contract_kernel``) and must equal the
torch route (``_contract_raster``, the tables) bitwise: rasters, guards and
counts. Also the wrapper's argument checks, the program's counter and span
on that route, and the benchmark's ``resample_kernel_pct.batch``. The
kernels themselves are held to both on the card
(tests/test_torch_viewshed_card.py, chip_smoke.py phase 25)."""

import math

import numpy as np
import pytest
import torch

from horizonator_tpu_torch import ops as tops
from horizonator_tpu_torch import profiling
from horizonator_tpu_torch.kernels import viewshed_resample as vr
from horizonator_tpu_torch.ops import viewshed as tview
from horizonator_tpu_torch.parallel import stack_params
from tests.test_torch_viewshed import (CPD, LAT, RASTERS, jparams, smooth_dem,
                                       tp, wall_dem)


def _kernel_route(monkeypatch):
    """CPU tensors take the card's route, ``resample_plain`` standing in
    for the launches."""
    monkeypatch.setattr(tview, "_kernel_route", lambda dem, plain: not plain)
    monkeypatch.setattr(tview, "resample", vr.resample_plain)


def _both(call, monkeypatch):
    """call() on the torch route, then on the kernel route."""
    torch_out = call()
    _kernel_route(monkeypatch)
    try:
        return torch_out, call()
    finally:
        monkeypatch.undo()


CONTRACT = [r for r in RASTERS if r[4]["method"] != "gather"]


@pytest.mark.parametrize("name,viewer,window,center,opts", CONTRACT,
                         ids=[r[0] for r in CONTRACT])
def test_rendition_equals_torch_route(name, viewer, window, center, opts,
                                      monkeypatch):
    """test_torch_viewshed's contract rasters (smooth terrain, both
    frames, partial windows, triangulated, the viewer near the edge):
    raster and guard bitwise."""
    cos_lat = math.cos(math.radians(LAT))
    az = {} if window is None else dict(az0=math.radians(window[0]),
                                        az1=math.radians(window[1]))
    p = tp(jparams(*viewer, 1400.0, zfar=8000.0, cos_lat=cos_lat, **az))
    dem = torch.from_numpy(smooth_dem(300))
    kw = dict(width=256, nsteps=256, cells_per_deg=CPD, sampler="window",
              out_halfwidth=80, lat_hint_deg=LAT, out_center_ij=center,
              with_dropped=True, **opts)
    (v0, g0), (v1, g1) = _both(lambda: tops.viewshed_grid(dem, p, **kw),
                               monkeypatch)
    assert torch.equal(v0, v1) and torch.equal(g0, g1)
    assert v1.any() and not v1.all()


@pytest.mark.parametrize("center", [None, (135.0, 160.0)],
                         ids=["centred", "fixed frame"])
def test_rendition_batch_and_coverage(center, monkeypatch):
    """A batch of three windows under full_circle, two breaking the
    promise: the per-viewpoint uncovered counts (the arcs' starts from
    each window) equal the uploaded table's, and the rasters bitwise."""
    cos_lat = math.cos(math.radians(LAT))
    views = [jparams(150.0, 150.0, 1400.0, zfar=8000.0, cos_lat=cos_lat),
             jparams(150.0, 150.0, 1400.0, zfar=8000.0, cos_lat=cos_lat,
                     az0=math.radians(-30), az1=math.radians(140)),
             jparams(152.7, 147.2, 1300.0, zfar=6000.0, cos_lat=cos_lat,
                     az0=math.radians(100), az1=math.radians(215))]
    pb = stack_params([tp(v) for v in views])
    dem = torch.from_numpy(smooth_dem(300))
    kw = dict(width=256, nsteps=256, cells_per_deg=CPD, sampler="window",
              out_halfwidth=80, lat_hint_deg=LAT, method="contract",
              full_circle=True, out_center_ij=center, with_dropped=True)
    (v0, g0), (v1, g1) = _both(lambda: tops.viewshed_grid(dem, pb, **kw),
                               monkeypatch)
    assert torch.equal(v0, v1) and torch.equal(g0, g1)
    assert int(g1[0]) == 0 and int(g1[1]) > 0 and int(g1[2]) > 0


@pytest.mark.parametrize("scene", ["wall", "flat", "edge"])
def test_rendition_count(scene, monkeypatch):
    """viewshed_count through the kernel route adds each batch into the
    count: equal to the torch route's sum of rasters, with observers on
    and outside the frame's edge in the "edge" scene."""
    dem = (np.zeros((512, 512), np.float32) if scene == "flat"
           else wall_dem(512, 280, 283, 300.0))
    pts = np.array([[246.0, 246.0], [266.0, 266.0], [256.0, 240.0],
                    [250.0, 270.0], [262.0, 254.0]])
    if scene == "edge":
        pts = np.array([[224.0, 256.0], [288.0, 230.5], [200.0, 300.0],
                        [256.0, 224.0], [320.0, 256.0]])
    kw = dict(out_center_ij=(256.0, 256.0), out_halfwidth=32,
              viewer_height_m=2.0, width=256, nsteps=256, cells_per_deg=CPD,
              znear=50.0, zfar=6000.0, batch=2, sampler="window",
              device="cpu")
    c0, c1 = _both(lambda: tops.viewshed_count(dem, pts, **kw), monkeypatch)
    assert torch.equal(c0, c1) and int(c1.max()) > 0


def test_rendition_columns_and_search():
    """The sorted columns and the binary search equal the direct masked
    max bitwise, on distances in any order with ties and NaN, and radii
    that are infinite, NaN or tie a distance."""
    gen = torch.Generator().manual_seed(5)
    b, w, k, m = 2, 7, 33, 50
    d = torch.randint(0, 40, (b, w, k), generator=gen).float() * 25.0
    d[0, 3, 5] = math.nan
    tanel = torch.randn((b, w, k), generator=gen)
    tanel[..., ::5] = tview.NEG
    r = torch.rand((b, w, m), generator=gen) * 1100.0 - 50.0
    r[0, 0, :3] = torch.tensor([math.inf, -math.inf, math.nan])
    r[1, 2, :4] = d[1, 2, :4]
    dsorted, run = vr.columns_plain(tanel, d)
    cell = (torch.arange(b)[:, None, None] * w
            + torch.arange(w)[None, :, None]).expand(b, w, m)
    got = vr._search(dsorted, run, cell, r)
    assert torch.equal(got, tview._tables_direct(tanel, d, (r,))[0])


def test_rendition_triangulated_and_far_columns(monkeypatch):
    """A window centred on due east at an odd width (a column at 90 deg,
    where cos is near 0) and one on due north (sin near 0), triangulated
    and bilinear."""
    cos_lat = math.cos(math.radians(LAT))
    dem = torch.from_numpy(smooth_dem(300, seed=11))
    for az0, az1 in ((80.0, 100.0), (-10.0, 10.0)):
        for surface in ("bilinear", "triangulated"):
            p = tp(jparams(150.5, 150.0, 1400.0, zfar=8000.0, cos_lat=cos_lat,
                           az0=math.radians(az0), az1=math.radians(az1)))
            kw = dict(width=257, nsteps=256, cells_per_deg=CPD,
                      sampler="window", out_halfwidth=60, lat_hint_deg=LAT,
                      method="contract", surface=surface, with_dropped=True)
            (v0, g0), (v1, g1) = _both(
                lambda: tops.viewshed_grid(dem, p, **kw), monkeypatch)
            assert torch.equal(v0, v1) and torch.equal(g0, g1)
            assert v1.any()


def _args(b=2, w=8, k=16, hw=4, n=32):
    f = torch.float32
    return (torch.zeros((n, n), dtype=f), torch.zeros((b, w, k), dtype=f),
            torch.zeros((b, w, k), dtype=f), torch.zeros((b, 11), dtype=f),
            torch.zeros((b, w, 4), dtype=f)), dict(
        hw=hw, cell_n=92.6, center=None, triangulated=False,
        full_circle=True)


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguity", "total",
                                   "device"])
def test_wrapper_checks(fault):
    """The wrapper raises on each wrong argument and never launches on CPU
    tensors (its launch counter stays put)."""
    args, kw = _args()
    args = list(args)
    if fault == "dtype":
        args[1] = args[1].double()
    elif fault == "shape":
        args[4] = args[4][..., :3].contiguous()
    elif fault == "contiguity":
        args[2] = args[2].transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "total":
        kw["total"] = torch.zeros((8, 8), dtype=torch.int64)
    n0 = vr.resample.launches
    match = "unsupported device" if fault == "device" else "must be"
    with pytest.raises(ValueError, match=match):
        vr.resample(*args, **kw)
    assert vr.resample.launches == n0


def _recorded(call):
    from torch.profiler import ProfilerActivity, profile
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        call()
    snap = profiling.snapshot()
    profiling.reset()
    return snap


def test_counter_and_span_under_profiler(monkeypatch):
    """On the kernel route a count records ``hz.kernels.resample`` (span
    and counter, one a batch) inside ``hz.viewshed.resample``, no torch
    sub-spans, no accumulate and no cover upload; nothing without the
    profiler."""
    _kernel_route(monkeypatch)
    pts = np.array([[120.0, 120.0], [130.0, 110.0], [128.0, 136.0]])
    dem = np.zeros((256, 256), np.float32)
    dem[150:152, :] = 300.0
    kw = dict(out_center_ij=(128.0, 128.0), out_halfwidth=16, width=64,
              nsteps=128, cells_per_deg=1200, znear=50.0, zfar=3000.0,
              batch=2, sampler="window", device="cpu")
    profiling.reset()
    tops.viewshed_count(torch.from_numpy(dem), pts, **kw)
    assert profiling.snapshot()["counters"] == {}
    snap = _recorded(lambda: tops.viewshed_count(torch.from_numpy(dem), pts,
                                                 **kw))
    spans = snap["spans"]
    assert snap["counters"]["hz.kernels.resample"] == (2, 2)
    assert snap["counters"]["hz.host_syncs"] == (1, 1)
    assert spans["hz.kernels.resample"][0] == spans[
        "hz.viewshed.resample"][0] == 2
    assert not {"hz.viewshed.frame", "hz.viewshed.tables",
                "hz.viewshed.arc_cover", "hz.ops.accumulate"} & set(spans)


@pytest.mark.parametrize("cell,route,want", [
    ("gis-20km.count256", True, 100.0), ("gis-20km.count256", False, 0.0),
    ("gis-20km.sweep1024", True, None)])
def test_resample_kernel_pct_metric(cell, route, want, monkeypatch):
    """``resample_kernel_pct.batch`` on a tiny traced run: 100 where every
    resample went through the kernel route, 0 on the torch route, None
    where nothing resampled (the sweep); the count stays correct."""
    from portbench import harness
    from portbench.conftest import tiny_files
    from portbench.loader import load_module
    if route:
        _kernel_route(monkeypatch)
    profiling.reset()
    out, _ = harness.run_cell(cell, 2 ** 31 + 11, 0.2, True, device="cpu",
                              files=tiny_files(cell))
    direct = load_module(harness.HERE / "metrics"
                         / "resample_kernel_pct.batch.py").read(None)
    profiling.reset()
    assert out["correct"] and direct == want
    if cell.endswith("count256"):
        assert out["metrics"]["resample_kernel_pct.batch"]["value"] == want


def test_rendition_crossing_sampler(monkeypatch):
    """The grid-crossing march's contract raster of an int16 grid, full
    circle and a partial window: raster and guard bitwise."""
    cos_lat = math.cos(math.radians(LAT))
    dem = torch.from_numpy(np.round(smooth_dem(300)).astype(np.int16))
    for az in ({}, dict(az0=math.radians(-30), az1=math.radians(140))):
        p = tp(jparams(150.25, 150.5, 1400.0, zfar=8000.0, cos_lat=cos_lat,
                       **az))
        kw = dict(width=256, nsteps=128, cells_per_deg=CPD,
                  sampler="crossing", out_halfwidth=60, lat_hint_deg=LAT,
                  method="contract", full_circle=not az, with_dropped=True)
        (v0, g0), (v1, g1) = _both(lambda: tops.viewshed_grid(dem, p, **kw),
                                   monkeypatch)
        assert torch.equal(v0, v1) and torch.equal(g0, g1) and v1.any()
