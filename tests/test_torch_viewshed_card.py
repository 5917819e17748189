"""The viewshed resampler's CUDA kernels on the card, bitwise against
``resample_plain`` (the kernels' function in plain PyTorch, on the same
card tensors) and ``plain=True`` (the direct masked max,
``_tables_direct``): counts, rasters and guards. Skips without a card.
The module imports no JAX, so it runs on a machine with a card and
without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_viewshed_card.py
"""

import math

import numpy as np
import pytest
import torch

from horizonator_tpu_torch import ops as tops
from horizonator_tpu_torch.kernels import viewshed_resample as vr
from horizonator_tpu_torch.ops import viewshed as tview
from horizonator_tpu_torch.render import make_params

pytestmark = pytest.mark.card
CPD, LAT = 1200, 34.3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


def relief(n: int, seed: int = 7) -> np.ndarray:
    """Smooth hills with noise (tests/test_torch_viewshed.py's terrain)."""
    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32), indexing="ij")
    z = (600 + 500 * np.sin(ii / 223) * np.cos(jj / 181)
         + 200 * np.sin(ii / 37 + 1.3) * np.cos(jj / 53)
         + 3.0 * rng.standard_normal((n, n), dtype=np.float32))
    return np.maximum(z, 0).astype(np.float32)


def _routes(call, monkeypatch):
    """call() through the kernels, through ``resample_plain`` in their
    place and under plain=True, and the kernels' launches."""
    n0 = vr.resample.launches
    kernel = call(plain=False)
    launches = vr.resample.launches - n0

    def plain_version(*args, **kw):
        return vr.resample_plain(*args, **kw)
    plain_version.launches = 0
    monkeypatch.setattr(tview, "resample", plain_version)
    plain_route = call(plain=False)
    monkeypatch.undo()
    return kernel, plain_route, call(plain=True), launches


def _equal(a, b):
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def test_count_config10(card, monkeypatch):
    """viewshed_count at suite config 10's shape: 256 observers in [420,
    780] of a 1201^2 grid, the 800^2 frame at (600, 600), W 720, batches
    of 64: one kernel launch a batch, counts equal on all three routes."""
    dem = torch.from_numpy(relief(1201)).to(card)
    pts = np.random.default_rng(5).uniform(420.0, 780.0, (256, 2))
    kw = dict(out_center_ij=(600.0, 600.0), out_halfwidth=400, width=720,
              cells_per_deg=CPD, znear=50.0, zfar=20000.0, lat_deg=LAT,
              batch=64, viewer_height_m=1.75, device=card)
    k, t, p, launches = _routes(
        lambda plain: tops.viewshed_count(dem, pts, plain=plain, **kw),
        monkeypatch)
    assert launches == 4
    assert torch.equal(k, t) and torch.equal(k, p)
    assert 0 < int(k.max()) <= 256


@pytest.mark.parametrize("scene", ["flat", "edge"])
def test_count_flat_and_edge(scene, card, monkeypatch):
    """A flat DEM, and observers on the frame's edge and outside it, in
    batches of 2 with a short last batch."""
    n = 512
    dem = (np.zeros((n, n), np.float32) if scene == "flat"
           else relief(n, seed=3))
    pts = np.array([[224.0, 256.0], [288.0, 230.5], [200.0, 300.0],
                    [256.0, 224.0], [320.0, 256.0]])
    kw = dict(out_center_ij=(256.0, 256.0), out_halfwidth=32, width=256,
              nsteps=256, cells_per_deg=CPD, znear=50.0, zfar=6000.0,
              batch=2, device=card)
    k, t, p, launches = _routes(
        lambda plain: tops.viewshed_count(dem, pts, plain=plain, **kw),
        monkeypatch)
    assert launches == 3
    assert torch.equal(k, t) and torch.equal(k, p) and int(k.max()) > 0


GRIDS = [("full circle", (-180.0, 180.0), None, True, "bilinear", 720),
         ("partial window", (-30.0, 140.0), None, False, "bilinear", 720),
         ("partial window under full_circle", (-30.0, 140.0), None, True,
          "bilinear", 720),
         ("fixed frame full circle", (-180.0, 180.0), (560.0, 640.0), True,
          "bilinear", 720),
         ("triangulated", (-180.0, 180.0), None, True, "triangulated", 720),
         ("due east, odd width", (80.0, 100.0), None, False, "bilinear", 257),
         ("due north, odd width", (-10.0, 10.0), None, False, "triangulated",
          257)]


@pytest.mark.parametrize("name,window,center,full_circle,surface,width",
                         GRIDS, ids=[g[0] for g in GRIDS])
def test_grid(name, window, center, full_circle, surface, width, card,
              monkeypatch):
    """viewshed_grid with_dropped (raster and guard) over a batch of three
    viewpoints, one of them in the frame's corner: equal on all three
    routes; a broken full-circle promise counts uncovered cells."""
    dem = torch.from_numpy(relief(1201)).to(card)
    p = make_params(device=card, viewer_cell_i=[600.25, 611.0, 580.5],
                    viewer_cell_j=[600.5, 590.0, 645.0],
                    viewer_z=[1600.0, 1500.0, 1700.0],
                    cos_viewer_lat=math.cos(math.radians(LAT)),
                    az_rad0=math.radians(window[0]),
                    az_rad1=math.radians(window[1]), znear=50.0,
                    zfar=20000.0, znear_color=50.0, zfar_color=20000.0)
    kw = dict(width=width, nsteps=384, cells_per_deg=CPD, sampler="window",
              out_halfwidth=300, lat_hint_deg=LAT, with_dropped=True,
              method="contract", surface=surface, full_circle=full_circle,
              out_center_ij=center)
    k, t, pl, launches = _routes(
        lambda plain: tops.viewshed_grid(dem, p, plain=plain, **kw),
        monkeypatch)
    assert launches == 1
    assert _equal(k, t) and _equal(k, pl)
    vis, guard = k
    assert vis.shape == (3, 600, 600) and vis.any() and not vis.all()
    broken = full_circle and window[1] - window[0] < 360.0
    assert bool((guard > 0).all()) == broken


@pytest.mark.parametrize("n,nsteps", [(1201, 1216), (16448, 16448)],
                         ids=["shared memory", "device memory"])
def test_long_columns(n, nsteps, card, monkeypatch):
    """Columns past the warp sort's 1024 samples: K 1220 sorts in a block's
    shared memory, K 16452 in the outputs themselves; rasters and guards
    equal on all three routes."""
    ax = torch.arange(n, dtype=torch.float32, device=card)
    dem = (400.0 + 300.0 * torch.sin(ax / 97.0)[:, None]
           * torch.cos(ax / 61.0)[None, :]).contiguous()
    p = make_params(device=card, viewer_cell_i=[n / 2 + 0.25, n / 2 - 7.5],
                    viewer_cell_j=[n / 2 + 0.5, n / 2 + 3.0],
                    viewer_z=[900.0, 1000.0],
                    cos_viewer_lat=math.cos(math.radians(LAT)),
                    az_rad0=-math.pi, az_rad1=math.pi, znear=50.0,
                    zfar=20000.0, znear_color=50.0, zfar_color=20000.0)
    kw = dict(width=64, nsteps=nsteps, cells_per_deg=CPD, sampler="window",
              out_halfwidth=40, lat_hint_deg=LAT, with_dropped=True,
              method="contract", full_circle=True)
    k, t, pl, launches = _routes(
        lambda plain: tops.viewshed_grid(dem, p, plain=plain, **kw),
        monkeypatch)
    assert launches == 1
    assert _equal(k, t) and _equal(k, pl) and k[0].any()


def test_grid_crossing_sampler(card, monkeypatch):
    """The grid-crossing march's contract raster (an int16 grid) through
    the kernels: equal on all three routes."""
    dem = torch.from_numpy(np.round(relief(601)).astype(np.int16)).to(card)
    p = make_params(device=card, viewer_cell_i=[300.25, 280.0],
                    viewer_cell_j=[300.5, 320.0], viewer_z=[1500.0, 1400.0],
                    cos_viewer_lat=math.cos(math.radians(LAT)),
                    az_rad0=-math.pi, az_rad1=math.pi, znear=50.0,
                    zfar=12000.0, znear_color=50.0, zfar_color=12000.0)
    kw = dict(width=360, nsteps=192, cells_per_deg=CPD, sampler="crossing",
              out_halfwidth=150, lat_hint_deg=LAT, with_dropped=True,
              method="contract", full_circle=True)
    k, t, pl, launches = _routes(
        lambda plain: tops.viewshed_grid(dem, p, plain=plain, **kw),
        monkeypatch)
    assert launches == 1
    assert _equal(k, t) and _equal(k, pl) and k[0].any()
