"""The near band's CUDA kernel on the card, bitwise against
``near_band_plain`` (the torch near band, on the same card tensors): the
tangents, ``near_hi``, ``dropped`` and the textured marches' (dq, iq,
jq), single and batched, on a shared grid and on one grid per viewpoint,
square and banded, in the patch and the gather form, below the padding
edge, with samples dropped off the patch, at n_near 4 and 3; then the
whole field of ``march_from_geometry`` (untextured, textured with the
hybrid near field, banded) against its ``plain=True`` field, and the
kernels a render launches inside ``hz.render.near_band``. Skips without
a card. The module imports no JAX, so it runs on a machine with a card
and without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_near_band_card.py
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from horizonator_tpu_torch import profiling
from horizonator_tpu_torch.kernels import near_band as nb
from horizonator_tpu_torch.render import make_params
from horizonator_tpu_torch.render.crossing import (crossing_geometry,
                                                   k_cross_for)
from horizonator_tpu_torch.render.texture import (AtlasParams,
                                                  ColorPlanes2x,
                                                  tile_xy_from_latlon)
from horizonator_tpu_torch.render.window import (march_from_geometry,
                                                 near_patch_size)

pytestmark = pytest.mark.card
CPD, LAT = 1200, 34.3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


def relief(n: int, nj: int | None = None, seed: int = 7) -> np.ndarray:
    """Smooth hills with metre noise, some of it at fractional metres (so
    the 0.5 m rounding matters), over (nj, n)."""
    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.arange(nj or n, dtype=np.float32),
                         np.arange(n, dtype=np.float32), indexing="ij")
    z = (600 + 500 * np.sin(ii / 223) * np.cos(jj / 181)
         + 200 * np.sin(ii / 37 + 1.3) * np.cos(jj / 53)
         + 3.3 * rng.standard_normal(ii.shape, dtype=np.float32))
    return np.maximum(z, 0).astype(np.float32)


def view(dev, vi, vj, vz=900.0, znear=100.0, zfar=40000.0, az=(-180, 180),
         curv=0.0):
    """RenderParams of one viewpoint, or of a batch where vi is a list."""
    return make_params(
        device=dev, viewer_cell_i=vi, viewer_cell_j=vj, viewer_z=vz,
        cos_viewer_lat=math.cos(math.radians(LAT)),
        az_rad0=np.radians(az[0]), az_rad1=np.radians(az[1]), znear=znear,
        zfar=zfar, znear_color=znear, zfar_color=zfar, curv=curv)


def both(dem, p, width, **kw):
    """(kernel, plain) NearBands of one geometry, with samples."""
    geo = crossing_geometry(p, width=width, cells_per_deg=CPD)
    n0 = nb.near_band.launches
    k = nb.near_band(dem, p, geo, want_samples=True, **kw)
    assert nb.near_band.launches == n0 + 1
    t, hi, dr, smp = nb.near_band_plain(dem, p, geo, **kw)
    return k, nb.NearBand(t, hi, dr, smp)


def assert_same(k, r):
    assert k.tanel.shape == r.tanel.shape
    assert torch.equal(k.tanel, r.tanel), int((k.tanel != r.tanel).sum())
    assert torch.equal(k.near_hi, r.near_hi)
    assert torch.equal(k.dropped, r.dropped)
    assert k.dropped.dtype == torch.int32
    for a, b in zip(k.samples, r.samples):
        assert torch.equal(a, b)


PANO = dict(n_near=4)


def test_single_pano_shape(card):
    """pano-single's shape: one viewpoint, 4096 columns, the full circle,
    the 16-cell patch of znear 100 m at SRTM3."""
    dem = torch.from_numpy(relief(2001)).to(card)
    patch_n = near_patch_size(100.0, CPD, LAT)
    k, r = both(dem, view(card, 1000.3, 999.6), 4096, patch_n=patch_n,
                **PANO)
    assert_same(k, r)
    assert int(k.dropped) == 0
    assert (k.tanel > -1e30).float().mean() > 0.5


def test_count256_batch(card):
    """A count256 batch: 64 observers at 1.75 m over a shared 1201^2 grid,
    720 columns, znear 50 m."""
    dem = torch.from_numpy(relief(1201)).to(card)
    pts = np.random.default_rng(5).uniform(420.0, 780.0, (64, 2))
    z = dem[pts[:, 1].astype(int), pts[:, 0].astype(int)].cpu().numpy()
    p = view(card, list(pts[:, 0]), list(pts[:, 1]), list(z + 1.75),
             znear=50.0, zfar=20000.0)
    k, r = both(dem, p, 720, patch_n=near_patch_size(50.0, CPD, LAT),
                **PANO)
    assert k.tanel.shape == (64, 720, 4)
    assert_same(k, r)


def test_batch_per_view_grids_and_windows(card):
    """One grid per viewpoint (the LOD crops), viewpoints differing in
    position, height, window, znear, zfar and curvature."""
    dem = torch.from_numpy(np.stack([relief(300, seed=s)
                                     for s in range(5)])).to(card)
    p = view(card, [150.2, 10.5, 290.0, 151.0, 149.99],
             [150.7, 20.25, 5.5, 150.0, 200.0],
             [800.0, 700.0, 1200.0, 650.0, 900.0],
             znear=[100.0, 30.0, 250.0, 100.0, 0.0],
             zfar=[9000.0, 5000.0, 20000.0, 300.0, 12000.0],
             az=([-180, -30, 10, 170, -90], [180, 60, 90, 200, 45]),
             curv=[0.0, 1e-7, 0.0, 7.8e-8, 0.0])
    for patch_n in (near_patch_size(250.0, CPD, LAT), None):
        k, r = both(dem, p, 333, patch_n=patch_n, **PANO)
        assert_same(k, r)


def test_band_fractional_j_hi(card):
    """A row band (region sharding): rows 400.. of the global grid, valid
    up to a fractional j_hi, viewers in, beside and far from the band, in
    the patch and the gather form."""
    full = relief(1200)
    band = torch.from_numpy(full[400:700].copy()).to(card)
    p = view(card, [600.0, 600.5, 10.0], [410.3, 380.0, 699.2],
             znear=[100.0, 120.0, 80.0])
    for patch_n in (near_patch_size(120.0, CPD, LAT), None):
        k, r = both(band, p, 1024, patch_n=patch_n, j_offset=400,
                    j_hi=298.75, **PANO)
        assert_same(k, r)
        assert (k.tanel > -1e30).any()


def test_small_grid_and_gather(card):
    """A grid below ALIGN_MIN_N, read as zero-padded, with the viewer by
    its far edge so the patch covers the padding; and the gather form."""
    dem = torch.from_numpy(relief(100, 90)).to(card)
    p = view(card, [97.5, 50.0], [88.2, 45.0], [700.0, 650.0], zfar=9000.0)
    for patch_n in (16, None):
        k, r = both(dem, p, 512, patch_n=patch_n, **PANO)
        assert_same(k, r)


def test_drops_off_the_patch(card):
    """znear far past what the patch covers: valid samples off the patch
    are counted, per viewpoint, and made invalid."""
    dem = torch.from_numpy(relief(600)).to(card)
    p = view(card, [300.0, 310.5], [300.0, 290.25], znear=[900.0, 20.0])
    k, r = both(dem, p, 1000, patch_n=8, **PANO)
    assert_same(k, r)
    assert int(k.dropped[0]) > 0


@pytest.mark.parametrize("n_near", [3, 5])
def test_other_n_near(card, n_near):
    dem = torch.from_numpy(relief(800)).to(card)
    p = view(card, [400.0, 120.0], [400.0, 650.0])
    k, r = both(dem, p, 700, n_near=n_near,
                patch_n=near_patch_size(100.0, CPD, LAT))
    assert_same(k, r)


def test_out_view_of_a_field(card):
    """``out``: lanes [0, n_near) of a wider field, the other lanes left
    as they were."""
    dem = torch.from_numpy(relief(800)).to(card)
    p = view(card, [400.0, 401.5], [400.0, 402.0])
    geo = crossing_geometry(p, width=640, cells_per_deg=CPD)
    field = torch.full((2, 640, 4 + 64), 7.0, device=card)
    got = nb.near_band(dem, p, geo, n_near=4, patch_n=16,
                       out=field[..., :4])
    ref = nb.near_band_plain(dem, p, geo, n_near=4, patch_n=16)[0]
    assert got.tanel.data_ptr() == field.data_ptr()
    assert torch.equal(field[..., :4], ref)
    assert bool((field[..., 4:] == 7.0).all())


def planes(dev, n, seed=3):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randint(0, 1 << 24, (2 * n, 2 * n), generator=g,
                         device=dev, dtype=torch.int32)


def fields(dem, p, width, **kw):
    geo = crossing_geometry(p, width=width, cells_per_deg=CPD)
    mkw = dict(k_cross=k_cross_for(40000.0, CPD, LAT, n=dem.shape[-1]),
               cells_per_deg=CPD, lat_hint_deg=LAT, **kw)
    return (march_from_geometry(dem, p, geo, **mkw),
            march_from_geometry(dem, p, geo, plain=True, **mkw))


def assert_fields(got, ref):
    for a, b in zip(got, ref):
        if isinstance(a, torch.Tensor):
            assert a.shape == b.shape and torch.equal(a, b)
        else:       # the dists
            for x, y in zip(a, b):
                if isinstance(x, torch.Tensor):
                    assert torch.equal(x, y)


def test_field_single_and_batch(card):
    """march_from_geometry's whole field, one render and a batch,
    against plain=True."""
    dem = torch.from_numpy(relief(1601)).to(card)
    assert_fields(*fields(dem, view(card, 800.4, 799.5), 4096))
    p = view(card, [700.0 + 3 * i for i in range(6)],
             [700.0 + 2 * i for i in range(6)],
             az=([-60 + 0.5 * i for i in range(6)],
                 [60 + 0.5 * i for i in range(6)]))
    assert_fields(*fields(dem, p, 1920))


def test_field_textured_hybrid(card):
    """The textured field with half-cell planes and the hybrid near field
    from a seeded z12 atlas around the viewer (pano-single-tex's path),
    against plain=True."""
    n, lat0, lon0 = 1601, 34.3, -117.7
    dem = torch.from_numpy(relief(n)).to(card)
    p = view(card, 800.4, 799.5)
    tx0, ty0 = tile_xy_from_latlon(lat0, lon0, 12)
    ap = AtlasParams(lon0 - 800.4 / CPD, lat0 - 799.5 / CPD, tx0 - 4,
                     ty0 - 4, 8, 8)
    atlas = torch.from_numpy(np.random.default_rng(4).integers(
        0, 1 << 24, (2048, 2048), dtype=np.int32)).to(card)
    kw = dict(color_planes=ColorPlanes2x(planes(card, n)))
    assert_fields(*fields(dem, p, 4096, **kw))
    assert_fields(*fields(dem, p, 4096, atlas=atlas, atlas_params=ap,
                          exact_near_m=1200.0, **kw))


def test_field_banded_textured(card):
    """A band's field, untextured and textured (the region path)."""
    band = torch.from_numpy(relief(1200)[300:900].copy()).to(card)
    p = view(card, 600.0, 610.5)
    bkw = dict(j_offset=300, j_hi=598.5)
    assert_fields(*fields(band, p, 2048, **bkw))
    g = torch.Generator(device=card)
    g.manual_seed(2)
    plane = torch.randint(0, 1 << 24, (1200, 2400), generator=g,
                          device=card, dtype=torch.int32)
    assert_fields(*fields(band, p, 2048, color_planes=ColorPlanes2x(plane),
                          **bkw))


def test_near_band_span_launches(card):
    """A render's kernels inside ``hz.render.near_band``: at most 2 (the
    near band's one), and the counter ``hz.kernels.near_band`` counts it."""
    from horizonator_tpu_torch.render import render_panorama
    dem = torch.from_numpy(relief(1601)).to(card)
    p = view(card, 800.4, 799.5)
    kw = dict(width=4096, height=1024, nsteps=k_cross_for(
        40000.0, CPD, LAT, n=1601), cells_per_deg=CPD, lat_hint_deg=LAT)
    render_panorama(dem, p, **kw)
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render_panorama(dem, p, **kw)
        torch.cuda.synchronize()
    snap = profiling.snapshot()
    assert snap["counters"]["hz.kernels.near_band"][0] == 1
    events = prof.events()
    span = [e for e in events if e.name == "hz.render.near_band"
            and e.device_type == torch.autograd.DeviceType.CPU]
    assert len(span) == 1
    lo, hi = span[0].time_range.start, span[0].time_range.end
    launches = [e for e in events
                if e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC")
                and lo <= e.time_range.start <= hi]
    assert 1 <= len(launches) <= 2, [e.name for e in launches]
