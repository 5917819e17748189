"""The near band's wrapper and the march wrappers' ``out=`` on the CPU:
``kernels/near_band.near_band`` takes CPU tensors to ``near_band_plain``
(no launch, no ``hz.kernels.near_band`` count) and writes into a view of
a wider field where given; its argument checks raise on every device;
the march entries write their samples into lanes of a field at its row
stride. The kernels themselves are held to these plain versions on the
card by tests/test_torch_near_band_card.py."""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from horizonator_tpu_torch import profiling
from horizonator_tpu_torch.kernels import near_band as nb
from horizonator_tpu_torch.kernels import window_march as wm
from horizonator_tpu_torch.render import make_params
from horizonator_tpu_torch.render.crossing import crossing_geometry
from horizonator_tpu_torch.render.window import (march_from_geometry,
                                                 near_patch_size)

CPD, LAT = 1200, 34.3


def relief(n, nj=None, seed=7):
    rng = np.random.default_rng(seed)
    z = 600 + 40 * rng.standard_normal((nj or n, n)).cumsum(0) / 10
    return torch.from_numpy(np.maximum(z, 0).astype(np.float32))


def view(vi, vj, vz=900.0, znear=100.0):
    return make_params(
        device="cpu", viewer_cell_i=vi, viewer_cell_j=vj, viewer_z=vz,
        cos_viewer_lat=math.cos(math.radians(LAT)), az_rad0=-math.pi,
        az_rad1=math.pi, znear=znear, zfar=9000.0, znear_color=znear,
        zfar_color=9000.0)


def _case(batch=False):
    dem = relief(160)
    p = view([80.2, 40.5], [79.6, 120.25]) if batch else view(80.2, 79.6)
    return dem, p, crossing_geometry(p, width=64, cells_per_deg=CPD)


KW = dict(n_near=4, patch_n=16)


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("patch_n", [16, None])
def test_cpu_routes_to_plain(batch, patch_n):
    """Equal outputs to near_band_plain, the samples on request, no
    launch and no counter."""
    dem, p, geo = _case(batch)
    kw = dict(KW, patch_n=patch_n)
    launches = nb.near_band.launches
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = nb.near_band(dem, p, geo, want_samples=True, **kw)
    assert "hz.kernels.near_band" not in profiling.snapshot()["counters"]
    profiling.reset()
    assert nb.near_band.launches == launches
    ref = nb.near_band_plain(dem, p, geo, **kw)
    for a, b in zip(got[:3], ref[:3]):
        assert torch.equal(a, b)
    for a, b in zip(got.samples, ref[3]):
        assert torch.equal(a, b)
    assert nb.near_band(dem, p, geo, **kw).samples is None
    lead = (2,) if batch else ()
    assert got.tanel.shape == lead + (64, 4)
    assert got.dropped.shape == lead and got.dropped.dtype == torch.int32


def test_plain_out_is_a_field_view():
    """``out``: lanes [0, n_near) of a wider field, the rest untouched."""
    dem, p, geo = _case(batch=True)
    field = torch.full((2, 64, 4 + 9), 7.0)
    got = nb.near_band(dem, p, geo, out=field[..., :4], **KW)
    assert got.tanel.data_ptr() == field.data_ptr()
    assert torch.equal(field[..., :4], nb.near_band_plain(dem, p, geo,
                                                          **KW)[0])
    assert bool((field[..., 4:] == 7.0).all())


def _bad_geo(geo):
    return geo._replace(e=geo.e[:-1])


@pytest.mark.parametrize("what, change", [
    ("dem dtype", lambda a: dict(a, dem=a["dem"].double())),
    ("dem dims", lambda a: dict(a, dem=a["dem"][None, None])),
    ("grid batch", lambda a: dict(a, dem=a["dem"].expand(3, -1, -1)
                                  .contiguous())),
    ("columns", lambda a: dict(a, geo=_bad_geo(a["geo"]))),
    ("n_near", lambda a: dict(a, n_near=0)),
    ("patch_n", lambda a: dict(a, patch_n=400)),
    ("j_offset", lambda a: dict(a, j_offset=-1)),
    ("out shape", lambda a: dict(a, out=torch.empty(64, 5))),
    ("out dtype", lambda a: dict(a, out=torch.empty(64, 4,
                                                    dtype=torch.float64))),
    ("out lanes", lambda a: dict(a, out=torch.empty(4, 64).t())),
])
def test_checks_raise(what, change):
    dem, p, geo = _case()
    args = change(dict(dem=dem, p=p, geo=geo, **KW))
    with pytest.raises(ValueError, match="near_band"):
        nb.near_band(**args)


def test_checks_raise_on_the_plain_route_too():
    dem, p, geo = _case()
    with pytest.raises(ValueError, match="out must be"):
        nb.near_band(dem, p, geo, out=torch.empty(64, 3), plain=True, **KW)


def test_march_out_views():
    """The four march entries write their (W, k) samples (and colors)
    into lanes [4, 4 + k) of a field, equal to their own outputs."""
    dem = relief(96)
    p = view(48.3, 47.7)
    geo = crossing_geometry(p, width=40, cells_per_deg=CPD)
    pcol = torch.stack([geo.a, geo.t, geo.e, geo.scale,
                        geo.axis0.float(), geo.sign.float(),
                        geo.j_dom.float(), torch.zeros_like(geo.a)], -1)
    fscal = torch.stack([p.viewer_z, p.znear, p.zfar, p.curv])
    colors = torch.arange(192 * 192, dtype=torch.int32).view(192, 192)
    k = 70
    band = dict(j_offset=0, j_hi=95.0)
    for fn, args in ((wm.march, ()), (wm.march_band, (0, 95.0))):
        field = torch.full((40, 4 + k), 5.0)
        got = fn(dem, pcol, fscal, k, *args, out=field[:, 4:])
        assert got.data_ptr() == field[:, 4:].data_ptr()
        assert torch.equal(field[:, 4:], wm.march_plain(dem, pcol, fscal,
                                                        k, **band))
        assert bool((field[:, :4] == 5.0).all())
    for fn, args in ((wm.march_textured, ()),
                     (wm.march_band_textured, (0, 95.0))):
        field = torch.zeros(40, 4 + k)
        tex = torch.zeros(40, 4 + k, dtype=torch.int32)
        fn(dem, pcol, fscal, k, colors, 2, *args, out=field[:, 4:],
           tex_out=tex[:, 4:])
        ref = wm.march_plain(dem, pcol, fscal, k, colors, 2, **band)
        assert torch.equal(field[:, 4:], ref[0])
        assert torch.equal(tex[:, 4:], ref[1])
    with pytest.raises(ValueError, match="out must be"):
        wm.march(dem, pcol, fscal, k, out=torch.empty(40, k + 1))
    with pytest.raises(ValueError, match="out without tex_out"):
        wm.march_textured(dem, pcol, fscal, k, colors, 2,
                          out=torch.empty(40, k))


def test_march_from_geometry_cpu_field():
    """On the CPU the field holds the plain near band's lanes before the
    plain march's, as under plain=True, and nothing launches."""
    dem = relief(200, 150)
    p = view([100.0, 20.5], [70.0, 140.0])
    geo = crossing_geometry(p, width=96, cells_per_deg=CPD)
    launches = nb.near_band.launches
    tanel, dists = march_from_geometry(dem, p, geo, k_cross=128,
                                       cells_per_deg=CPD, lat_hint_deg=LAT)
    assert nb.near_band.launches == launches
    near = nb.near_band_plain(dem, p, geo, n_near=4,
                              patch_n=near_patch_size(100.0, CPD, LAT))
    assert torch.equal(tanel[..., :4], near[0])
    assert torch.equal(dists.near_hi, near[1])
    assert torch.equal(dists.dropped, near[2])
    ref, ref_dists = march_from_geometry(dem, p, geo, k_cross=128,
                                         cells_per_deg=CPD, lat_hint_deg=LAT,
                                         plain=True)
    assert torch.equal(tanel, ref)
    assert torch.equal(dists.truncated, ref_dists.truncated)
