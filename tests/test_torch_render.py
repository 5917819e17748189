"""Port parity for the slice as a whole: .hgt tiles -> mosaic -> panorama.

The same synthetic SRTM3 tiles (conftest.make_synthetic_dem_dir) load
through both packages' mosaic loaders, and the same viewpoint renders
through horizonator_tpu (JAX on the CPU, Pallas kernels in interpret mode)
and horizonator_tpu_torch (CPU: the kernels' plain versions).

Tolerances, and why: the far-field march is bitwise equal given equal
geometry, and the resolve is bitwise equal given equal rows, but
torch.sin/cos/atan differ from XLA's by an ulp and XLA fuses some
multiply-adds of the geometry and the row map. Those ulps move a horizon
row's 1/256-px key across a rounding edge now and then, which moves a
pixel between two neighbouring samples. So:
- the mosaic grid is bitwise equal;
- the sky masks agree at >= 99.9% of pixels;
- the images differ at <= 0.1% of pixels, by <= 1 in the red channel
  wherever both pixels are terrain (a sky flip is counted by the masks);
- ranges agree to <= 1e-4 relative where both pixels are terrain, at all
  but 0.1% of pixels (the flips above);
- with znear = 0 (the near band's first sample floored at 1 mm) the same
  tolerances hold, and every tangent and resolve key of the port is finite.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizonator_tpu import horizonator as JHorizonator
from horizonator_tpu.dem import load_mosaic as j_load_mosaic
from horizonator_tpu.render import render_panorama as j_render
from horizonator_tpu_torch import horizonator as THorizonator
from horizonator_tpu_torch.dem import load_mosaic as t_load_mosaic
from horizonator_tpu_torch.render import params_from_jax, render_panorama
from horizonator_tpu_torch.render.crossing import k_cross_for
from horizonator_tpu_torch.render.raymarch import horizon_rows
from horizonator_tpu_torch.render.window import march_window
from tests.conftest import make_synthetic_dem_dir
from tests.test_torch_geometry import CPD, jax_params

REPO = Path(__file__).resolve().parent.parent
VIEW = dict(lat=34.97, lon=-117.03)     # near the corner of four tiles


def _terrain(lat, lon):
    z = (300.0 + 900.0 * np.exp(-((lat - 35.02) ** 2 + (lon + 116.99) ** 2)
                                / (2 * 0.02 ** 2))
         + 1400.0 * np.exp(-((lat - 34.91) ** 2 + (lon + 117.08) ** 2)
                           / (2 * 0.012 ** 2))
         + 60.0 * np.sin(lat * 157.0) * np.cos(lon * 131.0))
    return np.round(z).astype(np.int16)


@pytest.fixture(scope="module")
def dem_dir(tmp_path_factory):
    tiles = {(la, lo): _terrain for la in (34, 35) for lo in (-118, -117)}
    return make_synthetic_dem_dir(tmp_path_factory.mktemp("torch_dems"),
                                  tiles)


def _compare(img_j, rng_j, img_t, rng_t):
    assert img_t.shape == img_j.shape and img_t.dtype == np.uint8
    assert rng_t.shape == rng_j.shape and rng_t.dtype == np.float32
    sky_j, sky_t = rng_j < 0, rng_t < 0
    assert (sky_j == sky_t).mean() >= 0.999
    terr = ~sky_j & ~sky_t
    assert sky_j.mean() < 0.95 and terr.mean() > 0.05   # a real scene
    diff = np.abs(img_j.astype(int) - img_t.astype(int))
    assert (diff.max(axis=-1) > 0).mean() <= 0.001
    assert diff[terr].max(initial=0) <= 1
    rel = np.abs(rng_t[terr] - rng_j[terr]) / rng_j[terr]
    assert (rel > 1e-4).mean() <= 0.001


def test_mosaic_grid_bitwise(dem_dir, tmp_path):
    kw = dict(render_radius_cells=128, datadir=dem_dir)
    mj = j_load_mosaic(VIEW["lat"], VIEW["lon"], **kw)
    mt = t_load_mosaic(VIEW["lat"], VIEW["lon"], **kw)
    np.testing.assert_array_equal(mt.grid, mj.grid)
    assert mt.origin_dem_lon_lat == mj.origin_dem_lon_lat
    assert mt.origin_dem_cellij == mj.origin_dem_cellij
    at = (VIEW["lat"], VIEW["lon"])
    assert mt.auto_viewer_z(*at) == mj.auto_viewer_z(*at)
    assert mt.viewer_cell(*at) == mj.viewer_cell(*at)
    # the same window with its tiles fetched from a loopback server into an
    # empty directory: the same grid through both loaders
    from tests.test_torch_dem_fetch import Served
    tiles = {f"/{p.name}": p.read_bytes() for p in Path(dem_dir).iterdir()}
    with Served(tiles) as s:
        for side, load in (("jax", j_load_mosaic), ("torch", t_load_mosaic)):
            m = load(VIEW["lat"], VIEW["lon"], render_radius_cells=128,
                     datadir=str(tmp_path / side), dem_url_fmt=s.url + "/%s")
            np.testing.assert_array_equal(m.grid, mj.grid)
            assert m.missing_tiles == []
    assert sorted(s.hits) == sorted(list(tiles) * 2)     # one fetch a tile


@pytest.mark.parametrize("width,height,az0,az1,zfar", [
    (512, 128, -180.0, 180.0, 15000.0),
    (300, 96, 200.0, 290.0, 20000.0)])
def test_render_panorama_matches_jax(dem_dir, width, height, az0, az1, zfar):
    m = j_load_mosaic(VIEW["lat"], VIEW["lon"], render_radius_cells=128,
                      datadir=dem_dir)
    dem = m.grid.astype(np.float32)
    at = (VIEW["lat"], VIEW["lon"])
    ci, cj = m.viewer_cell(*at)
    jp = jax_params(ci, cj, m.auto_viewer_z(*at), az0=az0, az1=az1,
                    zfar=zfar, lat=VIEW["lat"])
    k = k_cross_for(zfar, CPD, VIEW["lat"], n=dem.shape[0])
    kw = dict(width=width, height=height, nsteps=k, cells_per_deg=CPD,
              lat_hint_deg=30.0)
    img_j, rng_j = j_render(jnp.asarray(dem), jp, sampler="window", **kw)
    img_t, rng_t, guard = render_panorama(
        torch.from_numpy(dem), params_from_jax(jp, "cpu"), with_dropped=True,
        **kw)
    assert guard.tolist() == [0, 0]
    _compare(np.asarray(img_j), np.asarray(rng_j), img_t.numpy(),
             rng_t.numpy())


def test_render_znear_zero_matches_jax(dem_dir):
    """znear = 0: the near band starts at the viewer, its first sample's
    distance floored at 1 mm, so no tangent divides by zero."""
    m = j_load_mosaic(VIEW["lat"], VIEW["lon"], render_radius_cells=128,
                      datadir=dem_dir)
    dem = m.grid.astype(np.float32)
    at = (VIEW["lat"], VIEW["lon"])
    ci, cj = m.viewer_cell(*at)
    jp = jax_params(ci, cj, m.auto_viewer_z(*at), znear=0.0, zfar=15000.0,
                    lat=VIEW["lat"])
    k = k_cross_for(15000.0, CPD, VIEW["lat"], n=dem.shape[0])
    tp, td = params_from_jax(jp, "cpu"), torch.from_numpy(dem)
    tanel, _, dists, _ = march_window(td, tp, width=256, k_cross=k,
                                      cells_per_deg=CPD, lat_hint_deg=30.0)
    assert int(dists.dropped) == 0 and int(dists.truncated) == 0
    assert torch.isfinite(tanel).all() and (tanel[:, 0] > -1e30).all()
    assert float(dists.d_of(torch.zeros(256, 1, dtype=torch.int64)).min()) \
        == 0.0                   # the band really starts at the viewer
    assert torch.isfinite(horizon_rows(tanel, tp, width=256,
                                       height=96)).all()
    kw = dict(width=256, height=96, nsteps=k, cells_per_deg=CPD,
              lat_hint_deg=30.0)
    img_j, rng_j = j_render(jnp.asarray(dem), jp, sampler="window", **kw)
    img_t, rng_t, guard = render_panorama(td, tp, with_dropped=True, **kw)
    assert guard.tolist() == [0, 0]
    assert np.isfinite(rng_t.numpy()).all()
    _compare(np.asarray(img_j), np.asarray(rng_j), img_t.numpy(),
             rng_t.numpy())


@pytest.mark.parametrize("oversample", [None, 2.5])
def test_api_oversample_and_cell_m_north(dem_dir, oversample):
    """oversample= is accepted and stored as the JAX package stores it
    (the window sampler does not read it); cell_m_north is the same
    property."""
    kw = dict(dir_dems=dem_dir, render_radius_cells=64)
    if oversample is not None:
        kw["oversample"] = oversample
    hj = JHorizonator(VIEW["lat"], VIEW["lon"], 64, 32, **kw)
    ht = THorizonator(VIEW["lat"], VIEW["lon"], 64, 32, device="cpu", **kw)
    assert ht.oversample == hj.oversample == (oversample or 1.5)
    assert isinstance(ht.oversample, float)
    assert ht.cell_m_north == hj.cell_m_north
    assert abs(ht.cell_m_north - 92.66) < 0.01      # SRTM3: 3 arc seconds


def test_api_render_matches_jax(dem_dir):
    kw = dict(dir_dems=dem_dir, render_radius_cells=128)
    hj = JHorizonator(VIEW["lat"], VIEW["lon"], 400, 100, **kw)
    ht = THorizonator(VIEW["lat"], VIEW["lon"], 400, 100, device="cpu", **kw)
    assert str(ht) == str(hj) and ht.viewer_z == hj.viewer_z
    img_j, rng_j = hj.render(-180, 180, zfar=15000.0)
    img_t, rng_t = ht.render(-180, 180, zfar=15000.0)
    _compare(img_j, rng_j, img_t, rng_t)
    # camera move + single-output contract
    r_t = ht.render(-60, 60, lat=34.95, lon=-117.05, return_image=False,
                    zfar=15000.0)
    r_j = hj.render(-60, 60, lat=34.95, lon=-117.05, return_image=False,
                    zfar=15000.0)
    assert r_t.shape == (100, 400)
    assert ((r_t < 0) == (r_j < 0)).mean() >= 0.999
    assert ht.render(0, 10, return_image=False, return_range=False) == ()


def test_api_guard_and_unported(dem_dir):
    kw = dict(dir_dems=dem_dir, render_radius_cells=128, device="cpu")
    h = THorizonator(VIEW["lat"], VIEW["lon"], 64, 32, nsteps=64, **kw)
    with pytest.warns(RuntimeWarning, match="masked"):
        h.render(-60, 60, zfar=15000.0)
    hs = THorizonator(VIEW["lat"], VIEW["lon"], 64, 32, nsteps=64,
                      strict_coverage=True, **kw)
    with pytest.raises(RuntimeError, match="masked"):
        hs.render(-60, 60, zfar=15000.0)
    # region sharding runs the window march alone, as in the JAX package
    # (its runs: tests/test_torch_sharding.py)
    with pytest.raises(ValueError, match="'window' sampler"):
        THorizonator(VIEW["lat"], VIEW["lon"], 64, 32, region_mesh="auto",
                     sampler="crossing", **kw)
    with pytest.raises(ValueError, match="hillshade"):
        THorizonator(VIEW["lat"], VIEW["lon"], 64, 32, shadows=True, **kw)
    # a long clip swaps to the LOD march, as in the JAX package
    hl = THorizonator(VIEW["lat"], VIEW["lon"], 64, 32, nsteps=2048, **kw)
    _, rng = hl.render(-60, 60)
    assert hl._pyramid is not None and (rng > 0).any()
    with pytest.raises(ValueError, match="unknown sampler"):
        render_panorama(torch.zeros(8, 8), None, width=8, height=8,
                        nsteps=64, cells_per_deg=CPD, sampler="bogus")


def test_port_never_imports_jax(dem_dir):
    code = f"""
import sys
import numpy as np
from horizonator_tpu_torch import horizonator
h = horizonator({VIEW['lat']}, {VIEW['lon']}, 64, 32, dir_dems={dem_dir!r},
                render_radius_cells=64, device="cpu")
img, rng = h.render(-180, 180, zfar=8000.0)
assert img.shape == (32, 64, 3) and (rng > 0).any()
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert not any(m.startswith("horizonator_tpu.") or m == "horizonator_tpu"
               for m in sys.modules)
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(REPO),
                            "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")
