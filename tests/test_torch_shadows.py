"""Port parity for cast shadows: ops/shadows (shadow_light, sun_hours,
_ray_step), hillshade_planes(cast_shadows=True), the API's shadows=True and
the CLI's --shadows, against horizonator_tpu on the same inputs, and the
port alone against a brute-force per-ray oracle.

Tolerances, and why:
- ``_ray_step``: equal (the same host math);
- ``shadow_light``: within 2 ulp of G, divided by soft_m, where G bounds
  |g| = |z - s tan(alt)| (max |z| plus (n_j + n_i) cells of ramp).
  XLA contracts some of the JAX function's products into fused
  multiply-adds and not others, depending on the grid's shape, and the
  port rounds each operation once (ops/shadows.py's docstring): the two g
  fields, and so the blocker heights, differ by at most an ulp or two of
  G. With soft_m = 1e-3 that bound exceeds the
  light's range, so there the light may differ only where the oracle's
  blocker height lies within soft_m + 4 ulp of G of 0, and the lit /
  shadowed class only within 4 ulp of G of 0;
- ``sun_hours``: the light's bound at each daylight sun's altitude, summed
  over those suns, times 24 / samples, plus an ulp of 24 for each sum's
  rounding; flat terrain bitwise (every light is 1);
- hillshade planes: test_torch_texture's 1e-3 plus (1 - ambient) * 255
  times the light's tolerance at the default soft_m;
- the API's image and the CLI's PNG: test_torch_textured's
  ``_compare_textured``; ranges bitwise equal to the unshadowed render's
  (shadows change colour only).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizonator_tpu import horizonator as JHorizonator
from horizonator_tpu.ops import shadows as jsh
from horizonator_tpu.render import texture as jtex
from horizonator_tpu_torch import horizonator as THorizonator
from horizonator_tpu_torch.ops import shadows as tsh
from horizonator_tpu_torch.render import texture as ttex
from tests.test_torch_cli import LAT, LON, RENDER, _png_bgr, _run_both
from tests.test_torch_cli import dem_dir as cli_dem_dir  # noqa: F401
from tests.test_torch_textured import _compare_textured

CPD = 1200
EARTH_R = 6371000.0
SUNS = [(90.0, 25.0), (0.0, 35.0), (45.0, 30.0), (112.0, 20.0),
        (247.0, 40.0), (183.0, 10.0)]   # tests/test_shadows.py:126-133


def _cells(cells_per_deg, lat_deg):
    cell_n = EARTH_R * math.pi / 180.0 / cells_per_deg
    return cell_n, cell_n * max(0.05, abs(math.cos(math.radians(lat_deg))))


def _steep(n=72, seed=7):
    """tests/test_shadows.py's steep random terrain."""
    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    z = (500 * np.sin(ii / 6.0) * np.cos(jj / 9.0)
         + 250 * np.sin((ii + 2 * jj) / 13.0)
         + 30 * rng.standard_normal((n, n))).astype(np.float32)
    return np.maximum(z + 500, 0)


def _wall(n=64, at=50, h=400.0):
    z = np.zeros((n, n), np.float32)
    z[:, at] = h
    return z


def _g_ulp(z, alt_deg, cells_per_deg=CPD):
    """One ulp of the bound G on |g| (the module docstring)."""
    cell_n = EARTH_R * math.pi / 180.0 / cells_per_deg
    ramp = sum(z.shape) * cell_n * math.tan(math.radians(min(alt_deg, 89.9)))
    return float(np.spacing(np.float32(np.abs(z).max() + ramp)))


def _oracle_margin(z, cells_per_deg, lat_deg, sun_az_deg, sun_alt_deg,
                   substep=1.0):
    """Max blocker height above the sun ray (meters) per cell, by brute
    float64 bilinear sampling along the port's quantized ray
    (tsh._ray_step). Positive = shadowed. substep < 1 samples between the
    op's lattice steps."""
    nj, ni = z.shape
    dj1, di1, h1, _, _, _ = tsh._ray_step(cells_per_deg, lat_deg,
                                          sun_az_deg, 16)
    tan_alt = math.tan(math.radians(sun_alt_deg))
    h, dj, di = substep * h1, substep * dj1, substep * di1
    zd = z.astype(np.float64)

    def bil(jf, if_):
        j0 = np.clip(np.floor(jf).astype(int), 0, nj - 2)
        i0 = np.clip(np.floor(if_).astype(int), 0, ni - 2)
        fj, fi = jf - j0, if_ - i0
        return ((1 - fj) * (1 - fi) * zd[j0, i0]
                + (1 - fj) * fi * zd[j0, i0 + 1]
                + fj * (1 - fi) * zd[j0 + 1, i0]
                + fj * fi * zd[j0 + 1, i0 + 1])

    jj, ii = np.meshgrid(np.arange(nj, dtype=float),
                         np.arange(ni, dtype=float), indexing="ij")
    margin = np.full(z.shape, -np.inf)
    for t in range(1, int(math.hypot(nj, ni) / substep) + 2):
        jf, if_ = jj + t * dj, ii + t * di
        inside = (jf >= 0) & (jf <= nj - 1) & (if_ >= 0) & (if_ <= ni - 1)
        s = bil(jf, if_) - zd - t * h * tan_alt
        margin = np.maximum(margin, np.where(inside, s, -np.inf))
    return margin


def _both(z, **kw):
    lj = np.asarray(jsh.shadow_light(jnp.asarray(z), **kw))
    lt = tsh.shadow_light(torch.from_numpy(z), **kw)
    assert lt.dtype == torch.float32 and lt.shape == z.shape
    return lj, lt.numpy()


@pytest.mark.parametrize("cpd,lat,az,denom", [
    (1200, 34.0, 112.0, 16), (3600, 61.0, 247.0, 16), (1200, -45.0, 0.0, 8),
    (1200, 89.0, 300.0, 16), (3600, 10.0, 45.0, 4), (1200, 34.0, 183.0, 1)])
def test_ray_step_matches_jax(cpd, lat, az, denom):
    assert tsh._ray_step(cpd, lat, az, denom) == jsh._ray_step(cpd, lat, az,
                                                               denom)


@pytest.mark.parametrize("soft_m", [2.0, 1e-3])
@pytest.mark.parametrize("az,alt", SUNS)
def test_shadow_light_steep_matches_jax(az, alt, soft_m):
    z = _steep()
    kw = dict(cells_per_deg=CPD, lat_deg=34.0, sun_az_deg=az,
              sun_alt_deg=alt, soft_m=soft_m)
    lj, lt = _both(z, **kw)
    u = _g_ulp(z, alt)
    assert np.abs(lt - lj).max() <= 2 * u / soft_m
    margin = _oracle_margin(z, CPD, 34.0, az, alt)
    assert (np.abs(margin[lt != lj]) <= soft_m + 4 * u).all()
    flip = (lt > 0.5) != (lj > 0.5)
    assert (np.abs(margin[flip]) <= 4 * u).all()


@pytest.mark.parametrize("name,z,kw", [
    ("flat", np.zeros((64, 64), np.float32),
     dict(sun_az_deg=123.0, sun_alt_deg=30.0)),
    ("wall", _wall(), dict(sun_az_deg=90.0, sun_alt_deg=30.0)),
    ("below_horizon", np.zeros((32, 32), np.float32),
     dict(sun_az_deg=90.0, sun_alt_deg=-3.0)),
    ("soft_narrow", _wall(48, 40, 300.0),
     dict(sun_az_deg=90.0, sun_alt_deg=25.0, soft_m=0.5)),
    ("soft_wide", _wall(48, 40, 300.0),
     dict(sun_az_deg=90.0, sun_alt_deg=25.0, soft_m=20.0)),
    ("oblique_cpd3600", _steep(80, 3),
     dict(sun_az_deg=301.0, sun_alt_deg=15.0, cells_per_deg=3600,
          lat_deg=61.0)),
])
def test_shadow_light_scenes_match_jax(name, z, kw):
    kw = {"cells_per_deg": CPD, "lat_deg": 34.0, **kw}
    lj, lt = _both(z, **kw)
    u = _g_ulp(z, max(kw["sun_alt_deg"], 0.0), kw["cells_per_deg"])
    assert np.abs(lt - lj).max() <= 2 * u / kw.get("soft_m", 2.0)
    if name == "flat":
        assert (lt == 1.0).all()
    elif name == "below_horizon":
        assert (lt == 0.0).all()
    elif name == "wall":
        # tests/test_shadows.py:94: shadowed out to h/tan(alt), lit beyond
        reach = 400.0 / math.tan(math.radians(30.0)) / _cells(CPD, 34.0)[1]
        for i in range(50):
            d = 50 - i
            if d < reach - 1:
                assert lt[30, i] < 0.5
            elif d > reach + 1:
                assert lt[30, i] > 0.5
        assert (lt[:, 51:] > 0.5).all()
    elif name.startswith("soft"):
        assert lt[24, 0] == 1.0 and lt[24, 39] < (0.5 if name == "soft_narrow"
                                                  else 1.0)


@pytest.mark.parametrize("az,alt,clear_m,substep", [
    *[(az, alt, 0.5, 1.0) for az, alt in SUNS], (112.0, 20.0, 30.0, 0.25)])
def test_shadow_light_vs_oracle(az, alt, clear_m, substep):
    """The port alone against its brute-force oracle on the same lattice
    (and 4x denser, where only clearly lit or shadowed cells must hold):
    tests/test_shadows.py's margin rule."""
    z = _steep()
    light = tsh.shadow_light(torch.from_numpy(z), cells_per_deg=CPD,
                             lat_deg=34.0, sun_az_deg=az, sun_alt_deg=alt,
                             soft_m=1e-3).numpy()
    margin = _oracle_margin(z, CPD, 34.0, az, alt, substep=substep)
    assert (light[margin > clear_m] < 0.5).all()
    assert (light[margin < -clear_m] > 0.5).all()


def test_shadow_light_guards():
    with pytest.raises(ValueError, match="2D"):
        tsh.shadow_light(torch.zeros(2, 8, 8), cells_per_deg=CPD,
                         lat_deg=34.0, sun_az_deg=90.0, sun_alt_deg=30.0)


@pytest.mark.parametrize("name,z,kw", [
    ("flat", np.zeros((16, 16), np.float32),
     dict(lat_deg=34.0, lon_deg=-117.0, date="2026-06-21", samples=12)),
    ("pit", None,
     dict(lat_deg=45.0, lon_deg=7.0, date="2026-01-15", samples=8)),
])
def test_sun_hours_matches_jax(name, z, kw):
    if z is None:                       # tests/test_shadows.py:201
        z = np.zeros((48, 48), np.float32)
        z[20:28, 20:28] = 800.0
        z[23:25, 23:25] = 0.0
    hj = np.asarray(jsh.sun_hours(z, cells_per_deg=CPD, **kw))
    ht = tsh.sun_hours(torch.from_numpy(z), cells_per_deg=CPD, **kw).numpy()
    assert ht.dtype == np.float32 and ht.shape == z.shape
    if name == "flat":
        np.testing.assert_array_equal(ht, hj)
        assert ht[0, 0] > 10.0               # summer solstice at lat 34
    else:
        alts = _daylight_alts(kw)
        assert len(alts) >= 2
        tol = (sum(2 * _g_ulp(z, alt) / 2.0 for alt in alts)
               * 24.0 / kw["samples"] + (len(alts) + 1) * np.spacing(
                   np.float32(24.0)))
        assert tol < 0.05
        assert np.abs(ht - hj).max() <= tol
        assert ht[24, 24] < ht[5, 5] - 1.0


def _daylight_alts(kw):
    """The altitudes of the suns sun_hours adds for ``kw``'s day."""
    from datetime import date, datetime

    from horizonator_tpu_torch import geometry
    d = date.fromisoformat(kw["date"])
    alts = [geometry.sun_position(
        kw["lat_deg"], kw["lon_deg"],
        datetime(d.year, d.month, d.day) + tsh._frac_day(k / kw["samples"]))[1]
        for k in range(kw["samples"])]
    return [a for a in alts if a > 0.0]


@pytest.mark.parametrize("scale", [1, 2])
@pytest.mark.parametrize("z,az,alt", [(_wall(), 90.0, 25.0),
                                      (_steep(), 247.0, 20.0)])
def test_hillshade_cast_shadows_matches_jax(z, az, alt, scale):
    kw = dict(sun_az_deg=az, sun_alt_deg=alt, scale=scale, cast_shadows=True)
    hj = np.asarray(jtex.hillshade_planes(jnp.asarray(z), CPD, 34.0, **kw))
    ht = ttex.hillshade_planes(torch.from_numpy(z), CPD, 34.0, **kw).numpy()
    assert ht.shape == hj.shape == (3, scale * z.shape[0],
                                    scale * z.shape[1])
    tol = 1e-3 + 0.75 * 255.0 * 2 * _g_ulp(z, alt) / 2.0
    assert np.abs(ht - hj).max() <= tol
    base = ttex.hillshade_planes(torch.from_numpy(z), CPD, 34.0,
                                 **{**kw, "cast_shadows": False}).numpy()
    assert (ht <= base).all() and (ht < base - 30.0).any()


def test_api_shadows_matches_jax(cli_dem_dir):  # noqa: F811
    # a low sun behind the peaks casts their shadows toward the viewer
    kw = dict(dir_dems=cli_dem_dir, render_radius_cells=160, hillshade=True,
              sun_az_deg=20.0, sun_alt_deg=12.0)
    hj = JHorizonator(LAT, LON, 256, 96, shadows=True, **kw)
    ht = THorizonator(LAT, LON, 256, 96, shadows=True, device="cpu", **kw)
    img_j, rng_j = hj.render(-180, 180, zfar=15000.0)
    img_t, rng_t = ht.render(-180, 180, zfar=15000.0)
    _compare_textured(img_j, rng_j, img_t, rng_t)
    h0 = THorizonator(LAT, LON, 256, 96, device="cpu", **kw)
    img0, rng0 = h0.render(-180, 180, zfar=15000.0)
    np.testing.assert_array_equal(rng_t, rng0)
    terr = rng_t > 0
    assert (img_t[terr] <= img0[terr]).all()
    assert (img_t[terr] < img0[terr]).any()


def test_cli_shadows_matches_jax(cli_dem_dir, tmp_path):  # noqa: F811
    argv = ["--width", "300", "--height", "100", "--image", "{out}",
            "--ranges", "{out}.npy", "--dirdems", cli_dem_dir, *RENDER,
            "--hillshade", "--shadows", "--sun-az", "20", "--sun-alt", "12",
            "34.40", "-117.45", "0", "60"]
    res = _run_both(tmp_path, "pano.png", argv)
    (rj, dj, _), (rt, dt, _) = res["jax"], res["torch"]
    assert rj == rt == 0
    img_t, rng_t = _png_bgr(dt / "pano.png"), np.load(dt / "pano.png.npy")
    _compare_textured(_png_bgr(dj / "pano.png"), np.load(dj / "pano.png.npy"),
                      img_t, rng_t)
    terr = rng_t > 0
    assert (img_t[terr][:, 0] == img_t[terr][:, 1]).all()     # gray
