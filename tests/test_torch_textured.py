"""Port parity for the textured slice: march, hybrid near field, resolve,
render and API, against horizonator_tpu on the same inputs.

The JAX side runs as its own tests run it on the CPU (jitted, Pallas in
interpret mode); the port runs its kernels' plain versions. Tolerances:
- march, fed the JAX geometry, for the three plane forms (half-cell
  ColorPlanes2x, packed int32 cell planes, float (3, n, n) planes, integer
  and fractional) and both near-band forms: far-field tanel and tex
  bitwise (invalid samples carry 0 in both); near-band tanel within 1e-5
  (test_torch_window's reason) and near-band tex bitwise at >= 99% of the
  valid samples, channels within 1 (the near band takes sin/cos of the
  azimuth, which differ from XLA's by an ulp; measured 100% bitwise);
- hybrid near field on a random z12 atlas: >= 90% of the colors of the
  lanes it covers bitwise (measured 94.8%), channels within 16, and every
  other lane bitwise. The atlas y coordinate goes through sin/cos/log
  (test_torch_texture: within 0.0625 px), and a random atlas turns that
  into up to 0.0625 * 255 per channel. At least one color differs from
  the plain half-cell march;
- textured resolve: where the JAX package takes its fused kernel, idx,
  alpha, ok and tex bitwise. In its fallback regime, idx, alpha and ok
  bitwise; tex differs only where its merge's order among equal quantized
  keys hands a pixel the color of a later plateau sample (a horizon raised
  by less than 1/512 px), at <= 1% of the covered pixels of plausible
  rows (measured 0); the plateau regression passes in both regimes;
- textured renders and the API, on smooth colors (the case real tiles
  and hillshade are): sky masks equal at >= 99.9% of pixels, terrain
  pixels within 2 per channel except at <= 0.5% (a pixel that moves to a
  neighbouring sample, as in test_torch_render, or the near field's
  coordinate ulps), ranges as test_torch_render, and ranges bitwise equal
  to the port's own untextured render (texture changes only colors).
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from horizonator_tpu import horizonator as JHorizonator
from horizonator_tpu.render import raymarch as jraymarch
from horizonator_tpu.render import render_panorama as j_render
from horizonator_tpu.render import resolve_window as jresolve
from horizonator_tpu.render import texture as jtex
from horizonator_tpu.render.crossing import crossing_geometry as j_geometry
from horizonator_tpu.render.window import march_window as j_march
from horizonator_tpu_torch import horizonator as THorizonator
from horizonator_tpu_torch.render import params_from_jax, render_panorama
from horizonator_tpu_torch.render import resolve_window as tresolve
from horizonator_tpu_torch.render import texture as ttex
from horizonator_tpu_torch.render import window as twin
from horizonator_tpu_torch.render.crossing import k_cross_for
from tests.test_torch_geometry import (CPD, geo_to_torch, jax_params,
                                       make_dem, viewer_z)
from tests.test_torch_render import VIEW, dem_dir  # noqa: F401 (fixture)
from tests.test_torch_render import _terrain
from tests.test_torch_window import _near_band_close

NEG = -1e30
Q = twin.N_NEAR
SHIFTS = np.array([0, 8, 16])


def _chan_diff(a, b):
    """Largest per-channel difference of two packed 0x00RRGGBB arrays."""
    return int(np.abs(((a[..., None] >> SHIFTS) & 0xff).astype(int)
                      - ((b[..., None] >> SHIFTS) & 0xff)).max(initial=0))


@functools.partial(jax.jit, static_argnames=("width", "k", "znear_hint_m",
                                             "atlas_params", "exact_near_m"))
def _jax_march(dem, p, color_planes, atlas, width, k, znear_hint_m=100.0,
               atlas_params=None, exact_near_m=None):
    tanel, _, dists, _, tex = j_march(
        dem, p, width=width, k_cross=k, cells_per_deg=CPD, lat_hint_deg=34.0,
        znear_hint_m=znear_hint_m, color_planes=color_planes, atlas=atlas,
        atlas_params=atlas_params, exact_near_m=exact_near_m)
    return tanel, tex, dists.dropped


@functools.partial(jax.jit, static_argnames=("width",))
def _jax_geometry(p, width):
    return j_geometry(p, width=width, cells_per_deg=CPD)


def _planes(form, n, seed):
    """(JAX color_planes, port color_planes) of one plane form."""
    rng = np.random.default_rng(seed)
    if form == "half":
        c = rng.integers(0, 256, (3, 2 * n, 2 * n)).astype(np.float32)
        cp = jtex.prepare_color_planes(jnp.asarray(c))
        return cp, ttex.scene_from_jax(cp, device="cpu")[0]
    c = rng.integers(0, 256, (3, n, n)).astype(np.float32)
    if form == "packed":
        pk = jtex.pack_cell_colors(jnp.asarray(c))
        return pk, ttex.scene_from_jax(pk, device="cpu")[0]
    if form == "fraction":                 # e.g. hillshade: not integers
        c = c + rng.uniform(-0.5, 0.5, c.shape).astype(np.float32)
    return jnp.asarray(c), torch.from_numpy(c)


def _march_both(dem, jp, width, k, jplanes, tplanes, hint=100.0, **hyb):
    jt, jx, jd = _jax_march(jnp.asarray(dem), jp, jplanes, hyb.get("atlas"),
                            width, k, znear_hint_m=hint,
                            atlas_params=hyb.get("atlas_params"),
                            exact_near_m=hyb.get("exact_near_m"))
    assert int(jd) == 0
    _, at, apt = ttex.scene_from_jax(None, hyb.get("atlas"),
                                     hyb.get("atlas_params"), device="cpu")
    geo = geo_to_torch(_jax_geometry(jp, width))
    tt, dists, tx = twin.march_from_geometry(
        torch.from_numpy(dem), params_from_jax(jp, "cpu"), geo, k_cross=k,
        cells_per_deg=CPD, lat_hint_deg=34.0, znear_hint_m=hint,
        color_planes=tplanes, atlas=at, atlas_params=apt,
        exact_near_m=hyb.get("exact_near_m"))
    assert int(dists.dropped) == 0 and int(dists.truncated) == 0
    return (np.asarray(jt), np.asarray(jx)), (tt.numpy(), tx.numpy())


def _near_tex_close(tx, jx, valid):
    same = tx[valid] == jx[valid]
    assert same.mean() >= 0.99
    assert _chan_diff(tx[valid], jx[valid]) <= 1


@pytest.mark.parametrize("form", ["half", "packed", "integer", "fraction"])
@pytest.mark.parametrize("n,vi,vj,hint", [(192, 96.3, 95.7, 100.0),
                                          (192, 96.3, 95.7, None),
                                          (100, 50.5, 3.25, 100.0)])
def test_textured_march_matches_jax(form, n, vi, vj, hint):
    dem = make_dem(n, rough=4.0)
    jp = jax_params(vi, vj, viewer_z(dem, vi, vj, 5.0), zfar=8000.0)
    k = k_cross_for(8000.0, CPD, 34.0, n=n)
    jplanes, tplanes = _planes(form, n, seed=n)
    (jt, jx), (tt, tx) = _march_both(dem, jp, 256, k, jplanes, tplanes,
                                     hint=hint)
    assert tt.shape == jt.shape and tx.shape == jx.shape
    assert tx.dtype == np.int32
    np.testing.assert_array_equal(tt[:, Q:], jt[:, Q:])
    np.testing.assert_array_equal(tx[:, Q:], jx[:, Q:])
    _near_band_close(tt[:, :Q], jt[:, :Q])
    _near_tex_close(tx[:, :Q], jx[:, :Q], jt[:, :Q] > NEG)
    assert (tx[:, Q:][jt[:, Q:] <= NEG] == 0).all()
    assert (tx[jt > NEG] != 0).mean() > 0.9          # colors really ride


def test_textured_march_shape_checks():
    dem = torch.from_numpy(make_dem(64))
    tp = params_from_jax(jax_params(30.5, 31.5, 900.0, zfar=4000.0), "cpu")
    kw = dict(width=32, k_cross=64, cells_per_deg=CPD)
    for bad in (torch.zeros(64, 64), torch.zeros(64, 64, dtype=torch.int32)
                [:60], torch.zeros(3, 96, 96), torch.zeros(2, 64, 64),
                ttex.ColorPlanes2x(torch.zeros(64, 64, dtype=torch.int32))):
        with pytest.raises(ValueError):
            twin.march_window(dem, tp, color_planes=bad, **kw)
    out = twin.march_window(dem, tp, color_planes=torch.zeros(
        64, 64, dtype=torch.int32), **kw)
    assert len(out) == 5 and out[4].shape == out[0].shape


def _atlas_scene(n, vi, vj, seed, smooth=False):
    """A z12 atlas of 4x4 tiles around the viewer, as JAX + port state."""
    rng = np.random.default_rng(seed)
    olon, olat = -118.0, 34.0
    tx, ty = jtex.tile_xy_from_latlon(olat + vj / CPD, olon + vi / CPD, 12)
    ap = jtex.AtlasParams(olon, olat, tx - 1, ty - 1, 4, 4)
    if smooth:
        yy, xx = np.mgrid[0:1024, 0:1024].astype(np.float32)
        bgr = np.stack([128 + 100 * np.sin(xx / 37.0 + c) * np.cos(yy / 29.0)
                        for c in range(3)], axis=-1)
        atlas = np.asarray(jtex.pack_atlas(jnp.asarray(
            np.round(bgr).astype(np.uint8))))
    else:
        atlas = rng.integers(0, 1 << 24, (1024, 1024)).astype(np.int32)
    return atlas, ap


def test_hybrid_near_field_matches_jax():
    n, vi, vj = 257, 131.3, 120.7
    dem = make_dem(n)
    jp = jax_params(vi, vj, viewer_z(dem, vi, vj), zfar=9000.0)
    k = k_cross_for(9000.0, CPD, 34.0, n=n)
    jplanes, tplanes = _planes("half", n, seed=5)
    atlas, ap = _atlas_scene(n, vi, vj, seed=5)
    hyb = dict(atlas=jnp.asarray(atlas), atlas_params=ap, exact_near_m=1500.0)
    (jt, jx), (tt, tx) = _march_both(dem, jp, 256, k, jplanes, tplanes, **hyb)
    k_x, _ = twin.exact_near_sizes(1500.0, CPD, 34.0, ap.zoom)
    lanes = Q + k_x
    np.testing.assert_array_equal(tt[:, Q:], jt[:, Q:])
    np.testing.assert_array_equal(tx[:, lanes:], jx[:, lanes:])
    assert (tx[:, :lanes] == jx[:, :lanes]).mean() >= 0.9
    assert _chan_diff(tx[:, :lanes], jx[:, :lanes]) <= 16
    # the near field really is replaced
    _, (_, plain) = _march_both(dem, jp, 256, k, jplanes, tplanes)
    assert (plain[:, :lanes] != tx[:, :lanes]).any()
    np.testing.assert_array_equal(plain[:, lanes:], tx[:, lanes:])


def test_hybrid_cap_warns_and_falls_back():
    n, vi, vj = 257, 131.3, 120.7
    dem = make_dem(n)
    jp = jax_params(vi, vj, viewer_z(dem, vi, vj), zfar=9000.0)
    k = k_cross_for(9000.0, CPD, 34.0, n=n)
    _, tplanes = _planes("half", n, seed=5)
    atlas, ap = _atlas_scene(n, vi, vj, seed=5)
    geo = geo_to_torch(_jax_geometry(jp, 64))
    kw = dict(k_cross=k, cells_per_deg=CPD, lat_hint_deg=34.0,
              color_planes=tplanes)
    tp = params_from_jax(jp, "cpu")
    with pytest.warns(RuntimeWarning, match="hybrid near-field"):
        _, _, tx = twin.march_from_geometry(
            torch.from_numpy(dem), tp, geo, atlas=torch.from_numpy(atlas),
            atlas_params=ttex.AtlasParams(*ap), exact_near_m=20000.0, **kw)
    _, _, plain = twin.march_from_geometry(torch.from_numpy(dem), tp, geo,
                                           **kw)
    assert torch.equal(tx, plain)


# -- resolve ---------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("height",))
def _jax_window_tex(y, tex, height):
    return jresolve.resolve_window(y, height, tex=tex, monotone=False)


@functools.partial(jax.jit, static_argnames=("height",))
def _jax_fallback_tex(y, tex, height):
    """resolve_to_image's fallback: run-max rows, argmax-propagated colors
    (tanel = -y is an order-reversing map of the rows)."""
    tanel = -y
    run = jraymarch._scan_shift(tanel, jnp.maximum, -3.0e38)
    _, tex_eff = jraymarch._scan_shift_argmax(tanel, tex, -3.0e38)
    return jraymarch._resolve_rows(-run, height, tex=tex_eff)


def _rows_tex(w, k, h, seed, hair=True):
    rng = np.random.default_rng(seed)
    y = (h * (0.5 + 0.4 * rng.standard_normal((w, k)))).astype(np.float32)
    if hair:
        # horizons raised by a hair: same 1/256-px key, other samples
        y[:, 1::7] = y[:, ::7][:, :y[:, 1::7].shape[1]] - 1e-4
    tex = rng.integers(1, 1 << 24, (w, k)).astype(np.int32)
    return y, tex


@pytest.mark.parametrize("w,k,h,seed", [(24, 90, 128, 0), (16, 300, 100, 1),
                                        (8, 580, 37, 2)])
def test_textured_resolve_matches_fused_kernel(w, k, h, seed):
    y, tex = _rows_tex(w, k, h, seed)
    assert tresolve.resolve_fits(k, h)
    ref = _jax_window_tex(jnp.asarray(y), jnp.asarray(tex), h)
    got = tresolve.resolve_window(torch.from_numpy(y), h,
                                  tex=torch.from_numpy(tex))
    for name, r, g in zip(("idx", "alpha", "ok", "tex"), ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy(),
                                      err_msg=name)
    assert (got[3].numpy()[got[0].numpy() < k] != 0).all()


@pytest.mark.parametrize("w,k,h", [(6, 4000, 128), (4, 64, 4096)])
def test_textured_resolve_fallback_regime(w, k, h):
    y, tex = _rows_tex(w, k, h, 11, hair=False)
    assert not tresolve.resolve_fits(k, h)
    ref = [np.asarray(r) for r in _jax_fallback_tex(jnp.asarray(y),
                                                   jnp.asarray(tex), h)]
    got = [g.numpy() for g in tresolve.resolve_window(
        torch.from_numpy(y), h, tex=torch.from_numpy(tex))]
    for name, r, g in zip(("idx", "alpha", "ok"), ref, got):
        np.testing.assert_array_equal(r, g, err_msg=name)
    covered = got[0] < k
    assert covered.mean() > 0.3
    np.testing.assert_array_equal(got[3][~covered], 0)
    np.testing.assert_array_equal(
        got[3][covered], np.take_along_axis(tex, got[0], 1)[covered])
    assert (ref[3][covered] != got[3][covered]).mean() <= 0.01


@pytest.mark.parametrize("h", [256, 4096])
def test_textured_plateau_delivers_first_crossing_color(h):
    """The JAX regression (test_resolve.py:374-404) on the port, in the
    fused-kernel regime (h 256) and the fallback (h 4096)."""
    k, w = 256, 4
    y = np.full((w, k), 240.0, np.float32)        # low far terrain
    y[:, 10] = 50.0                               # the visible crest
    y[:, 11:48] = 120.0                           # occluded behind it
    tex = np.broadcast_to(np.arange(k, dtype=np.int32) + 1, (w, k)).copy()
    assert tresolve.resolve_fits(k, h) == (h == 256)
    idx, _, _, tex_hw = tresolve.resolve_window(
        torch.from_numpy(y), h, tex=torch.from_numpy(tex))
    covered = (np.arange(h) >= 50) & (np.arange(h) < 240)
    assert (idx.numpy()[:, covered] == 10).all()
    assert (tex_hw.numpy()[:, covered] == 11).all()
    jfn = _jax_window_tex if h == 256 else _jax_fallback_tex
    ref = jfn(jnp.asarray(y), jnp.asarray(tex), h)
    assert (np.asarray(ref[3])[:, covered] == 11).all()


# -- render and API ----------------------------------------------------------

def _smooth_planes(n, scale):
    jj, ii = np.mgrid[0:scale * n, 0:scale * n].astype(np.float32) / scale
    return np.stack([127.5 + 120 * np.sin(ii / 9.0 + c) * np.cos(jj / 7.0)
                     for c in range(3)]).astype(np.float32)


def _compare_textured(img_j, rng_j, img_t, rng_t):
    assert img_t.shape == img_j.shape and img_t.dtype == np.uint8
    sky_j, sky_t = rng_j < 0, rng_t < 0
    assert (sky_j == sky_t).mean() >= 0.999
    terr = ~sky_j & ~sky_t
    assert sky_j.mean() < 0.95 and terr.mean() > 0.05
    diff = np.abs(img_j.astype(int) - img_t.astype(int)).max(axis=-1)
    assert (diff[terr] > 2).mean() <= 0.005
    assert (img_t[sky_t] == [255, 0, 0]).all()
    assert img_t[terr][:, 1].astype(int).sum() > 0     # colors, not a ramp
    rel = np.abs(rng_t[terr] - rng_j[terr]) / rng_j[terr]
    assert (rel > 1e-4).mean() <= 0.001


@pytest.mark.parametrize("quality", ["hybrid", "grid", "exact"])
def test_textured_render_matches_jax(dem_dir, quality):  # noqa: F811
    from horizonator_tpu.dem import load_mosaic as j_load_mosaic
    m = j_load_mosaic(VIEW["lat"], VIEW["lon"], render_radius_cells=128,
                      datadir=dem_dir)
    dem = m.grid.astype(np.float32)
    n = dem.shape[0]
    at = (VIEW["lat"], VIEW["lon"])
    ci, cj = m.viewer_cell(*at)
    jp = jax_params(ci, cj, m.auto_viewer_z(*at), zfar=15000.0,
                    lat=VIEW["lat"])
    k = k_cross_for(15000.0, CPD, VIEW["lat"], n=n)
    kw = dict(width=256, height=128, nsteps=k, cells_per_deg=CPD,
              lat_hint_deg=30.0)
    atlas, ap = _atlas_scene(n, ci, cj, seed=9, smooth=True)
    ap = ap._replace(origin_cell_lon_deg=m.origin_cell_lon_deg,
                     origin_cell_lat_deg=m.origin_cell_lat_deg,
                     osmtile_lowest_x=jtex.tile_xy_from_latlon(
                         *at, 12)[0] - 1,
                     osmtile_lowest_y=jtex.tile_xy_from_latlon(
                         *at, 12)[1] - 1)
    jplanes = None
    if quality == "hybrid":
        jplanes = jtex.prepare_color_planes(jnp.asarray(_smooth_planes(n, 2)))
    elif quality == "grid":
        jplanes = jnp.asarray(_smooth_planes(n, 1))
    hyb = dict(atlas=jnp.asarray(atlas), atlas_params=ap,
               exact_near_m=1200.0 if quality == "hybrid" else None)
    img_j, rng_j = j_render(jnp.asarray(dem), jp, sampler="window",
                            textured=True, color_planes=jplanes, **hyb, **kw)
    tplanes, tatlas, tap = ttex.scene_from_jax(jplanes, atlas, ap,
                                               device="cpu")
    tp = params_from_jax(jp, "cpu")
    img_t, rng_t, guard = render_panorama(
        torch.from_numpy(dem), tp, textured=True, color_planes=tplanes,
        atlas=tatlas, atlas_params=tap, exact_near_m=hyb["exact_near_m"],
        with_dropped=True, **kw)
    assert guard.tolist() == [0, 0]
    _compare_textured(np.asarray(img_j), np.asarray(rng_j), img_t.numpy(),
                      rng_t.numpy())
    _, rng_u = render_panorama(torch.from_numpy(dem), tp, **kw)
    assert torch.equal(rng_t, rng_u)


def _write_tiles(root, lat, lon, radius):
    """Smooth seeded z12 tiles (gradients + a low-frequency wave) covering
    build_atlas' range, written as PNG like a tile cache."""
    x_lo, y_lo = jtex.tile_xy_from_latlon(lat + radius / CPD,
                                          lon - radius / CPD, 12)
    x_hi, y_hi = jtex.tile_xy_from_latlon(lat - radius / CPD,
                                          lon + radius / CPD, 12)
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float32)
    for x in range(x_lo, x_hi + 1):
        for y in range(y_lo, y_hi + 1):
            a, b, c = rng.uniform(0.2, 0.8, 3)
            rgb = np.stack([60 + 150 * a * xx / 255, 60 + 150 * b * yy / 255,
                            128 + 60 * np.sin(xx / 40.0 + c)], axis=-1)
            p = root / "mapnik" / "12" / str(x) / f"{y}.png"
            p.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(np.round(rgb).astype(np.uint8)).save(p)


@pytest.mark.parametrize("kind", ["hillshade", "hybrid", "exact"])
def test_api_textured_matches_jax(dem_dir, tmp_path, kind):  # noqa: F811
    kw = dict(dir_dems=dem_dir, render_radius_cells=128)
    if kind == "hillshade":
        kw["hillshade"] = True
    else:
        _write_tiles(tmp_path, VIEW["lat"], VIEW["lon"], 128)
        kw.update(render_texture=True, dir_tiles=str(tmp_path),
                  allow_downloads=False, texture_quality=kind)
    hj = JHorizonator(VIEW["lat"], VIEW["lon"], 256, 96, **kw)
    ht = THorizonator(VIEW["lat"], VIEW["lon"], 256, 96, device="cpu", **kw)
    assert ht.render_texture and hj.render_texture
    img_j, rng_j = hj.render(-180, 180, zfar=15000.0)
    img_t, rng_t = ht.render(-180, 180, zfar=15000.0)
    _compare_textured(img_j, rng_j, img_t, rng_t)
    if kind == "hillshade":
        terr = rng_t > 0
        b, g, r = (img_t[terr][:, c].astype(int) for c in range(3))
        assert (b == g).all() and (r >= g).all()      # gray + the red ramp
        assert g.std() > 1.0                          # shaded, not flat


def test_api_textured_options(dem_dir, tmp_path):  # noqa: F811
    kw = dict(dir_dems=dem_dir, render_radius_cells=64, device="cpu")
    args = (VIEW["lat"], VIEW["lon"], 64, 32)
    for bad, err in (({"hillshade": True, "render_texture": True},
                      ValueError),
                     ({"shadows": True}, ValueError),
                     ({"texture_quality": "best"}, ValueError)):
        with pytest.raises(err):
            THorizonator(*args, **kw, **bad)
    with pytest.raises(FileNotFoundError):       # empty tile cache
        THorizonator(*args, render_texture=True, dir_tiles=str(tmp_path),
                     allow_downloads=False, **kw)
    h = THorizonator(*args, render_texture=True, dir_tiles=str(tmp_path),
                     allow_downloads=False, texture_on_error="placeholder",
                     **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        img, rng = h.render(-60, 60, zfar=8000.0)
    vis = rng > 0
    assert vis.any()
    # flat gray placeholder tiles: 0.7 * 200 in B and G
    assert (np.abs(img[vis][:, :2].astype(int) - 140) <= 1).all()
    with pytest.raises(ValueError, match="debug_fill"):
        h.render(-60, 60, debug_fill="solid")
    img_d, rng_d = h.render(-60, 60, zfar=8000.0, debug_fill="wireframe")
    assert np.array_equal(rng_d, rng) and not np.array_equal(img_d, img)
    hs = THorizonator(*args, hillshade=True, sun_time="2024-06-21T19:30:00",
                      **kw)
    assert 0.0 < hs.sun_alt_deg < 90.0
    assert hs.render(0, 90, return_image=False).shape == (32, 64)
    # cast shadows change colour only (tests/test_torch_shadows.py holds
    # the image against the JAX package)
    hsh = THorizonator(*args, hillshade=True, shadows=True,
                       sun_time="2024-06-21T19:30:00", **kw)
    assert np.array_equal(hsh.render(0, 90, return_image=False),
                          hs.render(0, 90, return_image=False))
    assert _terrain is not None
