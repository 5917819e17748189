"""Port parity for the LOD slice: render/lod.py, render_panorama(sampler=
"lod") and the API's auto-LOD swap, against horizonator_tpu on the same
inputs.

The JAX side runs as tests/test_lod.py and tests/test_api_lod.py run it on
the CPU: march_lod eagerly around the jitted march_window (Pallas in
interpret mode), render_panorama jitted; the port runs its kernels' plain
versions. Tolerances, and why:
- lod_plan and level_crop_size: equal (host math);
- build_pyramid, build_color_pyramid and _crop_level: bitwise. The pools
  and the tent are the JAX package's float32 operations in its order, and
  the crop is an exact gather with an exact integer rebase;
- march_lod fed each level's JAX crossing geometry (test_torch_window's
  method): the far-field lanes of every level bitwise, tangents and
  colours, NEG_BIG and the 0 colour included; the near band within
  test_torch_window's tolerance (1e-5, >= 95% bitwise) and its colours
  bitwise at >= 99% of valid samples, channels within 1
  (test_torch_textured's); LodDists' e and scale, d_of over every lane, and
  the dropped / truncated guards equal;
- LodDists.d_of on the same arrays: bitwise;
- renders through the port's own geometry and the API: test_torch_render's
  ``_compare`` untextured, test_torch_textured's ``_compare_textured`` for
  colours and hillshade.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizonator_tpu import horizonator as JHorizonator
from horizonator_tpu.render import RenderParams as JParams
from horizonator_tpu.render import lod as jlod
from horizonator_tpu.render import render_panorama as j_render
from horizonator_tpu.render import texture as jtex
from horizonator_tpu.render.crossing import crossing_geometry as j_geometry
from horizonator_tpu_torch import horizonator as THorizonator
from horizonator_tpu_torch.render import lod as tlod
from horizonator_tpu_torch.render import params_from_jax, render_panorama
from horizonator_tpu_torch.render import texture as ttex
from horizonator_tpu_torch.render.crossing import N_NEAR, k_cross_for
from tests.conftest import make_synthetic_dem_dir
from tests.test_torch_geometry import (CPD, geo_to_torch, jax_params,
                                       make_dem, viewer_z)
from tests.test_torch_render import VIEW, _compare
from tests.test_torch_render import dem_dir  # noqa: F401 (fixture)
from tests.test_torch_textured import (_compare_textured, _smooth_planes,
                                       _write_tiles)
from tests.test_torch_window import NEG, _near_band_close

N_LOD = 768          # three levels at W 128, zfar 20 km; levels 0-1 cropped
W_LOD = 128
ZFAR_LOD = 20000.0


def _plan(lat=34.0, n=N_LOD):
    return jlod.lod_plan(ZFAR_LOD, W_LOD, CPD, lat, n)


_jax_geo = jax.jit(j_geometry, static_argnames=("width", "cells_per_deg"))


def _to_jax_params(tp):
    return JParams(*[jnp.float32(np.float32(x.item())) for x in tp])


@pytest.fixture
def jax_geometry(monkeypatch):
    """The port's march_lod fed each level's JAX crossing geometry."""
    def geo(p, *, width, cells_per_deg):
        return geo_to_torch(_jax_geo(_to_jax_params(p), width=width,
                                     cells_per_deg=cells_per_deg))
    monkeypatch.setattr(tlod, "crossing_geometry", geo)


# -- the plan and the pyramids --------------------------------------------

@pytest.mark.parametrize("zfar", [20000.0, 45000.0, 300000.0])
def test_plan_and_crop_size_match_jax(zfar):
    for width in (128, 2048, 4096):
        for cpd in (1200, 3600):
            for lat in (0.0, 34.0, 61.0, 89.99):
                for n in (256, 1201, 3601):
                    tp = tlod.lod_plan(zfar, width, cpd, lat, n)
                    jp = jlod.lod_plan(zfar, width, cpd, lat, n)
                    assert tp == jp
                    for spec in tp:
                        for hint in (0.0, lat, -45.0):
                            cpd_l = cpd / 2 ** spec.level
                            assert tlod.level_crop_size(spec, cpd_l, hint) \
                                == jlod.level_crop_size(spec, cpd_l, hint)
    assert len(tlod.lod_plan(300000.0, 2048, 3600, 34.0, 3601)) == 5


@pytest.mark.parametrize("n", [256, 257, 301])
def test_build_pyramid_bitwise(n):
    dem = make_dem(n)
    jp = jlod.build_pyramid(jnp.asarray(dem), 4)
    tp = tlod.build_pyramid(torch.from_numpy(dem), 4)
    assert len(tp) == 4 and tp[3].shape == (-(-n // 8),) * 2
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _color_inputs(form, n, seed=5):
    """(JAX input, port input) colour planes of one form."""
    rng = np.random.default_rng(seed)
    if form == "planes2x":
        c = rng.integers(0, 256, (3, 2 * n, 2 * n)).astype(np.float32)
        return (jtex.prepare_color_planes(jnp.asarray(c)),
                ttex.prepare_color_planes(torch.from_numpy(c)))
    s = 2 if form == "half-float" else 1
    c = (_smooth_planes(n, s) + rng.random((3, s * n, s * n))).astype(
        np.float32)
    return jnp.asarray(c), torch.from_numpy(c)


def _same_level(tl, jl):
    if isinstance(tl, ttex.ColorPlanes2x):
        tl, jl = tl.full_packed, jl.full_packed
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("form", ["planes2x", "half-float", "cell-float"])
@pytest.mark.parametrize("n", [96, 97])
def test_build_color_pyramid_bitwise(form, n):
    jc, tc = _color_inputs(form, n)
    jp = jlod.build_color_pyramid(jc, 4, n)
    tp = tlod.build_color_pyramid(tc, 4, n)
    assert len(tp) == 4
    for lvl, (a, b) in enumerate(zip(jp, tp)):
        _same_level(b, a)
        if lvl:
            assert b.dtype == torch.int32
            assert b.shape == (-(-n // 2 ** lvl),) * 2
    # level 0 stays the input at half-cell resolution
    assert (tp[0] is tc) == (form != "cell-float")


def test_color_pyramid_rejects_packed_2d():
    """The JAX package reads a packed plane's rows as colour channels and
    returns a corrupt level 0 (lod.py:98); the port raises."""
    n = 32
    c = np.random.default_rng(2).integers(0, 256, (3, n, n)).astype(
        np.float32)
    jbad = jlod.build_color_pyramid(jtex.pack_cell_colors(jnp.asarray(c)),
                                    1, n)
    assert jbad[0].shape != (n, n)                  # silently wrong
    with pytest.raises(ValueError, match="packed 2D"):
        tlod.build_color_pyramid(ttex.pack_cell_colors(torch.from_numpy(c)),
                                 3, n)


@pytest.mark.parametrize("vi,vj", [(384.3, 383.6), (3.7, 700.2),
                                   (766.5, 0.25)])
def test_crop_level_bitwise(vi, vj):
    """Centred, edge-clamped and corner viewers; every colour form."""
    dem = make_dem(N_LOD)
    spec = _plan()[0]
    jp = jax_params(vi, vj, 900.0, zfar=ZFAR_LOD)
    tp = params_from_jax(jp, "cpu")
    forms = {"none": (None, None)}
    for form in ("planes2x", "cell-float"):
        forms[form] = _color_inputs(form, N_LOD)
    jc, tc = forms["cell-float"]
    forms["packed"] = (jtex.pack_cell_colors(jc), ttex.pack_cell_colors(tc))
    for jcol, tcol in forms.values():
        jd, jpc, jcc = jlod._crop_level(jnp.asarray(dem), jp, jcol, spec,
                                        CPD, 34.0)
        td, tpc, tcc, origin = tlod._crop_level(torch.from_numpy(dem), tp,
                                                tcol, spec, CPD, 34.0)
        c = tlod.level_crop_size(spec, CPD, 34.0)
        assert td.shape == (c, c) and c < N_LOD and origin is not None
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        for f in ("viewer_cell_i", "viewer_cell_j"):
            assert getattr(tpc, f).numpy() == np.asarray(getattr(jpc, f))
        if tcol is not None:
            _same_level(tcc, jcc)


# -- the march ----------------------------------------------------------------

def _color_pyramids(form, n, levels):
    jc, tc = _color_inputs(form, n)
    return (jlod.build_color_pyramid(jc, levels, n),
            tlod.build_color_pyramid(tc, levels, n))


def _near_colors_close(tx, jx, valid):
    if valid.any():
        assert (tx[valid] == jx[valid]).mean() >= 0.99
        for sh in (0, 8, 16):
            d = ((tx[valid] >> sh) & 0xff) - ((jx[valid] >> sh) & 0xff)
            assert np.abs(d).max() <= 1


MARCH_CASES = [  # (colours, vi, vj)
    (None, 384.3, 383.6), (None, 40.2, 700.6), ("planes2x", 384.3, 383.6),
    ("half-float", 40.2, 700.6), ("cell-float", 384.3, 383.6)]


@pytest.mark.parametrize("colors,vi,vj", MARCH_CASES)
def test_march_lod_matches_jax(jax_geometry, colors, vi, vj):
    dem = make_dem(N_LOD, rough=4.0)
    plan = _plan()
    assert len(plan) >= 3
    assert tlod.level_crop_size(plan[0], CPD, 34.0) < N_LOD     # crops
    nlev = 1 + max(s.level for s in plan)
    jpyr = jlod.build_pyramid(jnp.asarray(dem), nlev)
    tpyr = tlod.build_pyramid(torch.from_numpy(dem), nlev)
    jcp = tcp = None
    if colors:
        jcp, tcp = _color_pyramids(colors, N_LOD, nlev)
    jp = jax_params(vi, vj, viewer_z(dem, vi, vj, above=5.0), zfar=ZFAR_LOD)
    kw = dict(width=W_LOD, plan=plan, cells_per_deg=CPD, lat_hint_deg=34.0)
    jout = jlod.march_lod(jpyr, jp, color_pyramid=jcp, **kw)
    tout = tlod.march_lod(tpyr, params_from_jax(jp, "cpu"),
                          color_pyramid=tcp, **kw)
    jt, jd = np.asarray(jout[0]), jout[2]
    tt, td = tout[0].numpy(), tout[1]
    q = N_NEAR
    assert tt.shape == jt.shape == (W_LOD, q + sum(s.k_len for s in plan))
    np.testing.assert_array_equal(tt[:, q:], jt[:, q:])
    _near_band_close(tt[:, :q], jt[:, :q], min_bitwise=0.95)
    assert (tt[:, q:] > NEG).mean() > 0.2
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[3]))
    for f in ("e", "scale", "near_hi"):
        np.testing.assert_array_equal(getattr(td, f).numpy(),
                                      np.asarray(getattr(jd, f)))
    assert (td.k_lo, td.seg_len, td.n_near) == (jd.k_lo, jd.seg_len,
                                                 jd.n_near)
    idx = np.broadcast_to(np.arange(tt.shape[1]), tt.shape)
    np.testing.assert_array_equal(
        td.d_of(torch.from_numpy(idx.copy())).numpy(),
        np.asarray(jd.d_of(jnp.asarray(idx))))
    assert [int(td.dropped), int(td.truncated)] == \
        [int(jd.dropped), int(jd.truncated)] == [0, 0]
    if colors:
        jx, tx = np.asarray(jout[4]), tout[3].numpy()
        np.testing.assert_array_equal(tx[:, q:], jx[:, q:])
        assert (tx[:, q:][tt[:, q:] <= NEG] == 0).all()
        _near_colors_close(tx[:, :q], jx[:, :q], jt[:, :q] > NEG)


def test_lod_dists_d_of_bitwise():
    rng = np.random.default_rng(8)
    w, seg = 64, (37, 12, 90)
    e = rng.random((3, w)).astype(np.float32)
    scale = (90.0 + 400.0 * rng.random((3, w))).astype(np.float32)
    near_hi = (100.0 + 50.0 * rng.random(w)).astype(np.float32)
    kw = dict(n_near=N_NEAR, k_lo=(0, 5, 7), seg_len=seg)
    jd = jlod.LodDists(e=jnp.asarray(e), scale=jnp.asarray(scale),
                       znear=jnp.float32(100.0), near_hi=jnp.asarray(near_hi),
                       **kw)
    td = tlod.LodDists(e=torch.from_numpy(e), scale=torch.from_numpy(scale),
                       znear=torch.tensor(np.float32(100.0)),
                       near_hi=torch.from_numpy(near_hi), **kw)
    idx = rng.integers(0, N_NEAR + sum(seg), (w, 200))
    np.testing.assert_array_equal(td.d_of(torch.from_numpy(idx)).numpy(),
                                  np.asarray(jd.d_of(jnp.asarray(idx))))


def test_crop_beyond_lat_hint_is_counted(jax_geometry):
    """A plan and crop sized for the equator, a viewer at 70 deg: the crop
    masks far samples in both packages, identically, and dropped stays 0
    (lod.py:193). Those samples also lie past the levels' step budgets,
    which every crop exceeds, so truncated counts their columns in both,
    and the API warns (naming lat_hint_deg under the LOD sampler)."""
    dem = make_dem(N_LOD, rough=4.0)
    plan = _plan(lat=0.0)
    nlev = 1 + max(s.level for s in plan)
    jpyr = jlod.build_pyramid(jnp.asarray(dem), nlev)
    tpyr = tlod.build_pyramid(torch.from_numpy(dem), nlev)
    jp = jax_params(384.3, 383.6, viewer_z(dem, 384.3, 383.6, above=5.0),
                    zfar=ZFAR_LOD, lat=70.0)
    counts = {}
    for hint in (0.0, 70.0):
        kw = dict(width=W_LOD, plan=plan if hint == 0.0 else _plan(70.0),
                  cells_per_deg=CPD, lat_hint_deg=hint)
        jout = jlod.march_lod(jpyr, jp, **kw)
        tout = tlod.march_lod(tpyr, params_from_jax(jp, "cpu"), **kw)
        np.testing.assert_array_equal(tout[0].numpy()[:, N_NEAR:],
                                      np.asarray(jout[0])[:, N_NEAR:])
        jd, td = jout[2], tout[1]
        assert int(jd.dropped) == int(td.dropped) == 0
        assert int(td.truncated) == int(jd.truncated)
        counts[hint] = int(td.truncated)
    assert counts[0.0] > 0 and counts[70.0] == 0
    h = object.__new__(THorizonator)
    h.strict_coverage = False
    with pytest.warns(RuntimeWarning, match=r"LOD bands.*lat_hint_deg"):
        h._check_dropped(torch.tensor([0, counts[0.0]]), sampler="lod")


# -- renders ------------------------------------------------------------------

@pytest.mark.parametrize("textured,prebuilt", [(False, False), (False, True),
                                               (True, False), (True, True)])
def test_render_lod_matches_jax(textured, prebuilt):
    dem = make_dem(N_LOD, rough=4.0)
    plan = _plan()
    nlev = 1 + max(s.level for s in plan)
    vi, vj = 384.3, 383.6
    jp = jax_params(vi, vj, viewer_z(dem, vi, vj, above=5.0), zfar=ZFAR_LOD)
    kw = dict(width=256, height=96, nsteps=1, cells_per_deg=CPD,
              sampler="lod", lod_plan=plan, lat_hint_deg=34.0)
    jdem, tdem = jnp.asarray(dem), torch.from_numpy(dem)
    jcp = tcp = None
    if textured:
        # a JAX ColorPlanes2x passed as planes reads as a pyramid tuple
        # (raymarch.py:864): float half-cell planes there, the packed form
        # once prebuilt
        jcp, tcp = _color_inputs("planes2x" if prebuilt else "half-float",
                                 N_LOD)
        kw["textured"] = True
    if prebuilt:
        jdem, tdem = (jlod.build_pyramid(jdem, nlev),
                      tlod.build_pyramid(tdem, nlev))
        if textured:
            jcp = jlod.build_color_pyramid(jcp, nlev, N_LOD)
            tcp = tlod.build_color_pyramid(tcp, nlev, N_LOD)
    img_j, rng_j = j_render(jdem, jp, color_planes=jcp, **kw)
    img_t, rng_t, guard = render_panorama(tdem, params_from_jax(jp, "cpu"),
                                          color_planes=tcp, with_dropped=True,
                                          **kw)
    assert guard.tolist() == [0, 0]
    (_compare_textured if textured else _compare)(
        np.asarray(img_j), np.asarray(rng_j), img_t.numpy(), rng_t.numpy())
    assert float(rng_t.max()) > 8000.0       # the coarse bands are seen
    if textured and prebuilt:     # the port takes its ColorPlanes2x as one
        out = render_panorama(torch.from_numpy(dem),
                              params_from_jax(jp, "cpu"),
                              color_planes=_color_inputs("planes2x",
                                                         N_LOD)[1], **kw)
        assert torch.equal(out[0], img_t) and torch.equal(out[1], rng_t)


def test_single_level_plan_matches_window():
    dem = torch.from_numpy(make_dem(256, rough=6.0))
    vz = viewer_z(dem.numpy(), 128.3, 127.6)
    tp = params_from_jax(jax_params(128.3, 127.6, vz, zfar=12000.0), "cpu")
    k = k_cross_for(12000.0, CPD, 34.0, n=256)
    kw = dict(width=360, height=180, nsteps=k, cells_per_deg=CPD,
              lat_hint_deg=34.0)
    img_l, rng_l = render_panorama(
        (dem,), tp, sampler="lod",
        lod_plan=(tlod.LevelSpec(0, 0.0, 12000.0, 0, k),), **kw)
    img_w, rng_w = render_panorama(dem, tp, sampler="window", **kw)
    assert torch.equal(img_l, img_w) and torch.equal(rng_l, rng_w)


# -- the API ------------------------------------------------------------------

LOD_VIEW = dict(lat=34.55, lon=-117.45, radius=45000.0)   # test_api_lod's


def _peak_srtm1(lat, lon):
    """test_api_lod's tile: a 2500 m Gaussian peak ~36 km NE of LOD_VIEW."""
    ga = np.exp(-(lat - 34.8) ** 2 / (2 * 0.02 ** 2))
    go = np.exp(-(lon + 117.2) ** 2 / (2 * 0.02 ** 2))
    return np.round(200 + 2500 * ga * go).astype(np.int16)


@pytest.fixture(scope="module")
def srtm1_dir(tmp_path_factory):
    return make_synthetic_dem_dir(tmp_path_factory.mktemp("lod_dems"),
                                  {(34, -118): _peak_srtm1}, srtm1=True)


@pytest.mark.parametrize("hillshade", [False, True])
def test_api_long_range_swaps_to_lod(srtm1_dir, hillshade):
    la, lo, zf = LOD_VIEW["lat"], LOD_VIEW["lon"], LOD_VIEW["radius"]
    kw = dict(SRTM1=True, dir_dems=srtm1_dir, render_radius_m=zf,
              hillshade=hillshade)
    hj = JHorizonator(la, lo, 128, 64, **kw)
    ht = THorizonator(la, lo, 128, 64, device="cpu", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        img_t, rng_t = ht.render(10, 80, zfar=zf)
    img_j, rng_j = hj.render(10, 80, zfar=zf)
    assert ht._pyramid is not None and hj._pyramid is not None
    assert len(ht._pyramid) == len(hj._pyramid) >= 2
    for a, b in zip(hj._pyramid, ht._pyramid):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    _, sampler, _, plan, cp = ht._batch_render_plan(100.0, zf)
    assert sampler == "lod" and plan == hj._batch_render_plan(100.0, zf)[3]
    assert (cp is not None) == hillshade
    assert rng_t.max() > 30000.0             # the peak through coarse bands
    if hillshade:
        _compare_textured(img_j, rng_j, img_t, rng_t)
        vis = rng_t > 0
        assert np.array_equal(img_t[vis][:, 0], img_t[vis][:, 1])   # gray
    else:
        _compare(img_j, rng_j, img_t, rng_t)


def test_api_short_range_stays_on_window(srtm1_dir):
    h = THorizonator(34.05, -117.95, 64, 32, SRTM1=True, dir_dems=srtm1_dir,
                     render_radius_m=20000.0, device="cpu")
    _, rng = h.render(0, 90, zfar=20000.0)
    assert h._pyramid is None and (rng > 0).any()


def test_api_lod_drops_hybrid_near_field_loudly(
        dem_dir, tmp_path):  # noqa: F811
    """A textured long clip swaps to LOD, which has no hybrid near field.
    Both packages render the same image; the JAX package says nothing
    (api.py:570), the port warns once per instance."""
    _write_tiles(tmp_path, VIEW["lat"], VIEW["lon"], 128)
    kw = dict(dir_dems=dem_dir, render_radius_cells=128, nsteps=2048,
              render_texture=True, dir_tiles=str(tmp_path),
              allow_downloads=False)
    hj = JHorizonator(VIEW["lat"], VIEW["lon"], 256, 96, **kw)
    ht = THorizonator(VIEW["lat"], VIEW["lon"], 256, 96, device="cpu", **kw)
    with pytest.warns(RuntimeWarning, match="hybrid near field"):
        img_t, rng_t = ht.render(-180, 180, zfar=15000.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ht.render(-180, 180, zfar=15000.0)          # once per instance
        img_j, rng_j = hj.render(-180, 180, zfar=15000.0)
    assert ht._pyramid is not None and hj._pyramid is not None
    _compare_textured(img_j, rng_j, img_t, rng_t)
