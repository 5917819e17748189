"""Port parity for the grid-crossing sampler: render.crossing's
CrossingScene, pack_scene, march_crossing (with its j_hi and j_offset),
horizon_crossing and render_panorama(sampler="crossing"), against
horizonator_tpu on the same seeded inputs (JAX on the CPU, jitted).

Tolerances, and why:
- pack_scene: bitwise;
- the crossings, fed the JAX geometry: bitwise. The port repeats XLA's
  float32 operations in order, including the multiply-adds it contracts
  (the cross position a + m*t, the lerp and the curvature term; measured:
  without them 3% of samples differ, with them none);
- the near band, fed the JAX geometry: its positions take sin and cos of
  az, which differ from XLA's by an ulp now and then: the same valid
  samples, tangents within 1e-5 (test_torch_window's near-band
  tolerance), and >= 95% of the samples bitwise;
- the port's own march (its own geometry, test_torch_geometry's ulps):
  the same valid samples at >= 99.9%, tangents within 1e-5 where both are
  valid, horizons within 1e-5;
- renders: test_torch_render's ``_compare``;
- a batch against its single marches: bitwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizonator_tpu.render import crossing as jcross
from horizonator_tpu.render import raymarch as jray
from horizonator_tpu_torch.parallel import stack_params
from horizonator_tpu_torch.render import crossing as tcross
from horizonator_tpu_torch.render import params_from_jax, raymarch as tray
from tests.test_torch_geometry import (CPD, geo_to_torch, jax_params,
                                       make_dem, viewer_z)
from tests.test_torch_render import _compare

NEAR = tcross.N_NEAR
# (grid rows, columns, viewer i, j, above, azimuth window, zfar, curvature)
CASES = [(160, 160, 80.3, 79.6, 2.0, -180.0, 180.0, 9000.0, 0.0),
         (160, 160, 10.0, 150.0, 30.0, 20.0, 95.0, 9000.0, 6.8e-8),
         (120, 200, 150.2, 60.7, 5.0, -180.0, 180.0, 8000.0, 0.0),
         (200, 96, 40.5, 20.0, 10.0, -40.0, 60.0, 12000.0, 6.8e-8)]


def _case(c):
    nj, ni, vi, vj, above, az0, az1, zfar, curv = c
    dem = make_dem(max(nj, ni))[:nj, :ni].copy()
    return dem, jax_params(vi, vj, viewer_z(dem, vi, vj, above), az0=az0,
                           az1=az1, zfar=zfar, curv=curv)


@functools.partial(jax.jit, static_argnames=("width", "k", "j_hi",
                                             "j_offset"))
def _jax_march(scene, p, width, k, j_hi=None, j_offset=None):
    tanel, run_max, dists, az = jcross.march_crossing(
        scene, p, width=width, k_cross=k, cells_per_deg=CPD, j_hi=j_hi,
        j_offset=j_offset)
    geo = jcross.crossing_geometry(p, width=width, cells_per_deg=CPD)
    return tanel, run_max, dists.near_hi, az, geo


def check_fed(jt, tt):
    """Crossings bitwise, the near band within its tolerance."""
    jt, tt = np.asarray(jt), np.asarray(tt)
    np.testing.assert_array_equal(tt[:, NEAR:], jt[:, NEAR:])
    jn, tn = jt[:, :NEAR], tt[:, :NEAR]
    valid = jn > -1e30
    np.testing.assert_array_equal(tn > -1e30, valid)
    np.testing.assert_allclose(tn[valid], jn[valid], atol=1e-5, rtol=0)
    assert (tn == jn).mean() >= 0.95


def check_own(jt, tt):
    jt, tt = np.asarray(jt), np.asarray(tt)
    jv, tv = jt > -1e30, tt > -1e30
    assert (jv == tv).mean() >= 0.999
    both = jv & tv
    np.testing.assert_allclose(tt[both], jt[both], atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(160, 160), (120, 200), (1, 7)])
def test_pack_scene_bitwise(shape):
    rng = np.random.default_rng(11)
    dem = rng.uniform(-400.0, 9000.0, shape).astype(np.float32)
    dem.flat[0], dem.flat[-1] = 20000.0, -20000.0     # clipped to int16
    js = jcross.pack_scene(jnp.asarray(dem))
    ts = tcross.pack_scene(torch.from_numpy(dem))
    assert ts.hv.dtype == torch.int32 and ts.hv.shape == (2,) + shape
    np.testing.assert_array_equal(ts.hv.numpy(), np.asarray(js.hv))
    assert (ts.nj, ts.ni, ts.n) == (js.nj, js.ni, js.n)
    back = tcross.crossing_scene_from_jax(js, "cpu")
    assert torch.equal(back.hv, ts.hv)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_march_crossing_matches_jax(case):
    dem, jp = _case(CASES[case])
    js = jcross.pack_scene(jnp.asarray(dem))
    ts = tcross.pack_scene(torch.from_numpy(dem))
    tp = params_from_jax(jp, "cpu")
    k = 192
    jt, jrm, jnh, jaz, jgeo = _jax_march(js, jp, 96, k)
    tt, dists = tcross.march_crossing_from_geometry(ts, tp,
                                                    geo_to_torch(jgeo),
                                                    k_cross=k)
    assert tt.shape == (96, NEAR + k)
    check_fed(jt, tt)
    assert (np.asarray(jt)[:, NEAR:] > -1e30).mean() > 0.1
    np.testing.assert_array_equal(dists.near_hi.numpy(), np.asarray(jnh))
    ot, orm, odists, oaz = tcross.march_crossing(ts, tp, width=96,
                                                 k_cross=k,
                                                 cells_per_deg=CPD)
    check_own(jt, ot)
    assert torch.equal(orm, torch.cummax(ot, dim=1).values)
    assert odists.dropped is None and odists.truncated is None
    jh = np.asarray(jcross.horizon_crossing(js, jp, width=96, k_cross=k,
                                            cells_per_deg=CPD)[1])
    taz, th = tcross.horizon_crossing(ts, tp, width=96, k_cross=k,
                                      cells_per_deg=CPD)
    assert torch.equal(taz, oaz) and torch.equal(th, ot.amax(dim=1))
    check_own(jh[:, None], th[:, None])


@pytest.mark.parametrize("band", ["j_hi", "j_offset", "both"])
def test_march_crossing_band_args_match_jax(band):
    """A row band of the grid marched with the global geometry: j_offset
    shifts rows where they index and mask, j_hi caps the valid rows (the
    last band's fabricated halo row). Fed the JAX geometry, bitwise as
    above; and each crossing valid in both the band and the global march
    is bitwise the global march's (the offset is exact)."""
    dem, jp = _case(CASES[0])
    off = 0 if band == "j_hi" else 50
    rows = slice(off, off + 70)
    j_hi = 60 if band != "j_offset" else None
    band_dem = dem[rows]
    js = jcross.pack_scene(jnp.asarray(band_dem))
    ts = tcross.pack_scene(torch.from_numpy(band_dem))
    tp = params_from_jax(jp, "cpu")
    kw = dict(j_hi=j_hi, j_offset=off if band != "j_hi" else None)
    jt, _, _, _, jgeo = _jax_march(js, jp, 96, 192, **kw)
    tt, _ = tcross.march_crossing_from_geometry(ts, tp, geo_to_torch(jgeo),
                                                k_cross=192, **kw)
    check_fed(jt, tt)
    full, _ = tcross.march_crossing_from_geometry(
        tcross.pack_scene(torch.from_numpy(dem)), tp, geo_to_torch(jgeo),
        k_cross=192)
    both = (tt > -1e30) & (full > -1e30)
    both[:, :NEAR] = False
    assert both.sum() > 100
    assert torch.equal(tt[both], full[both])


def test_march_crossing_batch_equals_singles():
    dem, _ = _case(CASES[0])
    ts = tcross.pack_scene(torch.from_numpy(dem))
    tps = [params_from_jax(_case(c)[1], "cpu") for c in CASES[:2]]
    bt, brm, bd, baz = tcross.march_crossing(ts, stack_params(tps),
                                             width=64, k_cross=128,
                                             cells_per_deg=CPD)
    assert bt.shape == (2, 64, NEAR + 128)
    for b, p in enumerate(tps):
        t1, rm1, d1, az1 = tcross.march_crossing(ts, p, width=64,
                                                 k_cross=128,
                                                 cells_per_deg=CPD)
        assert torch.equal(bt[b], t1) and torch.equal(baz[b], az1)
        idx = torch.arange(NEAR + 128).expand(64, -1)
        assert torch.equal(bd.d_of(idx.expand(2, 64, -1))[b], d1.d_of(idx))


@pytest.mark.parametrize("scene_form", ["grid", "scene"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_render_crossing_matches_jax(case, scene_form):
    dem, jp = _case(CASES[case])
    kw = dict(width=160, height=80, nsteps=192, cells_per_deg=CPD,
              sampler="crossing")
    img_j, rng_j = jray.render_panorama(jnp.asarray(dem), jp, **kw)
    tdem = torch.from_numpy(dem)
    scene = tdem if scene_form == "grid" else tcross.pack_scene(tdem)
    img_t, rng_t, guard = tray.render_panorama(
        scene, params_from_jax(jp, "cpu"), with_dropped=True, **kw)
    _compare(np.asarray(img_j), np.asarray(rng_j), img_t.numpy(),
             rng_t.numpy())
    assert guard.tolist() == [0, 0]


def _march_both(dem, jp, width, k):
    js = jcross.pack_scene(jnp.asarray(dem))
    jt, jrm, _, _, _ = _jax_march(js, jp, width, k)
    tt, trm, _, _ = tcross.march_crossing(
        tcross.pack_scene(torch.from_numpy(dem)), params_from_jax(jp, "cpu"),
        width=width, k_cross=k, cells_per_deg=CPD)
    return (np.asarray(jt), np.asarray(jrm)), (tt.numpy(), trm.numpy())


def test_ocean_everywhere_is_all_sky_above_horizon():
    """tests/test_crossing.py:122's all-zero grid, on the port: the top
    rows sky, flat ground below the horizon, ranges as the JAX render's."""
    dem = np.zeros((128, 128), np.float32)
    jp = jax_params(64.0, 64.0, 10.0, zfar=8000.0)
    k = tcross.k_cross_for(8000.0, CPD, 34.0, n=128)
    kw = dict(width=256, height=128, nsteps=k, cells_per_deg=CPD,
              sampler="crossing")
    img, rng = tray.render_panorama(torch.from_numpy(dem),
                                    params_from_jax(jp, "cpu"), **kw)
    rng = rng.numpy()
    assert np.all(rng[:60] < 0)
    assert np.mean(rng[70:] > 0) > 0.9
    _, rng_j = jray.render_panorama(jnp.asarray(dem), jp, **kw)
    rng_j = np.asarray(rng_j)
    np.testing.assert_array_equal(rng > 0, rng_j > 0)
    both = rng > 0
    np.testing.assert_allclose(rng[both], rng_j[both], rtol=1e-4)


def test_axis_aligned_azimuths():
    """tests/test_crossing.py:138: exact N/E/S/W rays stay finite; the
    march matches the JAX one's."""
    dem = make_dem(128, rough=0.0)
    jp = jax_params(64.0, 64.0, float(dem[64, 64]) + 20.0, zfar=6000.0)
    k = tcross.k_cross_for(6000.0, CPD, 34.0, n=128)
    (jt, jrm), (tt, trm) = _march_both(dem, jp, 8, k)
    assert np.all(np.isfinite(trm[:, -1]))
    check_own(jt, tt)


def test_far_edge_crossing_interpolates_edge_column():
    """tests/test_crossing.py:155: a crossing exactly on the far grid edge
    samples the edge column (the fraction from the clipped base), so the
    1900 m cliff along it dominates the horizon; fed the JAX geometry, the
    crossings bitwise the JAX march's."""
    n = 256
    dem = np.full((n, n), 100.0, np.float32)
    dem[:, n - 1] = 2000.0
    jp = jax_params(float(n - 1), 40.0, 130.0, az0=-1.0, az1=1.0,
                    zfar=8000.0)
    k = tcross.k_cross_for(8000.0, CPD, 34.0, n=n)
    (jt, jrm), (tt, trm) = _march_both(dem, jp, 16, k)
    assert trm[:, -1].max() > 0.2 and jrm[:, -1].max() > 0.2
    jt, _, _, _, jgeo = _jax_march(jcross.pack_scene(jnp.asarray(dem)), jp,
                                   16, k)
    tt, _ = tcross.march_crossing_from_geometry(
        tcross.pack_scene(torch.from_numpy(dem)), params_from_jax(jp, "cpu"),
        geo_to_torch(jgeo), k_cross=k)
    check_fed(jt, tt)
