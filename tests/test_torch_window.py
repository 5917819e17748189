"""Port parity: the window march vs horizonator_tpu's march_window.

The JAX march runs as its own tests run it on the CPU: jitted, with the
Pallas kernel in interpret mode, ``scene=None`` (the port's lane layout).

Tolerances:
- far field, fed the JAX geometry: bitwise. The port's kernel repeats the
  JAX kernel's float32 operations in order, including the three
  multiply-adds that XLA fuses;
- near band, fed the JAX geometry: tangents within 1e-5 (1 mm of
  elevation at the 100 m znear; measured <= 4e-6), and >= 95% of the
  patch path's samples bitwise (measured 97-99%). The JAX near band
  contracts its patch with an einsum whose accumulation order and FMA
  use are XLA's choice, which moves an elevation by a few of its ulps;
- the port's own full march (its own geometry, whose slopes differ by up
  to 4 ulp): visibility equal at >= 99.9% of samples, tangents within 1e-5
  where both are valid, horizons within 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizonator_tpu.render.crossing import crossing_geometry as j_geometry
from horizonator_tpu.render.window import march_window as j_march
from horizonator_tpu_torch.render import params_from_jax
from horizonator_tpu_torch.render import window as twin
from horizonator_tpu_torch.render.crossing import k_cross_for
from tests.test_torch_geometry import (CPD, geo_to_torch, jax_params,
                                       make_dem, viewer_z)

NEG = -1e30


@functools.partial(jax.jit, static_argnames=("width", "k", "znear_hint_m"))
def _jax_march(dem, p, width, k, znear_hint_m=100.0):
    tanel, _, dists, _ = j_march(dem, p, width=width, k_cross=k,
                                 cells_per_deg=CPD, lat_hint_deg=34.0,
                                 znear_hint_m=znear_hint_m)
    return tanel, dists.dropped, dists.truncated


@functools.partial(jax.jit, static_argnames=("width",))
def _jax_geometry(p, width):
    return j_geometry(p, width=width, cells_per_deg=CPD)


def _both(dem, jp, width, k, znear_hint_m=100.0, own_geometry=False):
    """(jax tanel, dropped, truncated), (port tanel, dropped, truncated)."""
    jt, jd, jtr = _jax_march(jnp.asarray(dem), jp, width, k,
                             znear_hint_m=znear_hint_m)
    tp = params_from_jax(jp, "cpu")
    td = torch.from_numpy(dem)
    if own_geometry:
        tt, _, dists, _ = twin.march_window(
            td, tp, width=width, k_cross=k, cells_per_deg=CPD,
            lat_hint_deg=34.0, znear_hint_m=znear_hint_m)
    else:
        geo = geo_to_torch(_jax_geometry(jp, width))
        tt, dists = twin.march_from_geometry(
            td, tp, geo, k_cross=k, cells_per_deg=CPD, lat_hint_deg=34.0,
            znear_hint_m=znear_hint_m)
    return ((np.asarray(jt), int(jd), int(jtr)),
            (tt.numpy(), int(dists.dropped), int(dists.truncated)))


CASES = [  # (n, vi, vj, az0, az1, zfar, curv, width)
    (256, 128.3, 127.6, -180.0, 180.0, 15000.0, 0.0, 512),
    (256, 6.2, 250.0, -180.0, 180.0, 15000.0, 6.8e-8, 384),
    (256, 128.0, 128.0, 170.0, -170.0, 9000.0, 0.0, 96),
    (100, 50.5, 3.25, -90.0, 90.0, 8000.0, 0.0, 128),   # padded tiny grid
    (300, 251.7, 12.9, 10.0, 150.0, 25000.0, 1.1e-7, 200),
]


@pytest.mark.parametrize("n,vi,vj,az0,az1,zfar,curv,width", CASES)
def test_march_from_jax_geometry(n, vi, vj, az0, az1, zfar, curv, width):
    dem = make_dem(n)
    jp = jax_params(vi, vj, viewer_z(dem, vi, vj), az0=az0, az1=az1,
                    zfar=zfar, curv=curv)
    k = k_cross_for(zfar, CPD, 34.0, n=n)
    (jt, jdrop, jtr), (tt, tdrop, ttr) = _both(dem, jp, width, k)
    assert jdrop == 0 and jtr == 0          # parity holds where JAX drops none
    assert (tdrop, ttr) == (0, 0)
    assert tt.shape == jt.shape
    q = twin.N_NEAR
    np.testing.assert_array_equal(tt[:, q:], jt[:, q:])       # far field
    _near_band_close(tt[:, :q], jt[:, :q], min_bitwise=0.95)


def _near_band_close(tq, jq, min_bitwise=0.0):
    vis = jq > NEG
    assert ((tq > NEG) == vis).all()
    if vis.any():
        assert np.abs(tq[vis] - jq[vis]).max() <= 1e-5
        assert (tq[vis] == jq[vis]).mean() >= min_bitwise


@pytest.mark.parametrize("nsteps,znear,hint", [(64, 100.0, 100.0),
                                               (128, 100.0, 100.0),
                                               (None, 600.0, 100.0),
                                               (None, 6000.0, 6000.0)])
def test_guard_counters_equal(nsteps, znear, hint):
    """truncated (manual undersized nsteps), dropped (znear above the patch
    hint), and the gather near band (a hint past the patch cap)."""
    dem = make_dem(256)
    jp = jax_params(128.3, 127.6, viewer_z(dem, 128.3, 127.6), znear=znear,
                    zfar=15000.0)
    k = nsteps or k_cross_for(15000.0, CPD, 34.0, n=256)
    (jt, jdrop, jtr), (tt, tdrop, ttr) = _both(dem, jp, 256, k,
                                               znear_hint_m=hint)
    assert (tdrop, ttr) == (jdrop, jtr)
    if nsteps is not None:
        assert ttr > 0
    if znear == 600.0:
        assert tdrop > 0
    q = twin.N_NEAR
    np.testing.assert_array_equal(tt[:, q:], jt[:, q:])
    _near_band_close(tt[:, :q], jt[:, :q])


@pytest.mark.parametrize("n,vi,vj,az0,az1,zfar,curv,width", CASES[:3])
def test_full_march_own_geometry(n, vi, vj, az0, az1, zfar, curv, width):
    dem = make_dem(n)
    jp = jax_params(vi, vj, viewer_z(dem, vi, vj), az0=az0, az1=az1,
                    zfar=zfar, curv=curv)
    k = k_cross_for(zfar, CPD, 34.0, n=n)
    (jt, _, _), (tt, _, _) = _both(dem, jp, width, k, own_geometry=True)
    vj_, vt = jt > NEG, tt > NEG
    assert (vj_ == vt).mean() >= 0.999
    both = vj_ & vt
    assert np.abs(tt[both] - jt[both]).max() < 1e-5
    np.testing.assert_allclose(tt.max(axis=1), jt.max(axis=1), atol=1e-5)


def test_far_edge_crossings_not_truncated():
    """The grid cap on the step budget rounds UP: a viewer at the south
    edge of a 200-cell grid sees a ridge in its last rows."""
    n = 200
    dem = np.zeros((n, n), np.float32)
    dem[180:185, :] = 2500.0
    jp = jax_params(100.0, 0.5, 30.0, az0=-20.0, az1=20.0, zfar=20000.0)
    k = k_cross_for(20000.0, CPD, 34.0, n=n)
    (jt, _, jtr), (tt, _, ttr) = _both(dem, jp, 64, k, own_geometry=True)
    assert jtr == ttr == 0
    hj, ht = jt.max(axis=1), tt.max(axis=1)
    assert ((hj > NEG) == (ht > NEG)).all()
    np.testing.assert_allclose(ht, hj, atol=1e-5)
    assert ht.max() > 0.1                   # the ridge is in the horizon


def test_run_max_and_unsupported():
    dem = torch.from_numpy(make_dem(64))
    tp = params_from_jax(jax_params(30.5, 31.5, 900.0, zfar=4000.0), "cpu")
    tanel, run_max, _, az = twin.march_window(dem, tp, width=32, k_cross=64,
                                              cells_per_deg=CPD)
    np.testing.assert_array_equal(
        run_max.numpy(), np.maximum.accumulate(tanel.numpy(), axis=1))
    assert az.shape == (32,)
    for kw in ({"j_hi": 10}, {"j_offset": 1}, {"scene": object()}):
        with pytest.raises(NotImplementedError):
            twin.march_window(dem, tp, width=32, k_cross=64,
                              cells_per_deg=CPD, **kw)
    with pytest.raises(ValueError, match="packed int32"):  # 2D float planes
        twin.march_window(dem, tp, width=32, k_cross=64, cells_per_deg=CPD,
                          color_planes=dem)
    with pytest.raises(NotImplementedError):
        twin.march_window(dem[:, :60], tp, width=32, k_cross=64,
                          cells_per_deg=CPD)
