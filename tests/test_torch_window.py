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
  where both are valid, horizons within 1e-5;
- the edge shapes (the ones chip_smoke.py holds the CUDA kernel to against
  the plain version): far-field samples bitwise, NEG_BIG included, wherever
  the JAX kernel reports no dropped samples; far-field colors bitwise, 0
  at invalid samples included (test_torch_textured's tolerance for them).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizonator_tpu.render import texture as jtex
from horizonator_tpu.render.crossing import crossing_geometry as j_geometry
from horizonator_tpu.render.window import march_window as j_march
from horizonator_tpu_torch.kernels.window_march import fma32
from horizonator_tpu_torch.render import params_from_jax
from horizonator_tpu_torch.render import texture as ttex
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


@functools.partial(jax.jit, static_argnames=("width", "k", "znear_hint_m"))
def _jax_march_tex(dem, p, planes, width, k, znear_hint_m=100.0):
    tanel, _, dists, _, tex = j_march(dem, p, width=width, k_cross=k,
                                      cells_per_deg=CPD, lat_hint_deg=34.0,
                                      znear_hint_m=znear_hint_m,
                                      color_planes=planes)
    return tanel, tex, dists.dropped


EDGE_CASES = [
    # (id, n, vi, vj, az0, az1, width, k, znear, zfar, s, what); s: 0
    # untextured, 1 packed cell planes, 2 half-cell planes; what must hold
    # of the case: "mixed" (row- and column-dominant columns within the
    # first 32), "j_dom" / "i_dom" (all of one kind), "edge" (a valid
    # sample at pos == n-1 exactly), "far" (no valid sample from step 32 on)
    ("W1-K1", 64, 31.4, 30.7, 10.0, 11.0, 1, 1, 10.0, 8000.0, 0, None),
    ("W31-K2", 64, 31.4, 30.7, -180.0, 180.0, 31, 2, 10.0, 8000.0, 2, None),
    ("W33-K31", 64, 31.4, 30.7, -180.0, 180.0, 33, 31, 100.0, 8000.0, 1,
     None),
    ("W37-K33-n100", 100, 48.3, 51.9, -180.0, 180.0, 37, 33, 100.0, 8000.0,
     2, None),
    ("W37-K129-n100", 100, 48.3, 51.9, -180.0, 180.0, 37, 129, 100.0, 8000.0,
     1, None),
    ("W33-K577-n700", 700, 349.6, 350.2, -180.0, 180.0, 33, 577, 100.0,
     60000.0, 0, None),
    ("octant-boundary", 100, 50.2, 49.7, 38.0, 41.0, 37, 64, 100.0, 8000.0,
     2, "mixed"),
    ("row-dominant", 100, 50.2, 49.7, -10.0, 10.0, 64, 65, 100.0, 8000.0, 1,
     "j_dom"),
    ("column-dominant", 100, 50.2, 49.7, 80.0, 100.0, 64, 65, 100.0, 8000.0,
     2, "i_dom"),
    ("across-180", 100, 50.2, 49.7, 170.0, -170.0, 40, 64, 100.0, 8000.0, 2,
     None),
    ("corner", 100, 1.3, 97.8, -180.0, 180.0, 70, 129, 100.0, 20000.0, 2,
     None),
    ("on-grid-line", 64, 32.0, 20.0, -180.0, 180.0, 64, 64, 100.0, 8000.0, 1,
     None),
    ("pos-reaches-n-1", 64, 20.0, 63.0, 80.0, 100.0, 33, 64, 50.0, 8000.0, 0,
     "edge"),
    ("pos-reaches-n-1-cell-planes", 64, 20.0, 63.0, 80.0, 100.0, 33, 64,
     50.0, 8000.0, 1, "edge"),
    ("pos-reaches-n-1-half-cell-planes", 64, 20.0, 63.0, 80.0, 100.0, 33, 64,
     50.0, 8000.0, 2, "edge"),
    ("zfar-within-first-steps", 100, 50.2, 49.7, -180.0, 180.0, 96, 129,
     100.0, 500.0, 2, "far"),
    ("znear-above-first-crossings", 100, 50.2, 49.7, -180.0, 180.0, 33, 129,
     1000.0, 8000.0, 1, None),
]


@pytest.mark.parametrize("n,vi,vj,az0,az1,width,k,znear,zfar,s,what",
                         [c[1:] for c in EDGE_CASES],
                         ids=[c[0] for c in EDGE_CASES])
def test_march_edge_shapes(n, vi, vj, az0, az1, width, k, znear, zfar, s,
                           what):
    """The plain march against the JAX kernel at the shapes and columns on
    which a kernel's thread mapping can go wrong."""
    dem = make_dem(n)
    jp = jax_params(vi, vj, 900.0, az0=az0, az1=az1, zfar=zfar, znear=znear,
                    curv=6.8e-8)
    geo = geo_to_torch(_jax_geometry(jp, width))
    hint = max(znear, 100.0)        # the near patch covers znear: no drops
    kw = dict(k_cross=k, cells_per_deg=CPD, lat_hint_deg=34.0,
              znear_hint_m=hint)
    tp, td = params_from_jax(jp, "cpu"), torch.from_numpy(dem)
    q = twin.N_NEAR
    if s == 0:
        jt, jdrop, _ = _jax_march(jnp.asarray(dem), jp, width, k,
                                  znear_hint_m=hint)
        tt, _ = twin.march_from_geometry(td, tp, geo, **kw)
    else:
        c = np.random.default_rng(n + k).integers(
            0, 256, (3, s * n, s * n)).astype(np.float32)
        jplanes = (jtex.prepare_color_planes(jnp.asarray(c)) if s == 2
                   else jtex.pack_cell_colors(jnp.asarray(c)))
        jt, jx, jdrop = _jax_march_tex(jnp.asarray(dem), jp, jplanes, width,
                                       k, znear_hint_m=hint)
        tt, _, tx = twin.march_from_geometry(
            td, tp, geo,
            color_planes=ttex.scene_from_jax(jplanes, device="cpu")[0], **kw)
        jx, tx = np.asarray(jx)[:, q:], tx.numpy()[:, q:]
        np.testing.assert_array_equal(tx, jx)
        assert (tx[np.asarray(jt)[:, q:] <= NEG] == 0).all()
    assert int(jdrop) == 0
    jt, tt = np.asarray(jt)[:, q:], tt.numpy()[:, q:]
    assert tt.shape == (width, k)
    np.testing.assert_array_equal(tt, jt)
    valid = tt > NEG
    jd = geo.j_dom.numpy()
    if what == "mixed":
        assert jd[:32].any() and not jd[:32].all()
    elif what == "j_dom":
        assert jd.all()
    elif what == "i_dom":
        assert not jd.any()
    elif what == "far":
        assert valid[:, :32].any() and not valid[:, 32:].any()
    elif what == "edge":
        m = torch.arange(k, dtype=torch.float32)[None, :]
        pos = fma32(m, geo.t[:, None], geo.a[:, None]).numpy()
        assert ((pos == n - 1.0) & valid).any()
    else:
        assert valid.any()


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
    # the aligned crossing tables are a TPU layout the port does not copy
    with pytest.raises(NotImplementedError):
        twin.march_window(dem, tp, width=32, k_cross=64, cells_per_deg=CPD,
                          scene=object())
    with pytest.raises(ValueError, match="packed int32"):  # 2D float planes
        twin.march_window(dem, tp, width=32, k_cross=64, cells_per_deg=CPD,
                          color_planes=dem)
    with pytest.raises(ValueError, match="one"):           # a stack of grids
        twin.march_window(dem[None], tp, width=32, k_cross=64,
                          cells_per_deg=CPD)
    # a band spanning the whole square grid is the square march, bitwise
    band = twin.march_window(dem, tp, width=32, k_cross=64,
                             cells_per_deg=CPD, j_hi=63.0, j_offset=0)
    assert torch.equal(band[0], tanel)
    # a rectangular grid: the far field bitwise the JAX march's on the same
    # grid, fed its geometry; its row band with an offset likewise
    jp = jax_params(30.5, 31.5, 900.0, zfar=4000.0)
    geo = geo_to_torch(_jax_geometry(jp, 32))
    for rect, off, j_hi in ((dem[:, :60], 0, None), (dem[20:45], 20, 22.0)):
        jt, _, _, _ = j_march(jnp.asarray(rect.numpy()), jp, width=32,
                              k_cross=64, cells_per_deg=CPD,
                              lat_hint_deg=45.0, j_offset=off, j_hi=j_hi)
        tt, dists = twin.march_from_geometry(rect, tp, geo, k_cross=64,
                                             cells_per_deg=CPD,
                                             j_offset=off, j_hi=j_hi)
        assert tt.shape == jt.shape and (tt > NEG).any()
        np.testing.assert_array_equal(tt[:, twin.N_NEAR:].numpy(),
                                      np.asarray(jt)[:, twin.N_NEAR:])
