"""Port parity: geometry, crossing geometry and distances vs the JAX package.

The same float32 inputs, made with numpy from a seed, go through
horizonator_tpu (JAX, CPU, jitted as the package runs it) and
horizonator_tpu_torch (CPU). Tolerances, in ulps of a field's largest
magnitude: XLA rewrites a division by a constant into a reciprocal
product (the port mirrors that) but also folds and fuses the column
azimuth's arithmetic depending on the width, which moves az by up to
1 ulp; torch.sin/cos differ from XLA's by up to 1 ulp (~5% of arguments);
and the per-step scale and slope divide by a cosine or sine that can be
small, which magnifies both. Measured maxima over these views: az 1, a 1,
scale 8, t 21 ulps. Integer and boolean fields and everything computed
without transcendental functions must be bitwise equal.

Also holds the shared helpers of the test_torch_* files.
"""

import functools
import math

import jax
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from horizonator_tpu import geometry as jgeom
from horizonator_tpu.render import RenderParams as JParams
from horizonator_tpu.render import crossing as jcross
from horizonator_tpu_torch import geometry as tgeom
from horizonator_tpu_torch.render import crossing as tcross
from horizonator_tpu_torch.render import params_from_jax

CPD = 1200


def make_dem(n=256, seed=3, rough=25.0):
    """The JAX tests' synthetic terrain (tests/test_crossing.py), numpy."""
    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32), indexing="ij")
    z = (500.0 + 300.0 * np.sin(ii / 31.0) * np.cos(jj / 23.0)
         + rough * rng.standard_normal((n, n), dtype=np.float32))
    return np.maximum(z, 0.0).astype(np.float32)


def jax_params(vi, vj, vz, az0=-180.0, az1=180.0, zfar=15000.0, znear=100.0,
               lat=34.0, curv=0.0):
    f = jnp.float32
    return JParams(
        viewer_cell_i=f(vi), viewer_cell_j=f(vj), viewer_z=f(vz),
        cos_viewer_lat=f(math.cos(math.radians(lat))),
        az_rad0=f(math.radians(az0)), az_rad1=f(math.radians(az1)),
        znear=f(znear), zfar=f(zfar), znear_color=f(znear),
        zfar_color=f(zfar), curv=f(curv))


def viewer_z(dem, vi, vj, above=2.0):
    return float(dem[int(vj):int(vj) + 2, int(vi):int(vi) + 2].max()) + above


def geo_to_torch(geo):
    """A JAX CrossingGeom as the port's (numpy in between)."""
    return tcross.CrossingGeom(*[
        torch.from_numpy(np.array(np.asarray(x)))
        if np.ndim(x) else torch.tensor(np.float32(x)) for x in geo])


def ulps(a, b):
    """max |a - b| in float32 ulps of the largest magnitude in ``a``."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if a.size == 0:
        return 0.0
    scale = np.spacing(np.float32(np.abs(a).max()))
    return float((np.abs(a.astype(np.float64) - b) / scale).max())


@functools.partial(jax.jit, static_argnames=("width",))
def _jax_geometry(p, width):
    return jcross.crossing_geometry(p, width=width, cells_per_deg=CPD)


_jax_az_window = jax.jit(jgeom.az_window_rad)
_jax_x_from_az = jax.jit(jgeom.x_from_az, static_argnames=("width",))


VIEWS = [(128.3, 127.6, -180.0, 180.0), (6.2, 250.0, -40.0, 75.0),
         (128.0, 128.0, 170.0, -170.0), (60.5, 9.25, 30.0, 30.0)]


@pytest.mark.parametrize("width", [384, 100])
@pytest.mark.parametrize("vi,vj,az0,az1", VIEWS)
def test_crossing_geometry_within_ulps(vi, vj, az0, az1, width):
    jp = jax_params(vi, vj, 800.0, az0=az0, az1=az1)
    jg = _jax_geometry(jp, width)
    tg = tcross.crossing_geometry(params_from_jax(jp, "cpu"), width=width,
                                  cells_per_deg=CPD)
    for name in ("j_dom", "axis0", "sign"):
        np.testing.assert_array_equal(np.asarray(getattr(jg, name)),
                                      getattr(tg, name).numpy(), err_msg=name)
    for name, tol in (("az", 1), ("e", 0), ("scale", 8), ("a", 1),
                      ("t", 32), ("cell_m_north", 0), ("cell_m_east", 0)):
        u = ulps(np.asarray(getattr(jg, name)), getattr(tg, name).numpy())
        assert u <= tol, (name, u)


@pytest.mark.parametrize("az0,az1", [(0.0, 0.0), (-180.0, 180.0),
                                     (170.0, -170.0), (33.3, 33.3),
                                     (-10.0, 350.0)])
def test_az_window_bitwise(az0, az1):
    a0, a1 = np.float32(math.radians(az0)), np.float32(math.radians(az1))
    ref = _jax_az_window(jnp.float32(a0), jnp.float32(a1))
    got = tgeom.az_window_rad(torch.tensor(a0), torch.tensor(a1))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())
    if az0 == az1:      # the full circle, not an empty window
        assert float(got[0]) > float(a0) + 6.28


def test_x_from_az_within_2_ulp():
    """XLA folds /2*width into one constant and fuses the multiply-adds of
    the unwrap and of x: 2 ulps."""
    az = np.random.default_rng(4).uniform(-7, 7, 200).astype(np.float32)
    a0, a1 = np.float32(math.radians(-45.0)), np.float32(math.radians(80.0))
    ref = _jax_x_from_az(jnp.asarray(az), jnp.float32(a0), jnp.float32(a1),
                         width=640)
    got = tgeom.x_from_az(torch.from_numpy(az), torch.tensor(a0),
                          torch.tensor(a1), 640)
    for r, g in zip(ref, got):
        assert ulps(np.asarray(r), g.numpy()) <= 2


@pytest.mark.parametrize("zfar,lat,n", [(40000.0, 34.3, 3400),
                                        (15000.0, 34.0, 256),
                                        (40000.0, 61.0, None),
                                        (9000.0, -12.5, 100)])
def test_k_cross_for_equal(zfar, lat, n):
    assert (tcross.k_cross_for(zfar, CPD, lat, n=n)
            == jcross.k_cross_for(zfar, CPD, lat, n=n))


def test_curvature_coeff_equal():
    for mode in (None, "none", "spherical", "refracted", 1e-7):
        assert tgeom.curvature_coeff(mode) == jgeom.curvature_coeff(mode)
    with pytest.raises(ValueError):
        tgeom.curvature_coeff("bogus")


def test_d_of_matches():
    """d_of on the same dists fields and indices: crossing lanes bitwise;
    near-band lanes to 1 ulp (XLA may fuse znear + idx*step into an FMA)."""
    rng = np.random.default_rng(7)
    w, q = 64, tcross.N_NEAR
    e = rng.uniform(0.01, 1.0, w).astype(np.float32)
    scale = rng.uniform(76.0, 131.0, w).astype(np.float32)
    near_hi = rng.uniform(100.0, 230.0, w).astype(np.float32)
    znear = np.float32(100.0)
    idx = rng.integers(0, 600, (w, 40)).astype(np.int32)
    idx[:, :8] = np.arange(8)
    jd = jcross.CrossingDists(e=jnp.asarray(e), scale=jnp.asarray(scale),
                              znear=jnp.float32(znear),
                              near_hi=jnp.asarray(near_hi), n_near=q)
    td = tcross.CrossingDists(e=torch.from_numpy(e),
                              scale=torch.from_numpy(scale),
                              znear=torch.tensor(znear),
                              near_hi=torch.from_numpy(near_hi), n_near=q)
    ref = np.asarray(jax.jit(jd.d_of)(jnp.asarray(idx)))
    got = td.d_of(torch.from_numpy(idx)).numpy()
    far = idx >= q
    np.testing.assert_array_equal(ref[far], got[far])
    assert ulps(ref[~far], got[~far]) <= 1.0
