"""Port parity for the uniform-step sampler: render.raymarch.march_tanel,
horizon_profile, render_panorama(sampler="step") and
parallel.sharding.horizon_batch, against horizonator_tpu on the same
seeded inputs (JAX on the CPU, jitted as its tests run it).

Tolerances, and why:
- the sample distances d and the column azimuths az: bitwise (no
  transcendental function reaches them);
- tangents: bitwise in every column whose sin and cos of az equal XLA's.
  The port repeats XLA's float32 operations in order, including the
  multiply-adds it contracts (the row position, the surface lerps and the
  curvature term, measured: without them 15% of samples differ, with them
  none given XLA's sin and cos). torch.sin/cos differ from XLA's by an ulp
  in some columns, which moves every sample of the column by a few
  millimetres: there, the same valid samples and tangents within 1e-5
  (test_torch_window's tolerance; measured <= 3e-6);
- renders: test_torch_render's ``_compare``;
- a batch against its single marches, and chunked against whole: bitwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizonator_tpu.parallel import sharding as jshard
from horizonator_tpu.parallel import stack_params as j_stack
from horizonator_tpu.render import raymarch as jray
from horizonator_tpu_torch.parallel import sharding
from horizonator_tpu_torch.render import params_from_jax, raymarch as tray
from tests.test_torch_geometry import CPD, jax_params, make_dem, viewer_z
from tests.test_torch_render import _compare

N = 160
# (viewer i, j, metres above ground, azimuth window, zfar, curvature)
VIEWS = [(80.3, 79.6, 2.0, -180.0, 180.0, 9000.0, 0.0),
         (10.2, 150.0, 30.0, 20.0, 95.0, 9000.0, 6.8e-8),
         (120.7, 30.1, 5.0, 170.0, 260.0, 6000.0, 0.0)]


def _params(dem, view):
    vi, vj, above, az0, az1, zfar, curv = view
    return jax_params(vi, vj, viewer_z(dem, vi, vj, above), az0=az0,
                      az1=az1, zfar=zfar, curv=curv)


@functools.partial(jax.jit, static_argnames=("width", "nsteps", "surface"))
def _jax_march(dem, p, width, nsteps, surface):
    return jray.march_tanel(dem, p, width=width, nsteps=nsteps,
                            cells_per_deg=CPD, surface=surface)


def _same_trig(az):
    """Columns whose torch sin and cos of az equal XLA's."""
    ja = jnp.asarray(az.numpy())
    return ((np.asarray(jax.jit(jnp.sin)(ja)) == torch.sin(az).numpy())
            & (np.asarray(jax.jit(jnp.cos)(ja)) == torch.cos(az).numpy()))


def check_tanel(jt, tt, same):
    """Bitwise in the columns of ``same``, else the same valid samples and
    tangents within 1e-5."""
    jt, tt = np.asarray(jt), np.asarray(tt)
    assert same.mean() > 0.5
    np.testing.assert_array_equal(tt[same], jt[same])
    valid = jt > -1e30
    np.testing.assert_array_equal(tt > -1e30, valid)
    np.testing.assert_allclose(tt[valid], jt[valid], atol=1e-5, rtol=0)


@pytest.mark.parametrize("packed", [False, True], ids=["float", "packed"])
@pytest.mark.parametrize("surface", ["bilinear", "triangulated"])
@pytest.mark.parametrize("view", range(len(VIEWS)))
def test_march_tanel_matches_jax(view, surface, packed):
    dem = make_dem(N)
    jp = _params(dem, VIEWS[view])
    jdem, tdem = jnp.asarray(dem), torch.from_numpy(dem)
    if packed:
        jdem, tdem = jray.pack_dem_pairs(jdem), tray.pack_dem_pairs(tdem)
        np.testing.assert_array_equal(tdem.numpy(), np.asarray(jdem))
    jt, jrm, jd, jaz = _jax_march(jdem, jp, 96, 300, surface)
    tt, trm, td, taz = tray.march_tanel(tdem, params_from_jax(jp, "cpu"),
                                        width=96, nsteps=300,
                                        cells_per_deg=CPD, surface=surface)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(taz.numpy(), np.asarray(jaz))
    check_tanel(jt, tt, _same_trig(taz))
    assert torch.equal(trm, torch.cummax(tt, dim=1).values)
    assert (tt > -1e30).float().mean() > 0.2


@pytest.mark.parametrize("surface", ["bilinear", "triangulated"])
def test_horizon_profile_matches_jax(surface):
    dem = make_dem(N)
    for view in VIEWS:
        jp = _params(dem, view)
        jaz, jh = jray.horizon_profile(jnp.asarray(dem), jp, width=128,
                                       nsteps=512, cells_per_deg=CPD,
                                       surface=surface)
        taz, th = tray.horizon_profile(torch.from_numpy(dem),
                                       params_from_jax(jp, "cpu"),
                                       width=128, nsteps=512,
                                       cells_per_deg=CPD, surface=surface)
        np.testing.assert_array_equal(taz.numpy(), np.asarray(jaz))
        check_tanel(jh[:, None], th[:, None], _same_trig(taz))


@pytest.mark.parametrize("surface", ["bilinear", "triangulated"])
@pytest.mark.parametrize("view", range(len(VIEWS)))
def test_render_step_matches_jax(view, surface):
    dem = make_dem(N, rough=4.0)
    jp = _params(dem, VIEWS[view])
    kw = dict(width=160, height=80, nsteps=400, cells_per_deg=CPD,
              sampler="step", surface=surface)
    img_j, rng_j = jray.render_panorama(jnp.asarray(dem), jp, **kw)
    tp = params_from_jax(jp, "cpu")
    img_t, rng_t, guard = tray.render_panorama(torch.from_numpy(dem), tp,
                                               with_dropped=True, **kw)
    _compare(np.asarray(img_j), np.asarray(rng_j), img_t.numpy(),
             rng_t.numpy())
    assert guard.tolist() == [0, 0]
    # the packed plane renders the same image
    img_p, rng_p = tray.render_panorama(
        tray.pack_dem_pairs(torch.from_numpy(dem)), tp, **kw)
    assert torch.equal(img_p, img_t) and torch.equal(rng_p, rng_t)


def test_step_d_of_matches_the_march():
    """The render's index -> distance map is the march's own distances,
    in one viewpoint and a batch."""
    dem = make_dem(N)
    tps = [params_from_jax(_params(dem, v), "cpu") for v in VIEWS]
    for p in (tps[0], sharding.stack_params(tps)):
        _, _, d, _ = tray.march_tanel(torch.from_numpy(dem), p, width=8,
                                      nsteps=200, cells_per_deg=CPD)
        idx = torch.arange(200).expand(d.shape[:-1] + (8, 200))
        got = tray.step_d_of(p, 200)(idx)
        assert torch.equal(got, d[..., None, :].expand_as(got))


def test_horizon_batch_matches_jax_singles_and_chunks(monkeypatch):
    """horizon_batch of the three views: az bitwise and tangents (as
    check_tanel) against the JAX package's vmap batch; each viewpoint
    bitwise its single horizon_profile; in chunks of one (BATCH_BYTES
    down) bitwise the whole."""
    dem = make_dem(N)
    jps = [_params(dem, v) for v in VIEWS]
    kw = dict(width=64, nsteps=256, cells_per_deg=CPD,
              surface="triangulated")
    jaz, jh = jshard.horizon_batch(jnp.asarray(dem), j_stack(jps), **kw)
    tp = params_from_jax(j_stack(jps), "cpu")
    taz, th = sharding.horizon_batch(torch.from_numpy(dem), tp, **kw)
    assert taz.shape == th.shape == (3, 64)
    np.testing.assert_array_equal(taz.numpy(), np.asarray(jaz))
    check_tanel(jh, th, _same_trig(taz))
    packed = tray.pack_dem_pairs(torch.from_numpy(dem))
    for b, jp in enumerate(jps):
        az1, h1 = tray.horizon_profile(packed, params_from_jax(jp, "cpu"),
                                       **kw)
        assert torch.equal(az1, taz[b]) and torch.equal(h1, th[b])
    monkeypatch.setattr(sharding, "BATCH_BYTES", 1)
    az_c, h_c = sharding.horizon_batch(packed, tp, **kw)
    assert torch.equal(az_c, taz) and torch.equal(h_c, th)
    with pytest.raises(ValueError, match="B >= 1"):
        sharding.horizon_batch(packed, params_from_jax(jps[0], "cpu"), **kw)
