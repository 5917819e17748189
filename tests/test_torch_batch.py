"""Port parity for batched rendering: parallel.render_batch / render_path
and the API's render_batch, against horizonator_tpu on the same inputs.

The JAX side renders a batch as lax.map over render_panorama (Pallas in
interpret mode on the CPU); the port renders it as one pass with a batch
axis (the kernels' plain versions here). Tolerances, and why:
- each viewpoint of a port batch against the same viewpoint of the JAX
  batch: test_torch_render's ``_compare`` untextured and
  test_torch_textured's ``_compare_textured`` textured, the tolerances of
  the single renders (a batch changes no arithmetic of a viewpoint);
- a port batch against the port's own single renders: bitwise, whatever
  the chunk size;
- guards: equal per viewpoint, and the API names the viewpoints at fault.
"""

import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizonator_tpu import horizonator as JHorizonator
from horizonator_tpu.parallel import stack_params as j_stack
from horizonator_tpu.parallel.sharding import render_batch as j_render_batch
from horizonator_tpu.parallel.sharding import render_path as j_render_path
from horizonator_tpu.render import lod as jlod
from horizonator_tpu.render import texture as jtex
from horizonator_tpu_torch import horizonator as THorizonator
from horizonator_tpu_torch.parallel import sharding
from horizonator_tpu_torch.render import lod as tlod
from horizonator_tpu_torch.render import (make_params, params_from_jax,
                                          render_panorama)
from horizonator_tpu_torch.render import texture as ttex
from horizonator_tpu_torch.render.crossing import k_cross_for
from tests.test_torch_geometry import CPD, jax_params, make_dem, viewer_z
from tests.test_torch_lod import (LOD_VIEW, N_LOD, W_LOD, ZFAR_LOD, _plan,
                                  _color_inputs)
from tests.test_torch_lod import srtm1_dir  # noqa: F401 (fixture)
from tests.test_torch_render import VIEW, _compare
from tests.test_torch_render import dem_dir  # noqa: F401 (fixture)
from tests.test_torch_textured import (_atlas_scene, _compare_textured,
                                       _smooth_planes, _write_tiles)

N_WIN = 257
# three viewpoints of one scene: positions, heights above ground, azimuth
# windows (a full circle, one across +-180 deg, a narrow one), znear
WIN_VIEWS = [(128.3, 127.6, 2.0, -180.0, 180.0, 100.0),
             (110.7, 140.2, 15.0, 150.0, 250.0, 60.0),
             (140.1, 118.9, 5.0, 20.0, 70.0, 150.0)]
LOD_VIEWS = [(384.3, 383.6, -180.0, 180.0), (40.2, 700.6, 100.0, 260.0),
             (500.5, 300.2, -40.0, 40.0)]


def _window_scene(textured=None):
    """The window scene; ``textured``: None, "hybrid" (half-cell planes and
    the hybrid near field) or "exact" (per-pixel atlas gathers)."""
    dem = make_dem(N_WIN)
    jps = [jax_params(vi, vj, viewer_z(dem, vi, vj, above), az0=a0, az1=a1,
                      znear=zn, zfar=9000.0, curv=6.8e-8 * (i % 2))
           for i, (vi, vj, above, a0, a1, zn) in enumerate(WIN_VIEWS)]
    kw = dict(width=96, height=48, nsteps=k_cross_for(9000.0, CPD, 34.0,
                                                      n=N_WIN),
              cells_per_deg=CPD, sampler="window", lat_hint_deg=34.0)
    jx, tx = {}, {}
    if textured:
        jcp, near = None, None
        if textured == "hybrid":
            jcp = jtex.prepare_color_planes(jnp.asarray(
                _smooth_planes(N_WIN, 2)))
            near = 1500.0
        atlas, ap = _atlas_scene(N_WIN, 128.3, 127.6, seed=9, smooth=True)
        jx = dict(textured=True, color_planes=jcp, atlas=jnp.asarray(atlas),
                  atlas_params=ap, exact_near_m=near)
        tcp, tat, tap = ttex.scene_from_jax(jcp, atlas, ap, device="cpu")
        tx = dict(textured=True, color_planes=tcp, atlas=tat,
                  atlas_params=tap, exact_near_m=near)
    return dem, dem, jps, kw, jx, tx


def _lod_scene(textured=None):
    """The LOD scene; ``textured``: None, or the form of the colour
    pyramid's level 0 ("planes2x", "half-float", test_torch_lod's)."""
    dem = make_dem(N_LOD, rough=4.0)
    plan = _plan()
    nlev = 1 + max(s.level for s in plan)
    jps = [jax_params(vi, vj, viewer_z(dem, vi, vj, above=5.0), az0=a0,
                      az1=a1, zfar=ZFAR_LOD)
           for vi, vj, a0, a1 in LOD_VIEWS]
    kw = dict(width=W_LOD, height=64, nsteps=1, cells_per_deg=CPD,
              sampler="lod", lod_plan=plan, lat_hint_deg=34.0)
    jpyr = jlod.build_pyramid(jnp.asarray(dem), nlev)
    tpyr = tlod.build_pyramid(torch.from_numpy(dem), nlev)
    jx, tx = {}, {}
    if textured:
        jc, tc = _color_inputs(textured, N_LOD)
        jx = dict(textured=True,
                  color_planes=jlod.build_color_pyramid(jc, nlev, N_LOD))
        tx = dict(textured=True,
                  color_planes=tlod.build_color_pyramid(tc, nlev, N_LOD))
    return jpyr, tpyr, jps, kw, jx, tx


@pytest.mark.parametrize("entry", ["render_batch", "render_path"])
@pytest.mark.parametrize("sampler,textured", [
    ("window", None), ("window", "hybrid"), ("window", "exact"),
    ("lod", None), ("lod", "planes2x")])
def test_batch_matches_jax_and_single_renders(entry, sampler, textured):
    scene = _window_scene if sampler == "window" else _lod_scene
    jdem, tdem, jps, kw, jx, tx = scene(textured)
    if sampler == "window":
        jdem, tdem = jnp.asarray(jdem), torch.from_numpy(tdem)
    j_fn = j_render_batch if entry == "render_batch" else j_render_path
    img_j, rng_j = (np.asarray(a) for a in j_fn(jdem, j_stack(jps), **kw,
                                                 **jx))
    tp = params_from_jax(j_stack(jps), "cpu")
    assert tp.viewer_cell_i.shape == (len(jps),)
    img_t, rng_t, guard = getattr(sharding, entry)(
        tdem, tp, with_dropped=True, **kw, **tx)
    assert img_t.shape == (len(jps), kw["height"], kw["width"], 3)
    assert guard.tolist() == [[0, 0]] * len(jps)
    cmp = _compare_textured if textured else _compare
    for b, jp in enumerate(jps):
        cmp(img_j[b], rng_j[b], img_t[b].numpy(), rng_t[b].numpy())
        img_1, rng_1 = render_panorama(tdem, params_from_jax(jp, "cpu"),
                                       **kw, **tx)
        assert torch.equal(img_t[b], img_1) and torch.equal(rng_t[b], rng_1)
    assert not torch.equal(rng_t[0], rng_t[1])


def _spy_chunks(monkeypatch):
    calls = []
    real = sharding.render_panorama

    def spy(dem, params, **kw):
        calls.append(params.viewer_cell_i.shape[0])
        return real(dem, params, **kw)
    monkeypatch.setattr(sharding, "render_panorama", spy)
    return calls


@pytest.mark.parametrize("sampler", ["window", "lod"])
def test_chunks_are_bitwise_one_batch(monkeypatch, sampler):
    """The budget constant lowered so that B = 5 runs in chunks of 2 and
    of 1: each result bitwise the one-chunk batch's (the LOD scene's float
    half-cell level 0 crops to (3, B, c, c) planes)."""
    if sampler == "window":
        _, dem, _, kw, _, tx = _window_scene("hybrid")
        dem = torch.from_numpy(dem)
    else:
        _, dem, _, kw, _, tx = _lod_scene("half-float")
    k = sharding.samples_per_column(dem, sampler, kw["nsteps"],
                                    kw.get("lod_plan"))
    views = 5
    p = make_params(
        device="cpu", viewer_cell_i=[128.3 + 7 * i for i in range(views)],
        viewer_cell_j=[127.6 - 5 * i for i in range(views)],
        viewer_z=[700.0 + 40 * i for i in range(views)],
        cos_viewer_lat=math.cos(math.radians(34.0)),
        az_rad0=[math.radians(-180.0 + 30 * i) for i in range(views)],
        az_rad1=[math.radians(90.0 + 30 * i) for i in range(views)],
        znear=100.0, zfar=9000.0, znear_color=100.0, zfar_color=9000.0)
    calls = _spy_chunks(monkeypatch)
    whole = sharding.render_batch(dem, p, with_dropped=True, **kw, **tx)
    assert calls == [views]
    for per_chunk, want in ((2, [2, 2, 1]), (1, [1] * views)):
        one = sharding.chunk_bytes(1, kw["width"], kw["height"], k, True)
        monkeypatch.setattr(sharding, "BATCH_BYTES", per_chunk * one + 1)
        calls.clear()
        parts = sharding.render_batch(dem, p, with_dropped=True, **kw, **tx)
        assert calls == want
        for a, b in zip(whole, parts):
            assert torch.equal(a, b)


def test_chunk_estimate_at_the_suite_shapes():
    """Configs 3 (64 viewpoints, LOD, 2048x512, K 1144) and 4 (60 frames,
    1920x480, K 580) fit one chunk; their textured forms too."""
    for b, w, h, k in ((64, 2048, 512, 1144), (60, 1920, 480, 580)):
        for textured in (False, True):
            assert sharding.chunk_size(b, w, h, k, textured) == b
            assert sharding.chunk_bytes(b, w, h, k, textured) \
                <= sharding.BATCH_BYTES
    assert sharding.chunk_size(10 ** 6, 4096, 1024, 580) < 10 ** 6


def test_broadcast_params_batch_keeps_dtypes_and_batched_leaves():
    p = sharding.stack_params([
        make_params(device="cpu", viewer_cell_i=v, viewer_cell_j=v,
                    viewer_z=900.0, cos_viewer_lat=0.8, az_rad0=0.0,
                    az_rad1=1.0, znear=100.0, zfar=9000.0, znear_color=100.0,
                    zfar_color=9000.0) for v in (100.0, 110.0)])
    p = p._replace(curv=torch.tensor(0.5, dtype=torch.bfloat16))
    fixed = sharding.broadcast_params_batch(p)
    assert fixed.curv.shape == (2,) and fixed.curv.dtype == torch.bfloat16
    assert fixed.viewer_cell_i.dtype == torch.float32
    assert torch.equal(fixed.viewer_cell_i, p.viewer_cell_i)
    one = make_params(device="cpu", viewer_cell_i=1.0, viewer_cell_j=1.0,
                      viewer_z=1.0, cos_viewer_lat=1.0, az_rad0=0.0,
                      az_rad1=1.0, znear=1.0, zfar=2.0, znear_color=1.0,
                      zfar_color=2.0)
    assert all(x.shape == () for x in sharding.broadcast_params_batch(one))


@pytest.mark.parametrize("entry", ["render_batch", "render_path"])
@pytest.mark.parametrize("sampler", ["step", "crossing"])
def test_unported_samplers_raise(entry, sampler):
    """The oracle samplers, which the port once refused here, batched: the
    window scene's three viewpoints (the step sampler on the triangulated
    surface) against the JAX package's vmap batch (``_compare``), each
    viewpoint bitwise its single render, the guard zeros, and the batch in
    chunks of one bitwise the whole."""
    _, dem, jps, kw, _, _ = _window_scene()
    kw["sampler"] = sampler
    if sampler == "step":
        kw.update(nsteps=384, surface="triangulated")
    j_fn = j_render_batch if entry == "render_batch" else j_render_path
    img_j, rng_j = (np.asarray(a) for a in j_fn(jnp.asarray(dem),
                                                 j_stack(jps), **kw))
    tdem, tp = torch.from_numpy(dem), params_from_jax(j_stack(jps), "cpu")
    img_t, rng_t, guard = getattr(sharding, entry)(tdem, tp,
                                                   with_dropped=True, **kw)
    assert guard.tolist() == [[0, 0]] * len(jps)
    for b, jp in enumerate(jps):
        _compare(img_j[b], rng_j[b], img_t[b].numpy(), rng_t[b].numpy())
        img_1, rng_1 = render_panorama(tdem, params_from_jax(jp, "cpu"),
                                       **kw)
        assert torch.equal(img_t[b], img_1) and torch.equal(rng_t[b], rng_1)
    k = sharding.samples_per_column(tdem, sampler, kw["nsteps"])
    one = sharding.chunk_bytes(1, kw["width"], kw["height"], k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sharding, "BATCH_BYTES", one + 1)
        parts = getattr(sharding, entry)(tdem, tp, **kw)
    assert torch.equal(parts[0], img_t) and torch.equal(parts[1], rng_t)


def test_render_batch_needs_a_batch():
    _, dem, jps, kw, _, _ = _window_scene()
    one = params_from_jax(jps[0], "cpu")
    empty = sharding.RenderParams(*(x[:0] for x in params_from_jax(
        j_stack(jps), "cpu")))
    for p in (one, empty):
        with pytest.raises(ValueError, match=r"\(B,\) fields"):
            sharding.render_batch(torch.from_numpy(dem), p, **kw)


# -- the API ------------------------------------------------------------------

def _api_pair(dem_dir, **kw):
    args = (VIEW["lat"], VIEW["lon"], 128, 64)
    kw = dict(dir_dems=dem_dir, render_radius_cells=128, **kw)
    return JHorizonator(*args, **kw), THorizonator(*args, device="cpu", **kw)


LATS = [VIEW["lat"], VIEW["lat"] + 0.02]
LONS = [VIEW["lon"], VIEW["lon"] + 0.01]


def test_api_render_batch_matches_jax(dem_dir):  # noqa: F811
    hj, ht = _api_pair(dem_dir)
    img_j, rng_j = hj.render_batch(-60, 60, LATS, LONS, zfar=15000.0)
    img_t, rng_t = ht.render_batch(-60, 60, LATS, LONS, zfar=15000.0)
    assert img_t.shape == (2, 64, 128, 3) and rng_t.shape == (2, 64, 128)
    assert img_t.dtype == np.uint8 and rng_t.dtype == np.float32
    for b in range(2):
        _compare(img_j[b], rng_j[b], img_t[b], rng_t[b])
        img_1, rng_1 = ht.render(-60, 60, lat=LATS[b], lon=LONS[b],
                                 zfar=15000.0)
        np.testing.assert_array_equal(img_t[b], img_1)
        np.testing.assert_array_equal(rng_t[b], rng_1)
    assert not np.array_equal(img_t[0], img_t[1])
    ele = [1500.0, 1600.0]
    img_e, rng_e = ht.render_batch(-60, 60, LATS, LONS, ele_m=ele,
                                   zfar=15000.0)
    img_je, rng_je = hj.render_batch(-60, 60, LATS, LONS, ele_m=ele,
                                     zfar=15000.0)
    for b in range(2):
        _compare(img_je[b], rng_je[b], img_e[b], rng_e[b])
    assert not np.array_equal(rng_e, rng_t)


def test_api_render_batch_color_ramp(dem_dir):  # noqa: F811
    hj, ht = _api_pair(dem_dir)
    img_d, rng_d = ht.render_batch(-60, 60, LATS[:1], LONS[:1])
    img_c, rng_c = ht.render_batch(-60, 60, LATS[:1], LONS[:1],
                                   znear_color=1.0, zfar_color=2.0)
    np.testing.assert_array_equal(rng_d, rng_c)      # ranges unaffected
    vis = rng_c[0] > 0
    assert (img_c[0][..., 2][vis] == 255).all()
    assert not (img_d[0][..., 2][vis] == 255).all()
    img_1, _ = ht.render(-60, 60, lat=LATS[0], lon=LONS[0], znear_color=1.0,
                         zfar_color=2.0)
    np.testing.assert_array_equal(img_c[0], img_1)
    img_j, rng_j = hj.render_batch(-60, 60, LATS[:1], LONS[:1],
                                   znear_color=1.0, zfar_color=2.0)
    _compare(img_j[0], rng_j[0], img_c[0], rng_c[0])


def test_api_render_batch_auto_lod(srtm1_dir):  # noqa: F811
    la, lo, zf = LOD_VIEW["lat"], LOD_VIEW["lon"], LOD_VIEW["radius"]
    kw = dict(SRTM1=True, dir_dems=srtm1_dir, render_radius_m=zf)
    hj = JHorizonator(la, lo, 128, 64, **kw)
    ht = THorizonator(la, lo, 128, 64, device="cpu", **kw)
    assert ht._batch_render_plan(100.0, zf)[1] == "lod"
    lats, lons = [la, la + 0.01], [lo, lo + 0.01]
    img_j, rng_j = hj.render_batch(10, 80, lats, lons, zfar=zf)
    img_t, rng_t = ht.render_batch(10, 80, lats, lons, zfar=zf)
    assert rng_t.max() > 30000.0
    for b in range(2):
        _compare(img_j[b], rng_j[b], img_t[b], rng_t[b])
        img_1, rng_1 = ht.render(10, 80, lat=lats[b], lon=lons[b], zfar=zf)
        np.testing.assert_array_equal(img_t[b], img_1)
        np.testing.assert_array_equal(rng_t[b], rng_1)


@pytest.mark.parametrize("nsteps", [None, 2048])
def test_api_render_batch_textured(dem_dir, tmp_path, nsteps):  # noqa: F811
    """Textured with the hybrid near field (tiles from a local cache, no
    downloads); nsteps 2048 takes the LOD swap, which drops the hybrid
    near field with one warning per instance."""
    _write_tiles(tmp_path, VIEW["lat"], VIEW["lon"], 128)
    hj, ht = _api_pair(dem_dir, render_texture=True, dir_tiles=str(tmp_path),
                       allow_downloads=False, nsteps=nsteps)
    kw = dict(zfar=15000.0)
    if nsteps:
        with pytest.warns(RuntimeWarning, match="render_batch.*hybrid"):
            img_t, rng_t = ht.render_batch(-180, 180, LATS, LONS, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        img_t, rng_t = ht.render_batch(-180, 180, LATS, LONS, **kw)
        img_j, rng_j = hj.render_batch(-180, 180, LATS, LONS, **kw)
        for b in range(2):
            _compare_textured(img_j[b], rng_j[b], img_t[b], rng_t[b])
            img_1, rng_1 = ht.render(-180, 180, lat=LATS[b], lon=LONS[b],
                                     **kw)
            np.testing.assert_array_equal(img_t[b], img_1)
            np.testing.assert_array_equal(rng_t[b], rng_1)
    assert (ht._pyramid is not None) == bool(nsteps)


def test_api_render_batch_guards(dem_dir):  # noqa: F811
    """A manual nsteps of 64 truncates the columns of the viewpoint in the
    middle of the grid and of neither viewpoint near its NE corner: the
    port's images equal the JAX package's (which says nothing), and it
    warns naming viewpoint 1, or raises under strict_coverage."""
    lats = [VIEW["lat"] + 118 / CPD, VIEW["lat"], VIEW["lat"] + 121 / CPD]
    lons = [VIEW["lon"] + 120 / CPD, VIEW["lon"], VIEW["lon"] + 117 / CPD]
    hj, ht = _api_pair(dem_dir, nsteps=64)
    with pytest.warns(RuntimeWarning,
                      match=r"render_batch\(\) \(viewpoints \[1\] of 3\).*"
                            r"columns stopped marching"):
        img_t, rng_t = ht.render_batch(0, 90, lats, lons, zfar=15000.0)
    img_j, rng_j = hj.render_batch(0, 90, lats, lons, zfar=15000.0)
    for b in range(3):
        _compare(img_j[b], rng_j[b], img_t[b], rng_t[b])
    _, hs = _api_pair(dem_dir, nsteps=64, strict_coverage=True)
    with pytest.raises(RuntimeError, match=r"viewpoints \[1\] of 3"):
        hs.render_batch(0, 90, lats, lons, zfar=15000.0)


def test_api_render_batch_mesh_raises(dem_dir):  # noqa: F811
    """A mesh that is none raises, and one of several ranks without a
    process group names torchrun; meshes that are run in a gloo world:
    tests/test_torch_sharding.py."""
    _, ht = _api_pair(dem_dir)
    with pytest.raises(ValueError, match="DeviceMesh"):
        ht.render_batch(-60, 60, LATS, LONS, mesh=object())
    if not torch.distributed.is_initialized():
        with pytest.raises(ValueError, match="torchrun"):
            ht.render_batch(-60, 60, LATS, LONS, mesh=2)
