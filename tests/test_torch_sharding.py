"""Port parity: the batch x azimuth entries, the API's scale-out and the
viewshed ops' mesh= against their single-device runs.

A spawned gloo world of 4 ranks (tests/test_torch_worlds.py) runs
``make_sharded_renderer`` (untextured, with the coverage guard, and with
cell colours) and ``make_sharded_horizon`` on a 2 x 2 ("batch", "az")
mesh and on a batch-only mesh of 4 (which gets a size-1 "az"); the API's
``region_mesh="auto"`` (a 257^2 mosaic padded to 4 bands of 65 rows:
render, pick, horizon, the render_batch loop) and ``region_mesh=4`` with
hillshade; the API's ``render_batch(mesh=)`` with "auto" (3 viewpoints
padded to 4), the batch-only mesh and the 2 x 2 mesh; and
``viewshed_sweep`` / ``viewshed_count`` with mesh= over batches of 8
split 4 ways. One process with no process group runs the one-rank forms:
"auto" makes a gloo group on a HashStore (the API's textured hybrid
region render, render_batch and viewshed_count through it), a larger mesh
raises naming torchrun, and a CUDA mesh over the gloo group raises.

Tolerances: every rank returns the same arrays. Without wedges the
results are bitwise the single-device runs (images, ranges, horizons,
picks; counts exact). Wedged renders hold the JAX tests' wedge tolerance
(tests/test_parallel.py:64-71: sky masks disagree at < 0.2% of pixels,
ranges within 5e-3 relative + 1 m elsewhere) and wedged horizons 1e-5
(tests/test_parallel.py:85-86). The API's region render holds
test_torch_render's tolerance against the JAX package's region render on
the 8-virtual-device mesh.
"""

import math

import numpy as np
import pytest
import torch

from horizonator_tpu import horizonator as JHorizonator
from horizonator_tpu_torch import horizonator as THorizonator
from horizonator_tpu_torch.ops import viewshed_count, viewshed_sweep
from horizonator_tpu_torch.parallel import horizon_batch, render_batch
from horizonator_tpu_torch.render import make_params
from horizonator_tpu_torch.render.crossing import k_cross_for
from tests import test_torch_worlds as torch_worlds
from tests.test_torch_geometry import CPD, make_dem, viewer_z
from tests.test_torch_regions import _wedge_close
from tests.test_torch_render import VIEW, _compare, dem_dir  # noqa: F401
from tests.test_torch_textured import _write_tiles

W, H = torch_worlds.W, torch_worlds.H
N = 128
ZFAR = 9000.0
K = k_cross_for(ZFAR, CPD, 34.0, n=N)
LATS = [VIEW["lat"], VIEW["lat"] + 0.02, VIEW["lat"] - 0.01]
LONS = [VIEW["lon"], VIEW["lon"] + 0.01, VIEW["lon"] - 0.02]
API_KW = dict(render_radius_cells=128)


def _views(dem):
    out = []
    for vi, vj, az0, az1 in ((64.3, 63.6, -180.0, 180.0),
                             (30.2, 90.7, -40.0, 75.0),
                             (100.5, 20.25, 170.0, -170.0),
                             (64.0, 64.0, 0.0, 360.0)):
        out.append(dict(viewer_cell_i=vi, viewer_cell_j=vj,
                        viewer_z=viewer_z(dem, vi, vj),
                        cos_viewer_lat=math.cos(math.radians(34.0)),
                        az_rad0=math.radians(az0), az_rad1=math.radians(az1),
                        znear=100.0, zfar=ZFAR, znear_color=100.0,
                        zfar_color=ZFAR))
    return out


def _vs_inputs():
    dem = make_dem(160, rough=6.0)
    rng = np.random.default_rng(4)
    pts = rng.uniform(30.0, 130.0, (10, 2)).astype(np.float32)
    kw = dict(width=32, cells_per_deg=CPD, zfar=5000.0, lat_deg=34.0,
              sampler="window")
    ckw = dict(kw, out_center_ij=(80.0, 80.0), out_halfwidth=24)
    return dict(dem=dem, pts=pts, kw=kw, ckw=ckw)


def _api(dem_dir, pick=(0, 0)):
    return dict(lat=VIEW["lat"], lon=VIEW["lon"], lats=LATS, lons=LONS,
                pick=pick, kw=dict(dir_dems=dem_dir, **API_KW))


@pytest.fixture(scope="module")
def single_api(dem_dir):  # noqa: F811
    """The port's single-device API and its render, the reference."""
    h = THorizonator(VIEW["lat"], VIEW["lon"], W, H, device="cpu",
                     dir_dems=dem_dir, **API_KW)
    img, rng = h.render(-60, 60, zfar=15000.0)
    return h, img, rng


@pytest.fixture(scope="module")
def sharding_world(tmp_path_factory, dem_dir, single_api):  # noqa: F811
    dem = make_dem(N, rough=6.0)
    ys, xs = np.nonzero(single_api[2] > 0)
    cell = np.random.default_rng(7).integers(0, 256, (3, N, N)).astype(
        np.float32)
    inputs = dict(dem=dem, views=_views(dem), k=K, cell=cell,
                  api=_api(dem_dir, (int(xs[0]), int(ys[0]))),
                  vs=_vs_inputs())
    outs = torch_worlds.spawn("sharding",
                              tmp_path_factory.mktemp("sharding"), 4, inputs)
    for other in outs[1:]:
        for k, v in outs[0].items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)
    return inputs, outs[0]


def _one_device(inputs, **kw):
    p = make_params(device="cpu", **{
        k: [v[k] for v in inputs["views"]] for k in inputs["views"][0]})
    return p, render_batch(torch.from_numpy(inputs["dem"]), p, width=W,
                           height=H, nsteps=K, cells_per_deg=CPD,
                           sampler="window", lat_hint_deg=34.0,
                           with_dropped=True, **kw)


@pytest.mark.parametrize("mesh", ["b2a2", "b4"])
def test_sharded_renderer_matches_one_device(sharding_world, mesh):
    inputs, out = sharding_world
    _, (img, rng, guard) = _one_device(inputs)
    _, (timg, trng, _) = _one_device(
        inputs, textured=True, color_planes=torch.from_numpy(inputs["cell"]))
    assert out[f"{mesh}/img"].shape == (4, H, W, 3)
    np.testing.assert_array_equal(out[f"{mesh}/guard"], guard.numpy())
    for b in range(4):
        if mesh == "b4":
            np.testing.assert_array_equal(out[f"{mesh}/img"][b], img[b])
            np.testing.assert_array_equal(out[f"{mesh}/rng"][b], rng[b])
            np.testing.assert_array_equal(out[f"{mesh}/timg"][b], timg[b])
            np.testing.assert_array_equal(out[f"{mesh}/trng"][b], trng[b])
        else:
            _wedge_close(rng[b].numpy(), out[f"{mesh}/rng"][b])
            _wedge_close(trng[b].numpy(), out[f"{mesh}/trng"][b])
    assert (out[f"{mesh}/timg"][..., 1] > 30).any()      # colours ride


def test_sharded_horizon_matches_one_device(sharding_world):
    inputs, out = sharding_world
    p = make_params(device="cpu", **{
        k: [v[k] for v in inputs["views"]] for k in inputs["views"][0]})
    az, tan = horizon_batch(torch.from_numpy(inputs["dem"]), p, width=W,
                            nsteps=256, cells_per_deg=CPD)
    np.testing.assert_allclose(out["hz/az"], az.numpy(), atol=1e-6)
    np.testing.assert_allclose(out["hz/tan"], tan.numpy(), atol=1e-5)
    assert (out["hz/tan"] > -1e30).mean() > 0.5


def test_api_region_mesh_bitwise_single(sharding_world, single_api):
    inputs, out = sharding_world
    h, img, rng = single_api
    assert int(out["api/region_r"]) == 4
    np.testing.assert_array_equal(out["api/img"], img)
    np.testing.assert_array_equal(out["api/rng"], rng)
    h.render(-60, 60, zfar=15000.0)
    np.testing.assert_array_equal(out["api/pick"],
                                  np.asarray(h.pick(*inputs["api"]["pick"])))
    haz, htan = h.horizon(-30, 30, width=32, zfar=15000.0)
    np.testing.assert_array_equal(out["api/haz"], haz)
    np.testing.assert_array_equal(out["api/htan"], htan)
    for b, (la, lo) in enumerate(zip(LATS, LONS)):
        ib, rb = h.render(-60, 60, lat=la, lon=lo, zfar=15000.0)
        np.testing.assert_array_equal(out["api/bimg"][b], ib)
        np.testing.assert_array_equal(out["api/brng"][b], rb)
    h.render(-60, 60, lat=VIEW["lat"], lon=VIEW["lon"], zfar=15000.0)


def test_api_region_hillshade_bitwise_single(sharding_world,
                                             dem_dir):  # noqa: F811
    _, out = sharding_world
    hs = THorizonator(VIEW["lat"], VIEW["lon"], W, H, hillshade=True,
                      device="cpu", dir_dems=dem_dir, **API_KW)
    img, rng = hs.render(-60, 60, zfar=15000.0)
    np.testing.assert_array_equal(out["api/himg"], img)
    np.testing.assert_array_equal(out["api/hrng"], rng)


def test_api_region_mesh_matches_jax(sharding_world, dem_dir):  # noqa: F811
    _, out = sharding_world
    hj = JHorizonator(VIEW["lat"], VIEW["lon"], W, H, region_mesh="auto",
                      dir_dems=dem_dir, **API_KW)
    img_j, rng_j = hj.render(-60, 60, zfar=15000.0)
    _compare(img_j, rng_j, out["api/img"], out["api/rng"])


@pytest.mark.parametrize("mesh", ["auto", "b4", "b2a2"])
def test_api_render_batch_mesh(sharding_world, single_api, mesh):
    _, out = sharding_world
    h = single_api[0]
    imgs, rngs = h.render_batch(-60, 60, LATS, LONS, zfar=15000.0)
    got_i, got_r = out[f"api/m_{mesh}_img"], out[f"api/m_{mesh}_rng"]
    assert got_i.shape == imgs.shape and got_r.shape == rngs.shape
    if mesh == "b2a2":
        for b in range(len(LATS)):
            _wedge_close(rngs[b], got_r[b])
    else:
        np.testing.assert_array_equal(got_i, imgs)
        np.testing.assert_array_equal(got_r, rngs)


def test_viewshed_ops_mesh_match_one_device(sharding_world):
    inputs, out = sharding_world
    vs = inputs["vs"]
    sweep = viewshed_sweep(vs["dem"], vs["pts"], batch=8, device="cpu",
                           **vs["kw"]).numpy()
    count = viewshed_count(vs["dem"], vs["pts"], batch=8, device="cpu",
                           **vs["ckw"]).numpy()
    np.testing.assert_array_equal(out["vs/sweep"], sweep)
    np.testing.assert_array_equal(out["vs/count"], count)
    assert count.max() >= 3 and sweep.shape == (10, 32)


def test_viewshed_mesh_batch_must_divide(sharding_world):
    """The JAX package's divisibility error (viewshed.py:1066-1070), raised
    on every rank before any collective; a mesh that is none raises before
    any process group is made."""
    _, out = sharding_world
    assert "not divisible by mesh batch axis 4" in str(out["vs/err_div"])
    vs = _vs_inputs()
    with pytest.raises(ValueError, match="DeviceMesh"):
        viewshed_sweep(vs["dem"], vs["pts"], batch=8, device="cpu",
                       mesh="bogus", **vs["kw"])


def test_one_rank_without_process_group(tmp_path, dem_dir):  # noqa: F811
    """One process, no process group: "auto" makes a one-rank gloo group;
    the textured hybrid region render is bitwise the unsharded one."""
    _write_tiles(tmp_path, VIEW["lat"], VIEW["lon"], 128)
    tkw = dict(dir_dems=dem_dir, dir_tiles=str(tmp_path), **API_KW)
    api = dict(_api(dem_dir), tkw=tkw)
    vs = _vs_inputs()
    out, = torch_worlds.spawn("solo", tmp_path, 0, dict(api=api, vs=vs))
    assert "torchrun" in str(out["err_world"])
    assert not bool(out["inited_after_err"])
    assert str(out["backend"]) == "gloo" and int(out["world"]) == 1
    assert "nccl" in str(out["err_cuda"])
    ht = THorizonator(VIEW["lat"], VIEW["lon"], W, H, device="cpu",
                      render_texture=True, allow_downloads=False, **tkw)
    img, rng = ht.render(-60, 60, zfar=15000.0)
    np.testing.assert_array_equal(out["api/timg"], img)
    np.testing.assert_array_equal(out["api/trng"], rng)
    h = THorizonator(VIEW["lat"], VIEW["lon"], W, H, device="cpu",
                     dir_dems=dem_dir, **API_KW)
    imgs, rngs = h.render_batch(-60, 60, LATS, LONS, zfar=15000.0)
    np.testing.assert_array_equal(out["api/m_img"], imgs)
    np.testing.assert_array_equal(out["api/m_rng"], rngs)
    count = viewshed_count(vs["dem"], vs["pts"], batch=8, device="cpu",
                           **vs["ckw"]).numpy()
    np.testing.assert_array_equal(out["vs/count"], count)
