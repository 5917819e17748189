"""Port parity for ops/viewshed: viewshed_polar, viewshed_grid, the sweeps
and viewshed_count against horizonator_tpu.ops on the same inputs (the
window sampler: Pallas in interpret mode on the JAX side, the march's plain
version on the port's).

Tolerances, and why:
- the polar field: the same valid samples, tangents within 1e-5 and
  distances within 1e-6 relative (test_torch_window's tolerances for a
  march on the port's own crossing geometry, whose sin and cos differ
  from XLA's by an ulp; the near band is a 4-corner bilinear here, a
  hat-weight contraction there), visibility within SHARE;
- rasters: at most 0.5% of the cells differ (measured 0-0.13%), and every
  differing cell is on a visibility boundary of the JAX raster (a
  4-neighbour holds the other value), within 1.5 cells of the znear /
  zfar ring, or a tie: a contract cell whose result changes when its
  radius r along its polar column moves by 4 ulps, or whose tangent lies
  within 4 ulps of its horizon. torch and XLA's CPU back end differ by an
  ulp in cos and sin (which set r = north / cos - half and the crossings'
  distances), atan2 (a sixth of the cells) and sqrt; with the viewer on a
  grid line r lands on a crossing's distance, and an ulp decides whether
  that sample is in the cell's horizon;
- guards (dropped + truncated + the full-circle coverage count): equal;
- horizons (max tangent per column): the same valid columns, values
  within 1e-5 (the near band is a 4-corner bilinear here, a hat-weight
  contraction there: test_torch_window's tolerance);
- the JAX sweeps take an AlignedScene at every grid of 136 cells or more,
  which the JAX package holds equal to the unaligned march
  (tests/test_viewshed.py:258, :276); the port has none;
- the port against itself: bitwise (the contract resampler, which is
  ``resample_plain`` on the CPU, against the direct masked max of
  ``plain=True``, a batch against its single viewpoints, chunked against
  whole).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizonator_tpu import ops as jops
from horizonator_tpu.render import RenderParams as JParams
from horizonator_tpu_torch import ops as tops
from horizonator_tpu_torch.ops import viewshed as tview
from horizonator_tpu_torch.parallel import sharding, stack_params
from horizonator_tpu_torch.render import params_from_jax

CPD = 1200
CELL_M = 6371000.0 * np.pi / 180.0 / CPD
LAT = 34.3
SHARE = 0.005         # most cells a smooth-terrain raster may differ in


def jparams(vi, vj, vz, zfar=20000.0, az0=-np.pi, az1=np.pi, znear=50.0,
            cos_lat=1.0):
    f = jnp.float32
    return JParams(f(vi), f(vj), f(vz), f(cos_lat), f(az0), f(az1),
                   f(znear), f(zfar), f(znear), f(zfar))


def tp(p):
    return params_from_jax(p, "cpu")


def smooth_dem(n, noise=3.0, seed=7):
    """tests/test_viewshed_contract.py's terrain."""
    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32), indexing="ij")
    z = (600 + 500 * np.sin(ii / 223) * np.cos(jj / 181)
         + 200 * np.sin(ii / 37 + 1.3) * np.cos(jj / 53)
         + noise * rng.standard_normal((n, n), dtype=np.float32))
    return np.maximum(z, 0).astype(np.float32)


def wall_dem(n=512, lo=300, hi=302, height=400.0, axis=0, base=0.0):
    d = np.full((n, n), base, np.float32)
    if axis == 0:
        d[lo:hi, :] = height
    else:
        d[:, lo:hi] = height
    return d


def _edge(v):
    """Cells with a 4-neighbour of the other value."""
    e = np.zeros_like(v)
    e[1:] |= v[1:] != v[:-1]
    e[:-1] |= v[:-1] != v[1:]
    e[:, 1:] |= v[:, 1:] != v[:, :-1]
    e[:, :-1] |= v[:, :-1] != v[:, 1:]
    return e


def _ring(p, hw, center, cos_lat):
    """Cells within 1.5 cells of the znear or zfar circle."""
    vi, vj = float(p.viewer_cell_i), float(p.viewer_cell_j)
    ci, cj = center if center is not None else (vi, vj)
    off = np.arange(2 * hw) - hw + 0.5
    e = (ci + off - vi)[None, :] * CELL_M * cos_lat
    n = (cj + off - vj)[:, None] * CELL_M
    d = np.hypot(e, n)
    tol = 1.5 * CELL_M
    return ((np.abs(d - float(p.znear)) < tol)
            | (np.abs(d - float(p.zfar)) < tol))


def _ties(dem, p, kw):
    """Contract cells that an ulp decides, in the port's own march and
    frame: the cell's result changes when its radius r along its polar
    column moves by 4 float32 ulps (a sample's distance ties r), or its own
    tangent lies within 4 ulps of its horizon."""
    q = tview._lift(tp(p))
    hw, width = kw["out_halfwidth"], kw["width"]
    f = tview._frame(q, hw, kw.get("out_center_ij"), CPD, width)
    dem_t = torch.from_numpy(dem)
    surface = kw.get("surface", "bilinear")
    tanel, d, half, az, _ = tview._march(
        dem_t, q, sampler=kw.get("sampler", "window"), width=width,
        nsteps=kw["nsteps"], cells_per_deg=CPD, surface=surface,
        lat_hint_deg=kw["lat_hint_deg"], znear_hint_m=100.0, plain=True)
    t, _ = tview._cell_tangent(dem_t, q, f, hw, surface)
    half = half[:, :, None]
    r_a = f["nn"][:, None, :] / torch.cos(az)[:, :, None] - half
    r_b = f["ee"][:, None, :] / torch.sin(az)[:, :, None] - half
    region_a = f["nn"].abs()[:, :, None] >= f["ee"].abs()[:, None, :]
    eps = 4.0 * float(np.finfo(np.float32).eps)

    def horizon(shift):
        t_a, t_b = tview._tables_direct(
            tanel, d, [r + shift * eps * r.abs() for r in (r_a, r_b)])
        return torch.where(region_a,
                           torch.gather(t_a.transpose(1, 2), 2, f["xc"]),
                           torch.gather(t_b, 1, f["xc"]))
    lo, mid, hi = horizon(-1.0), horizon(0.0), horizon(1.0)
    return (((t >= lo) != (t >= hi))
            | ((t - mid).abs() <= eps * t.abs()))[0].numpy()


def _gather_ties(dem, p, kw):
    """Gather cells of the oracle samplers whose polar sample's visibility
    an ulp of sin or cos decides: in the port's own field its tangent lies
    within 1e-5 (the tolerance of an oracle tangent against the JAX
    package's, whose every sample moves with its column's sin and cos) of
    the running horizon before it."""
    q = tview._lift(tp(p))
    hw, width = kw["out_halfwidth"], kw["width"]
    sampler = kw.get("sampler", "window")
    f = tview._frame(q, hw, kw.get("out_center_ij"), CPD, width)
    tanel = tview._march(
        torch.from_numpy(dem), q, sampler=sampler, width=width,
        nsteps=kw["nsteps"], cells_per_deg=CPD,
        surface=kw.get("surface", "bilinear"),
        lat_hint_deg=kw.get("lat_hint_deg", 45.0), znear_hint_m=100.0,
        plain=True)[0]
    run = torch.cummax(tanel, dim=-1).values
    prev = torch.cat([torch.full_like(run[..., :1], -3e38), run[..., :-1]],
                     dim=-1)
    tie = ((tanel - prev).abs() <= 1e-5).reshape(1, -1)
    idx = tview._gather_index(
        q, f, tanel.shape[-1], width=width, cells_per_deg=CPD,
        step_nsteps=kw["nsteps"] if sampler == "step" else None)
    return torch.gather(tie, 1, idx.reshape(1, -1)).view_as(idx)[0].numpy()


def _auto_gather(kw) -> bool:
    method = kw.get("method", "auto")
    if method == "auto":
        return kw.get("sampler", "step") == "step"
    return method == "gather"


def assert_raster_close(jv, tv, dem, p, kw, cos_lat=1.0):
    jv, tv = np.asarray(jv), np.asarray(tv)
    assert jv.shape == tv.shape
    bad = jv != tv
    assert bad.mean() <= SHARE, f"{bad.mean():.4%} of cells differ"
    hw, center = kw["out_halfwidth"], kw.get("out_center_ij")
    stray = bad & ~_edge(jv) & ~_ring(p, hw, center, cos_lat)
    if not _auto_gather(kw):
        stray &= ~_ties(dem, p, kw)
    elif kw.get("sampler", "step") != "window":
        stray &= ~_gather_ties(dem, p, kw)
    assert not stray.any(), f"{int(stray.sum())} differing cells off any " \
                            f"boundary, e.g. {np.argwhere(stray)[:5]}"


def check_grid(dem, p, cos_lat=1.0, sampler="window", **kw):
    """The JAX and the port's rasters with_dropped: guards equal, the
    port's resampler bitwise its direct masked max, the rasters close.
    Returns the port's (raster, guard)."""
    kw = dict(kw, sampler=sampler, with_dropped=True, cells_per_deg=CPD)
    jv, jg = jops.viewshed_grid(jnp.asarray(dem), p, **kw)
    dem_t = torch.from_numpy(dem)
    tv, tg = tops.viewshed_grid(dem_t, tp(p), **kw)
    dv, dg = tops.viewshed_grid(dem_t, tp(p), plain=True, **kw)
    assert int(tg) == int(jg) == int(dg)
    assert torch.equal(tv, dv)
    assert_raster_close(jv, tv, dem, p, kw, cos_lat)
    return tv.numpy(), int(tg)


# ---- the polar field -------------------------------------------------------

def test_polar_wall_shadow_matches_jax():
    """tests/test_viewshed.py:124's wall north of the viewer, window
    sampler, and the analytic shadow on the port's field."""
    dem = wall_dem()
    p = jparams(256, 256, 2.0)
    kw = dict(width=360, nsteps=512, cells_per_deg=CPD, sampler="window",
              lat_hint_deg=0.0, with_dropped=True)
    jvis, jtan, jd, jaz, jdrop = jops.viewshed_polar(jnp.asarray(dem), p,
                                                     **kw)
    vis, tan, d, az, drop = tops.viewshed_polar(torch.from_numpy(dem),
                                                tp(p), **kw)
    jtan = np.asarray(jtan)
    valid = jtan > -1e30
    np.testing.assert_array_equal(tan.numpy() > -1e30, valid)
    np.testing.assert_allclose(tan.numpy()[valid], jtan[valid], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
    np.testing.assert_allclose(az.numpy(), np.asarray(jaz), atol=1e-6)
    assert (vis.numpy() != np.asarray(jvis)).mean() <= SHARE
    assert int(drop) == int(jdrop) == 0
    vis, d, az = vis.numpy(), d.numpy(), az.numpy()
    x0 = np.argmin(np.abs(az))
    d_wall = (300 - 256) * CELL_M
    assert vis[x0][(d[x0] > 0) & (d[x0] < d_wall - 200)].all()
    assert not vis[x0][(d[x0] > d_wall + 500) & (d[x0] < 15000)].any()


def test_polar_guard_matches_jax():
    """with_dropped on a random grid (tests/test_viewshed.py:234), and a
    step budget short of the grid, where ``truncated`` counts columns."""
    rng = np.random.default_rng(3)
    dem = (200.0 + 40.0 * rng.random((160, 160))).astype(np.float32)
    p = jparams(80.0, 80.0, 260.0, zfar=5000.0)
    for nsteps in (64, 16):
        kw = dict(width=64, nsteps=nsteps, cells_per_deg=CPD,
                  sampler="window", lat_hint_deg=34.0, with_dropped=True)
        *jf, jdrop = jops.viewshed_polar(jnp.asarray(dem), p, **kw)
        *tf, drop = tops.viewshed_polar(torch.from_numpy(dem), tp(p), **kw)
        assert int(drop) == int(jdrop)
        assert (tf[0].numpy() != np.asarray(jf[0])).mean() <= SHARE
    assert int(drop) > 0


# ---- rasters ---------------------------------------------------------------

def test_grid_wall_shadow_matches_jax():
    """tests/test_viewshed.py:48's wall raster through the window sampler
    (the JAX test's own default is the step sampler), and its analytic
    shadow on the port's raster."""
    dem = wall_dem()
    p = jparams(256, 256, 2.0)
    hw = 200
    tv, tg = check_grid(dem, p, width=720, nsteps=1024, out_halfwidth=hw,
                        lat_hint_deg=0.0)
    assert tg == 0
    assert tv[20:hw - 20, :].mean() > 0.9
    assert tv[(300 - 256 + hw) + 5:, hw - 50:hw + 50].mean() < 0.05


def test_grid_contract_wall_matches_jax():
    """tests/test_viewshed_contract.py:80's north-south wall, both
    resamplers, window sampler, and the contract raster's analytic
    shadow."""
    dem = wall_dem(300, 168, 171, 500.0, axis=1, base=100.0)
    p = jparams(150, 150, 120.0, zfar=8000.0)
    kw = dict(width=256, nsteps=256, out_halfwidth=100, lat_hint_deg=0.0)
    vg, gg = check_grid(dem, p, method="gather", **kw)
    vc, gc = check_grid(dem, p, method="contract", **kw)
    assert gg == gc == 0
    assert vc[100, 60:110].all()
    assert not vc[100, 122:180].any()
    assert (vg != vc).mean() < 0.01


# (name, viewer (i, j), azimuth window deg, frame centre, options)
RASTERS = [
    ("contract centred full circle", (150.0, 150.0), None, None,
     dict(method="contract", full_circle=True)),
    ("contract centred partial window", (150.25, 150.5), (-30, 140), None,
     dict(method="contract")),
    ("contract fixed frame full circle", (150.0, 150.0), None, (135.0, 160.0),
     dict(method="contract", full_circle=True)),
    ("contract fixed frame partial", (141.3, 152.6), (100, 300),
     (150.0, 150.0), dict(method="contract")),
    ("contract triangulated", (150.25, 150.5), None, None,
     dict(method="auto", surface="triangulated")),
    ("contract viewer near the edge", (20.0, 25.0), None, None,
     dict(method="contract")),
    ("gather centred full circle", (150.25, 150.5), None, None,
     dict(method="gather")),
    ("gather fixed frame partial", (150.0, 150.0), (-30, 140),
     (160.0, 144.0), dict(method="gather")),
]


@pytest.mark.parametrize("name,viewer,window,center,opts", RASTERS,
                         ids=[r[0] for r in RASTERS])
def test_grid_matches_jax(name, viewer, window, center, opts):
    """Smooth terrain (tests/test_viewshed_contract.py's), lat 34.3:
    rasters within SHARE and on boundaries, guards equal, the fast
    resampler bitwise the direct masked max."""
    cos_lat = math.cos(math.radians(LAT))
    az = {} if window is None else dict(az0=math.radians(window[0]),
                                        az1=math.radians(window[1]))
    p = jparams(*viewer, 1400.0, zfar=8000.0, cos_lat=cos_lat, **az)
    tv, tg = check_grid(smooth_dem(300), p, cos_lat, width=256, nsteps=256,
                        out_halfwidth=80, lat_hint_deg=LAT,
                        out_center_ij=center, **opts)
    assert tg == 0
    assert tv.any() and not tv.all()
    if name.endswith("near the edge"):
        assert not tv[:80 - 25 - 1].any() and not tv[:, :80 - 20 - 1].any()
    if window == (-30, 140) and center is None:
        assert not tv[:60, :60].any()


@pytest.mark.parametrize("center", [None, (135.0, 160.0)],
                         ids=["centred", "fixed frame"])
def test_full_circle_coverage_guard(center):
    """tests/test_viewshed_contract.py:337 in both frames: 0 on an honest
    full circle; with the promise broken by a partial window, the count of
    uncovered cells equals the JAX quarter-arc forms' and is nonzero, and
    those cells read as they do there."""
    cos_lat = math.cos(math.radians(LAT))
    dem = smooth_dem(300)
    kw = dict(width=256, nsteps=256, out_halfwidth=80, lat_hint_deg=LAT,
              method="contract", full_circle=True, out_center_ij=center)
    for az0, az1, viewer in ((-180, 180, (150.0, 150.0)),
                             (-30, 140, (150.0, 150.0)),
                             (100, 215, (152.7, 147.2))):
        p = jparams(*viewer, 1400.0, zfar=8000.0, cos_lat=cos_lat,
                    az0=math.radians(az0), az1=math.radians(az1))
        tv, tg = check_grid(dem, p, cos_lat, **kw)
        assert (tg == 0) == (az1 - az0 == 360)


def test_grid_center_registration():
    """A fixed frame on the viewer's own position equals the centred
    raster bitwise; a shifted frame reproduces the overlap
    (tests/test_viewshed.py:319, :337 on the port)."""
    dem = torch.from_numpy(wall_dem())
    kw = dict(width=256, nsteps=256, cells_per_deg=CPD, sampler="window",
              out_halfwidth=64, lat_hint_deg=0.0)
    p = tp(jparams(256.25, 256.5, 2.0, zfar=8000.0))
    base = tops.viewshed_grid(dem, p, **kw)
    fixed = tops.viewshed_grid(dem, p, out_center_ij=(256.25, 256.5), **kw)
    assert torch.equal(base, fixed)
    flat = torch.zeros((512, 512))
    p = tp(jparams(256.0, 256.0, 2.0, zfar=8000.0))
    kw["out_halfwidth"] = 32
    a = tops.viewshed_grid(flat, p, out_center_ij=(256.0, 256.0), **kw)
    b = tops.viewshed_grid(flat, p, out_center_ij=(266.0, 252.0), **kw)
    assert torch.equal(a[4:, :-10], b[:-4, 10:])


def test_grid_batch_equals_single_and_chunks(monkeypatch):
    """(B,) params: one raster per viewpoint, each bitwise its single call,
    whole or in chunks of one (BATCH_BYTES down); the guards per
    viewpoint."""
    cos_lat = math.cos(math.radians(LAT))
    dem = torch.from_numpy(smooth_dem(300))
    views = [jparams(150.0, 150.0, 1400.0, zfar=8000.0, cos_lat=cos_lat),
             jparams(131.7, 170.2, 1300.0, zfar=6000.0, cos_lat=cos_lat),
             jparams(160.2, 140.9, 1500.0, zfar=8000.0, cos_lat=cos_lat,
                     az0=-1.0, az1=2.0)]
    pb = stack_params([tp(p) for p in views])
    for opts in (dict(method="contract", full_circle=True),
                 dict(method="gather")):
        kw = dict(width=128, nsteps=256, cells_per_deg=CPD, sampler="window",
                  out_halfwidth=48, lat_hint_deg=LAT, with_dropped=True,
                  out_center_ij=(150.0, 150.0), **opts)
        vis, guard = tops.viewshed_grid(dem, pb, **kw)
        assert vis.shape == (3, 96, 96) and guard.shape == (3,)
        for v, p in enumerate(views):
            one, g1 = tops.viewshed_grid(dem, tp(p), **kw)
            assert torch.equal(vis[v], one) and int(g1) == int(guard[v])
        assert (int(guard[2]) > 0) == opts.get("full_circle", False)
        monkeypatch.setattr(tview, "BATCH_BYTES", 1)
        vis1, guard1 = tops.viewshed_grid(dem, pb, **kw)
        monkeypatch.undo()
        assert torch.equal(vis, vis1) and torch.equal(guard, guard1)


# ---- sweeps and counts -----------------------------------------------------

def _sweep_params(views, zfar=8000.0):
    f = lambda v: jnp.asarray(np.float32(v))
    return JParams(*[jnp.stack([f(v[c]) for v in views]) for c in range(4)],
                   *[jnp.full((len(views),), v, jnp.float32) for v in (
                       -np.pi, np.pi, 50.0, zfar, 50.0, zfar)])


def test_horizon_sweep_matches_jax_and_singles(monkeypatch):
    """tests/test_viewshed.py:66's grid, four viewpoints: the JAX lax.map of
    single marches against one batched march; the batch bitwise the port's
    single sweeps, whole or in chunks of one (BATCH_BYTES down)."""
    dem = (np.random.default_rng(0).random((256, 256)).astype(np.float32)
           * 50)
    cos_lat = math.cos(math.radians(LAT))
    views = [(128.0, 128.0, 60.0, cos_lat), (100.3, 150.7, 55.0, cos_lat),
             (40.2, 200.9, 90.0, cos_lat), (128.0, 128.0, 40.0, cos_lat)]
    p = _sweep_params(views)
    kw = dict(width=128, nsteps=256, cells_per_deg=CPD, sampler="window",
              lat_hint_deg=LAT)
    jh = np.asarray(jops.horizon_sweep(jnp.asarray(dem), p, **kw))
    dem_t, pt = torch.from_numpy(dem), tp(p)
    march, batches = tview.march_from_geometry, []

    def counted(dem, params, *a, **k):
        batches.append(params.viewer_cell_i.shape[0])
        return march(dem, params, *a, **k)
    monkeypatch.setattr(tview, "march_from_geometry", counted)
    th = tops.horizon_sweep(dem_t, pt, **kw)
    assert batches == [4] and th.shape == (4, 128)
    valid = jh > -1e30
    np.testing.assert_array_equal(th.numpy() > -1e30, valid)
    np.testing.assert_allclose(th.numpy()[valid], jh[valid], atol=1e-5,
                               rtol=0)
    for v in range(4):
        one = tops.horizon_sweep(dem_t, type(pt)(*(x[v:v + 1] for x in pt)),
                                 **kw)
        assert torch.equal(one[0], th[v])
    monkeypatch.setattr(sharding, "BATCH_BYTES", 1)
    batches.clear()
    assert torch.equal(tops.horizon_sweep(dem_t, pt, **kw), th)
    assert batches == [1, 1, 1, 1]


def test_viewshed_sweep_matches_jax():
    """tests/test_viewshed.py:81's sine ridges, 25 viewpoints in batches of
    8, and an int16 grid (mosaic.grid's dtype); a pack_dem_pairs plane is
    refused as there."""
    from horizonator_tpu.render.raymarch import pack_dem_pairs as jpack
    from horizonator_tpu_torch.render.raymarch import pack_dem_pairs
    n = 256
    jj, ii = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    dem = (100 + 50 * np.sin(ii / 11.0)).astype(np.float32)
    pts = np.stack(np.meshgrid(np.linspace(60, 190, 5),
                               np.linspace(60, 190, 5)), -1).reshape(-1, 2)
    rng = np.random.default_rng(4)
    dem16 = (300 + 50 * rng.random((160, 160))).astype(np.int16)
    for grid, p, kw in (
            (dem, pts, dict(width=64, nsteps=128, zfar=5000.0, batch=8,
                            lat_deg=LAT)),
            (dem16, np.array([[80.0, 80.0], [70.3, 91.4]]),
             dict(width=32, nsteps=64, zfar=4000.0, batch=1))):
        kw.update(cells_per_deg=CPD, sampler="window")
        jh = np.asarray(jops.viewshed_sweep(grid, p, **kw))
        th = tops.viewshed_sweep(grid, p, device="cpu", **kw).numpy()
        assert th.shape == jh.shape == (len(p), kw["width"])
        valid = jh > -1e30
        np.testing.assert_array_equal(th > -1e30, valid)
        np.testing.assert_allclose(th[valid], jh[valid], atol=1e-5, rtol=0)
    assert np.std(th.max(axis=1)) > 0 or len(th) == 2
    packed = pack_dem_pairs(torch.from_numpy(dem16.astype(np.float32)))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jpack(jnp.asarray(dem16, jnp.float32))))
    with pytest.raises(TypeError, match="not a pack_dem_pairs plane"):
        tops.viewshed_sweep(packed, np.array([[80.0, 80.0]]), width=32,
                            nsteps=64, cells_per_deg=CPD, zfar=4000.0,
                            sampler="window", device="cpu")


def test_viewer_elevation_from_pair_planes():
    """The sweeps' observers stand on the bilinear terrain of the 0.5 m
    pair planes, bitwise the JAX package's, not on the float grid."""
    from horizonator_tpu.render.raymarch import _as_packed as j_as_packed
    from horizonator_tpu.render.raymarch import _sample_surface as j_sample
    from horizonator_tpu_torch.render.raymarch import (_as_packed,
                                                       _sample_surface)
    rng = np.random.default_rng(8)
    dem = (300 + 900 * rng.random((97, 97))).astype(np.float32)
    pts = rng.uniform(-2.0, 99.0, (500, 2)).astype(np.float32)
    pts[0] = (40.3, 50.6)
    for surface in ("bilinear", "triangulated"):
        jz = np.asarray(j_sample(*j_as_packed(jnp.asarray(dem)),
                                 jnp.asarray(pts[:, 0]),
                                 jnp.asarray(pts[:, 1]), surface))
        tz = _sample_surface(*_as_packed(torch.from_numpy(dem)),
                             torch.from_numpy(pts[:, 0]),
                             torch.from_numpy(pts[:, 1]), surface)
        np.testing.assert_array_equal(tz.numpy(), jz)
    _, _, vz, *_ = tview._sweep_prep(
        dem, pts[:3], 2.0, nsteps=64, cells_per_deg=CPD, zfar=4000.0,
        cos_viewer_lat=None, lat_deg=LAT, device="cpu")
    i0, j0 = np.floor(pts[0]).astype(int)
    fi, fj = pts[0] - np.floor(pts[0])
    q = np.round(dem[j0:j0 + 2, i0:i0 + 2] * 2.0) / 2.0
    want = ((1 - fj) * ((1 - fi) * q[0, 0] + fi * q[0, 1])
            + fj * ((1 - fi) * q[1, 0] + fi * q[1, 1])) + 2.0
    assert abs(float(vz[0]) - want) < 1e-3


def test_viewshed_count_matches_jax():
    """tests/test_viewshed.py:410's wall scene, 5 observers in batches of 2
    (a short last batch): counts against the JAX package's, and bitwise
    the sum of the port's own rasters."""
    dem = wall_dem(512, 280, 283, 300.0)
    pts = np.array([[246.0, 246.0], [266.0, 266.0], [256.0, 240.0],
                    [250.0, 270.0], [262.0, 254.0]])
    kw = dict(out_center_ij=(256.0, 256.0), out_halfwidth=32,
              viewer_height_m=2.0, width=256, nsteps=256, cells_per_deg=CPD,
              znear=50.0, zfar=6000.0, batch=2, sampler="window")
    jc = np.asarray(jops.viewshed_count(jnp.asarray(dem), pts, **kw))
    tc = tops.viewshed_count(dem, pts, device="cpu", **kw)
    assert tc.dtype == torch.int32 and tc.shape == (64, 64)
    assert (tc.numpy() != jc).mean() <= SHARE
    assert torch.equal(tc, tops.viewshed_count(dem, pts, device="cpu",
                                               plain=True, **kw))
    dem_f, pts_t, vz, nsteps, lat_hint, cos_lat = tview._sweep_prep(
        dem, pts, 2.0, nsteps=256, cells_per_deg=CPD, zfar=6000.0,
        cos_viewer_lat=None, lat_deg=None, device="cpu")
    total = torch.zeros_like(tc)
    for v in range(len(pts)):
        p = tview._observer_params(pts_t[v:v + 1], vz[v:v + 1], cos_lat,
                                   50.0, 6000.0)
        total += tops.viewshed_grid(
            dem_f, type(p)(*(x[0] for x in p)), width=256, nsteps=nsteps,
            cells_per_deg=CPD, sampler="window", lat_hint_deg=lat_hint,
            znear_hint_m=50.0, out_halfwidth=32,
            out_center_ij=(256.0, 256.0), full_circle=True).to(torch.int32)
    assert torch.equal(tc, total)


def test_viewshed_count_single_and_flat():
    """One observer's counts equal its grid (tests/test_viewshed.py:346);
    on a flat plain the counts are the analytic ring sums (:364)."""
    dem = wall_dem(512, 300, 302, 400.0)
    kw = dict(width=256, nsteps=256, cells_per_deg=CPD, sampler="window")
    grid = tops.viewshed_grid(torch.from_numpy(dem),
                              tp(jparams(256.0, 256.0, 2.0, zfar=8000.0)),
                              out_halfwidth=48, **kw).to(torch.int32)
    counts = tops.viewshed_count(dem, np.array([[256.0, 256.0]]),
                                 out_center_ij=(256.0, 256.0),
                                 out_halfwidth=48, znear=50.0, zfar=8000.0,
                                 batch=4, device="cpu", **kw)
    assert torch.equal(counts, grid)
    pts = np.array([[236.0, 246.0], [276.0, 266.0], [256.0, 251.0]])
    hw, c, znear, zfar = 40, (256.0, 256.0), 50.0, 6000.0
    kw["width"] = 512
    counts = tops.viewshed_count(np.zeros((512, 512), np.float32), pts,
                                 out_center_ij=c, out_halfwidth=hw,
                                 znear=znear, zfar=zfar, batch=2,
                                 device="cpu", **kw).numpy()
    ii = c[0] - hw + np.arange(2 * hw) + 0.5
    jj = c[1] - hw + np.arange(2 * hw) + 0.5
    expect = np.zeros((2 * hw, 2 * hw), np.int32)
    for vi, vj in pts:
        d = np.hypot((ii[None, :] - vi) * CELL_M, (jj[:, None] - vj) * CELL_M)
        expect += ((d >= znear) & (d <= zfar)).astype(np.int32)
    assert (counts != expect).mean() < 0.02
    assert counts.max() == 3 and counts.min() >= 0


def test_unported_options_raise():
    """An aligned scene raises rather than silently change what is
    computed, and a mesh= that is none raises (meshes run in a gloo world:
    tests/test_torch_sharding.py); an unknown sampler raises as in the JAX
    package (the oracle samplers run: test_oracle_* below)."""
    dem = torch.zeros((160, 160))
    p = tp(jparams(80.0, 80.0, 2.0, zfar=4000.0))
    kw = dict(width=32, nsteps=64, cells_per_deg=CPD)
    pts = np.array([[80.0, 80.0]])
    for call in (
            lambda: tops.viewshed_polar(dem, p, sampler="window",
                                        aligned_scene=object(), **kw),
            lambda: tops.viewshed_grid(dem, p, out_halfwidth=8,
                                       aligned_scene=object(), **kw)):
        with pytest.raises(NotImplementedError):
            call()
    for call in (
            lambda: tops.viewshed_sweep(dem, pts, sampler="window",
                                        mesh=object(), device="cpu", **kw),
            lambda: tops.viewshed_count(dem, pts, out_center_ij=(80, 80),
                                        out_halfwidth=8, mesh=object(),
                                        device="cpu", **kw)):
        with pytest.raises(ValueError, match="DeviceMesh"):
            call()
    with pytest.raises(ValueError, match="unknown sampler"):
        tops.viewshed_polar(dem, p, sampler="lod", **kw)
    with pytest.raises(ValueError, match="out_halfwidth"):
        tops.viewshed_grid(dem, p, sampler="window", **kw)


# ---- the oracle samplers (the JAX defaults) -------------------------------
# Their marches run on the port's own geometry and sin/cos, so the
# tolerances above hold unchanged: the polar fields' tangents within 1e-5
# (tests/test_torch_step.py and test_torch_crossing_march.py hold the
# marches themselves), rasters within SHARE and only on boundaries, rings
# and ties, guards equal (0: the oracles mask nothing).

ORACLES = ["step", "crossing"]


@pytest.mark.parametrize("sampler", ORACLES)
def test_oracle_polar_matches_jax(sampler):
    """viewshed_polar through each oracle on the smooth terrain, the step
    sampler as the JAX default (no sampler= given): the same valid
    samples, tangents within 1e-5, d of the JAX shape ((K,) for the
    uniform steps) within 1e-6 relative, visibility within SHARE, guard
    0; a batch bitwise its single fields."""
    dem = smooth_dem(200)
    cos_lat = math.cos(math.radians(LAT))
    p = jparams(100.3, 99.6, 1300.0, zfar=7000.0, cos_lat=cos_lat)
    kw = dict(width=96, nsteps=320 if sampler == "step" else 192,
              cells_per_deg=CPD, with_dropped=True)
    if sampler != "step":
        kw["sampler"] = sampler
    jvis, jtan, jd, jaz, jdrop = jops.viewshed_polar(jnp.asarray(dem), p,
                                                     **kw)
    dem_t = torch.from_numpy(dem)
    vis, tan, d, az, drop = tops.viewshed_polar(dem_t, tp(p), **kw)
    jtan = np.asarray(jtan)
    valid = jtan > -1e30
    np.testing.assert_array_equal(tan.numpy() > -1e30, valid)
    np.testing.assert_allclose(tan.numpy()[valid], jtan[valid], atol=1e-5,
                               rtol=0)
    assert d.shape == np.asarray(jd).shape
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
    assert (vis.numpy() != np.asarray(jvis)).mean() <= SHARE
    assert int(drop) == int(jdrop) == 0
    p2 = stack_params([tp(p), tp(jparams(60.2, 140.7, 1200.0, zfar=7000.0,
                                         cos_lat=cos_lat))])
    bvis, btan, bd, _, bdrop = tops.viewshed_polar(dem_t, p2, **kw)
    assert torch.equal(bvis[0], vis) and torch.equal(btan[0], tan)
    assert torch.equal(bd[0], d) and bdrop.tolist() == [0, 0]


# (sampler, method, viewer, window, frame centre, full circle)
ORACLE_RASTERS = [
    (s, m, v, w, c, fc) for s in ORACLES for m in ("gather", "contract")
    for v, w, c, fc in (((150.25, 150.5), None, None, True),
                        ((141.3, 152.6), (100, 300), (150.0, 150.0),
                         False))]


@pytest.mark.parametrize(
    "sampler,method,viewer,window,center,full", ORACLE_RASTERS,
    ids=[f"{r[0]}-{r[1]}-{'full' if r[5] else 'frame'}"
         for r in ORACLE_RASTERS])
def test_oracle_grid_matches_jax(sampler, method, viewer, window, center,
                                 full):
    """viewshed_grid through each oracle with both resamplers, centred on
    a full circle and in a fixed frame on a partial window: rasters within
    SHARE and on boundaries, guards equal, the resampler bitwise
    the direct masked max."""
    cos_lat = math.cos(math.radians(LAT))
    az = {} if window is None else dict(az0=math.radians(window[0]),
                                        az1=math.radians(window[1]))
    p = jparams(*viewer, 1400.0, zfar=8000.0, cos_lat=cos_lat, **az)
    tv, tg = check_grid(smooth_dem(300), p, cos_lat, sampler=sampler,
                        width=256, nsteps=400 if sampler == "step" else 256,
                        out_halfwidth=80, lat_hint_deg=LAT,
                        out_center_ij=center, method=method,
                        full_circle=full)
    assert tg == 0 and tv.any() and not tv.all()


def test_oracle_grid_auto_and_scenes():
    """method="auto" is gather for the step sampler (the JAX default,
    sampler= not given) and contract for the crossing sampler on a float
    grid; a CrossingScene and a pack_dem_pairs plane resample with gather
    and equal the float grid's gather rasters bitwise; the contract refuses
    them."""
    from horizonator_tpu_torch.render.crossing import pack_scene
    from horizonator_tpu_torch.render.raymarch import pack_dem_pairs
    cos_lat = math.cos(math.radians(LAT))
    dem = smooth_dem(300)
    dem_t = torch.from_numpy(dem)
    p = jparams(150.25, 150.5, 1400.0, zfar=8000.0, cos_lat=cos_lat)
    kw = dict(width=256, nsteps=256, cells_per_deg=CPD, out_halfwidth=80)
    step = tops.viewshed_grid(dem_t, tp(p), **kw)
    assert torch.equal(step, tops.viewshed_grid(dem_t, tp(p), method="gather",
                                                sampler="step", **kw))
    assert_raster_close(jops.viewshed_grid(jnp.asarray(dem), p, **kw), step,
                        dem, p, dict(kw, sampler="step"), cos_lat)
    cross = tops.viewshed_grid(dem_t, tp(p), sampler="crossing", **kw)
    assert torch.equal(cross, tops.viewshed_grid(
        dem_t, tp(p), sampler="crossing", method="contract", **kw))
    for scene, sampler in ((pack_scene(dem_t), "crossing"),
                           (pack_dem_pairs(dem_t), "step")):
        assert torch.equal(
            tops.viewshed_grid(scene, tp(p), sampler=sampler, **kw),
            tops.viewshed_grid(dem_t, tp(p), sampler=sampler,
                               method="gather", **kw))
        with pytest.raises(TypeError, match="raw 2D elevation grid"):
            tops.viewshed_grid(scene, tp(p), sampler=sampler,
                               method="contract", **kw)


@pytest.mark.parametrize("sampler", ORACLES)
def test_oracle_sweeps_match_jax(sampler, monkeypatch):
    """viewshed_sweep (crossing: the JAX default) and horizon_sweep through
    each oracle on the sine ridges: horizons within 1e-5 of the JAX
    package's with the same valid columns, the batch bitwise its single
    sweeps and its chunks of one (BATCH_BYTES down)."""
    n = 256
    jj, ii = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    dem = (100 + 50 * np.sin(ii / 11.0) + 30 * np.cos(jj / 7.0)).astype(
        np.float32)
    pts = np.stack(np.meshgrid(np.linspace(60, 190, 3),
                               np.linspace(60, 190, 3)), -1).reshape(-1, 2)
    kw = dict(width=64, zfar=5000.0, batch=4, lat_deg=LAT,
              cells_per_deg=CPD)
    if sampler == "step":
        kw.update(sampler="step", nsteps=256)
    jh = np.asarray(jops.viewshed_sweep(dem, pts, **kw))
    th = tops.viewshed_sweep(dem, pts, device="cpu", **kw)
    valid = jh > -1e30
    np.testing.assert_array_equal(th.numpy() > -1e30, valid)
    np.testing.assert_allclose(th.numpy()[valid], jh[valid], atol=1e-5,
                               rtol=0)
    assert np.std(jh.max(axis=1)) > 0
    dem_t = torch.from_numpy(dem)
    cos_lat = math.cos(math.radians(LAT))
    views = [(80.0, 90.0, 180.0, cos_lat), (150.3, 120.7, 160.0, cos_lat),
             (40.2, 200.9, 200.0, cos_lat)]
    p = tp(_sweep_params(views))
    hkw = dict(width=64, nsteps=256 if sampler == "step" else 192,
               cells_per_deg=CPD, sampler=sampler)
    whole = tops.horizon_sweep(dem_t, p, **hkw)
    for v in range(3):
        one = tops.horizon_sweep(dem_t, type(p)(*(x[v:v + 1] for x in p)),
                                 **hkw)
        assert torch.equal(one[0], whole[v])
    monkeypatch.setattr(sharding, "BATCH_BYTES", 1)
    assert torch.equal(tops.horizon_sweep(dem_t, p, **hkw), whole)


@pytest.mark.parametrize("sampler", ORACLES)
def test_oracle_count_matches_jax(sampler):
    """viewshed_count through each oracle (the gather resampler on the
    packed scenes, as in the JAX package) on the wall scene: counts within
    SHARE of the JAX package's, and bitwise the sum of the port's own
    single rasters on the same scene."""
    dem = wall_dem(512, 280, 283, 300.0)
    pts = np.array([[246.0, 246.0], [266.0, 266.0], [256.0, 240.0]])
    kw = dict(out_center_ij=(256.0, 256.0), out_halfwidth=32,
              viewer_height_m=2.0, width=256, nsteps=256, cells_per_deg=CPD,
              znear=50.0, zfar=6000.0, batch=2, sampler=sampler)
    jc = np.asarray(jops.viewshed_count(jnp.asarray(dem), pts, **kw))
    tc = tops.viewshed_count(dem, pts, device="cpu", **kw)
    assert tc.dtype == torch.int32 and tc.shape == (64, 64)
    assert (tc.numpy() != jc).mean() <= SHARE and tc.max() >= 2
    scene, pts_t, vz, nsteps, lat_hint, cos_lat = tview._sweep_prep(
        dem, pts, 2.0, nsteps=256, cells_per_deg=CPD, zfar=6000.0,
        cos_viewer_lat=None, lat_deg=None, device="cpu", sampler=sampler)
    total = torch.zeros_like(tc)
    for v in range(len(pts)):
        p = tview._observer_params(pts_t[v:v + 1], vz[v:v + 1], cos_lat,
                                   50.0, 6000.0)
        total += tops.viewshed_grid(
            scene, type(p)(*(x[0] for x in p)), width=256, nsteps=nsteps,
            cells_per_deg=CPD, sampler=sampler, lat_hint_deg=lat_hint,
            out_halfwidth=32, out_center_ij=(256.0, 256.0),
            full_circle=True).to(torch.int32)
    assert torch.equal(tc, total)


def test_rectangular_grid_matches_jax():
    """A window march takes a rectangular grid, as the JAX package's does:
    horizon_sweep and the gather raster over a (200, 256) grid
    against the JAX package's, at test_horizon_sweep_matches_jax_and_
    singles' tolerance and SHARE; the sweeps, whose viewer elevations the
    JAX package reads with the row count as the pair plane's stride
    (viewshed.py:1007-1009), refuse a rectangular grid."""
    dem = smooth_dem(256)[:200]
    cos_lat = math.cos(math.radians(LAT))
    p = _sweep_params([(128.0, 100.0, 700.0, cos_lat),
                       (60.3, 150.7, 800.0, cos_lat)])
    kw = dict(width=128, nsteps=256, cells_per_deg=CPD, sampler="window",
              lat_hint_deg=LAT)
    jh = np.asarray(jops.horizon_sweep(jnp.asarray(dem), p, **kw))
    th = tops.horizon_sweep(torch.from_numpy(dem), tp(p), **kw).numpy()
    valid = jh > -1e30
    assert valid.mean() > 0.5
    np.testing.assert_array_equal(th > -1e30, valid)
    np.testing.assert_allclose(th[valid], jh[valid], atol=1e-5, rtol=0)
    jp = jparams(128.0, 100.0, float(dem[100:102, 128:130].max()) + 2.0,
                 zfar=6000.0, cos_lat=cos_lat)
    gkw = dict(kw, out_halfwidth=40, method="gather")
    jv = np.asarray(jops.viewshed_grid(jnp.asarray(dem), jp, **gkw))
    tv = tops.viewshed_grid(torch.from_numpy(dem), tp(jp), **gkw).numpy()
    assert tv.shape == jv.shape == (80, 80) and 0.05 < jv.mean() < 0.95
    assert (tv != jv).mean() <= SHARE
    with pytest.raises(ValueError, match="square grid"):
        tops.viewshed_sweep(dem, np.array([[128.0, 100.0]]), width=32,
                            nsteps=64, cells_per_deg=CPD, zfar=4000.0,
                            sampler="window", device="cpu")
