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
  at invalid samples included (test_torch_textured's tolerance for them);
  the band edge shapes (bands with no valid sample, of one valid row, with
  one valid sample, edges inside a tile, the viewer on either side of the
  band, a batch with a band each) likewise, the near band as above, and
  the bands' MAX bitwise the square march where they cover the grid.
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
from horizonator_tpu_torch.parallel.regions import band_bounds
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


@functools.partial(jax.jit, static_argnames=("width", "k"))
def _jax_band(dem, p, j_hi, j_off, planes, width, k):
    out = j_march(dem, p, width=width, k_cross=k, cells_per_deg=CPD,
                  lat_hint_deg=34.0, j_hi=j_hi, j_offset=j_off,
                  color_planes=planes)
    return out[0], out[2].dropped, out[2].truncated, (
        out[4] if planes is not None else None)


def _band_planes(jcp, tcp, s, j_off, nj, n):
    """(JAX, port) colour planes of the band of rows [j_off, j_off + nj)
    and n columns, cut from the whole grid's: packed cell planes (s 1) or
    the band-local half-cell views (s 2, regions.py:112-131)."""
    if s == 1:
        band = tcp[j_off:j_off + nj, :n].contiguous()
        return jnp.asarray(band.numpy()), band
    ns = jcp.ns.T[j_off:j_off + nj, :2 * n].T
    ew = jcp.ew[2 * j_off:2 * (j_off + nj), :n]
    fp = jcp.full_packed[2 * j_off:2 * (j_off + nj), :2 * n]
    jband = jtex.ColorPlanes2x(ns=ns, ns_rev=ns[:, ::-1], ew=ew,
                               ew_rev=ew[:, ::-1], full_packed=fp)
    return jband, ttex.ColorPlanes2x(torch.from_numpy(np.array(fp)))


BAND_EDGE_CASES = [
    # (id, n, vi, vj, az0, az1, width, k, znear, zfar, bands, s, what):
    # chip_smoke.py's band_edge_cases(), at which it holds the banded CUDA
    # entries to this plain version. bands: ("R", r), r bands of ceil(n/r)
    # rows + halo over the grid zero-padded to r bands (masked through
    # band_bounds' n_valid), or explicit (j_off, nj, j_hi) bands; s: 0
    # untextured, 1 packed cell planes, 2 half-cell planes; what: "split"
    # (a 32 x 64 tile live in two bands), "empty" (a band without a valid
    # sample), "row" (bands of one valid row), "one" (exactly one valid
    # sample), "inside" / "first" / "last" / "north" / "south" (the
    # viewer's row against the band), "j_dom" / "i_dom"
    ("R3-100-rows", 100, 50.2, 49.7, -180.0, 180.0, 37, 129, 100.0, 8000.0,
     ("R", 3), 1, "split"),
    ("R8-100-rows", 100, 50.2, 49.7, -180.0, 180.0, 61, 129, 100.0, 8000.0,
     ("R", 8), 2, "split"),
    ("beyond-zfar", 160, 80.3, 20.6, -180.0, 180.0, 64, 128, 100.0, 3000.0,
     ("R", 4), 0, "empty"),
    ("padding-alone", 100, 50.2, 49.7, -180.0, 180.0, 40, 132, 100.0,
     8000.0, [(40, 21, -1.0), (94, 8, -1.0)], 2, "empty"),
    ("one-valid-row", 100, 50.2, 49.7, -180.0, 180.0, 64, 129, 100.0,
     8000.0, [(45, 2, 0.0), (57, 2, 0.0)], 1, "row"),
    ("one-valid-sample", 100, 50.2, 49.7, 10.0, 11.0, 1, 129, 100.0, 8000.0,
     [(60, 2, 0.0)], 0, "one"),
    ("viewer-inside", 120, 60.3, 60.4, -180.0, 180.0, 40, 132, 100.0,
     8000.0, [(40, 41, 40.0)], 2, "inside"),
    ("viewer-on-first-row", 120, 60.3, 40.0, -180.0, 180.0, 40, 129, 100.0,
     8000.0, [(40, 41, 40.0)], 1, "first"),
    ("viewer-on-last-row", 120, 60.3, 80.0, -180.0, 180.0, 40, 129, 100.0,
     8000.0, [(40, 41, 40.0)], 0, "last"),
    ("viewer-north", 120, 60.3, 101.7, -180.0, 180.0, 40, 129, 100.0,
     8000.0, [(40, 41, 40.0)], 2, "north"),
    ("viewer-south", 120, 60.3, 15.2, -180.0, 180.0, 40, 129, 100.0, 8000.0,
     [(40, 41, 40.0)], 1, "south"),
    ("row-dominant", 100, 50.2, 49.7, -10.0, 10.0, 64, 65, 100.0, 8000.0,
     ("R", 4), 2, "j_dom"),
    ("column-dominant", 100, 50.2, 49.7, 80.0, 100.0, 64, 65, 100.0, 8000.0,
     ("R", 4), 1, "i_dom"),
]


def _tiles_live(valid):
    """(n_col_tiles, n_step_tiles) of the CUDA kernel's 32 x 64 tiles that
    hold a valid sample."""
    w, k = valid.shape
    v = np.pad(valid, ((0, -w % 32), (0, -k % 64)))
    return v.reshape(v.shape[0] // 32, 32, v.shape[1] // 64, 64).any((1, 3))


@pytest.mark.parametrize("n,vi,vj,az0,az1,width,k,znear,zfar,bands,s,what",
                         [c[1:] for c in BAND_EDGE_CASES],
                         ids=[c[0] for c in BAND_EDGE_CASES])
def test_band_edge_shapes(n, vi, vj, az0, az1, width, k, znear, zfar, bands,
                          s, what):
    """The banded plain march against the JAX banded march at the band
    shapes on which the CUDA kernel's tile vote can go wrong; where the
    bands cover the grid, their MAX is the port's square march."""
    covers = bands[0] == "R"
    if covers:
        nb = -(-n // bands[1])
        bands = [(j, nb + 1, jh) for j, jh in (
            band_bounds(i, bands[1], nb, n) for i in range(bands[1]))]
    rows = max(n, max(j + nj for j, nj, _ in bands))
    dem = make_dem(n)
    grid = np.pad(dem, ((0, rows - n), (0, 0)))
    jp = jax_params(vi, vj, viewer_z(dem, min(vi, n - 2), min(vj, n - 2)),
                    az0=az0, az1=az1, zfar=zfar, znear=znear, curv=6.8e-8)
    geo = geo_to_torch(_jax_geometry(jp, width))
    tp, q = params_from_jax(jp, "cpu"), twin.N_NEAR
    jcp = tcp = None
    if s:
        # square planes over the padded grid; each band cuts its rows
        c = np.random.default_rng(n + k).integers(
            0, 256, (3, s * rows, s * rows)).astype(np.float32)
        jcp = (jtex.prepare_color_planes(jnp.asarray(c)) if s == 2
               else jtex.pack_cell_colors(jnp.asarray(c)))
        tcp = ttex.scene_from_jax(jcp, device="cpu")[0]
    valids, parts = [], []
    for j_off, nj, j_hi in bands:
        local = grid[j_off:j_off + nj]
        jb, tb = (_band_planes(jcp, tcp, s, j_off, nj, n) if s
                  else (None, None))
        jt, jdrop, jtr, jx = _jax_band(jnp.asarray(local), jp,
                                       jnp.float32(j_hi), jnp.int32(j_off),
                                       jb, width, k)
        out = twin.march_from_geometry(
            torch.from_numpy(local), tp, geo, k_cross=k, cells_per_deg=CPD,
            lat_hint_deg=34.0, j_hi=j_hi, j_offset=j_off, color_planes=tb)
        tt, dists, jt = out[0].numpy(), out[1], np.asarray(jt)
        assert int(jdrop) == 0 and int(dists.dropped) == 0
        assert int(dists.truncated) == int(jtr)
        assert tt.shape == jt.shape == (width, q + twin.step_budget(k, n))
        np.testing.assert_array_equal(tt[:, q:], jt[:, q:])   # far field
        _near_band_close(tt[:, :q], jt[:, :q], min_bitwise=0.95)
        if s:
            tx, jx = out[2].numpy(), np.asarray(jx)
            np.testing.assert_array_equal(tx[:, q:], jx[:, q:])
            assert (tx[:, q:][tt[:, q:] <= NEG] == 0).all()
        valids.append(tt[:, q:] > NEG)
        parts.append(tt)
    jd, (j_off, _, j_hi) = geo.j_dom.numpy(), bands[0]
    live = [_tiles_live(v) for v in valids]
    holds = {
        "split": all(v.any() for v in valids)
        and bool((np.sum(live, axis=0) >= 2).any()),
        "empty": any(not v.any() for v in valids),
        "row": all(v.any() for v in valids),
        "one": int(valids[0].sum()) == 1,
        "inside": j_off < vj < j_off + j_hi, "first": vj == j_off,
        "last": vj == j_off + j_hi, "north": vj > j_off + j_hi,
        "south": vj < j_off, "j_dom": bool(jd.all()),
        "i_dom": not jd.any()}
    assert holds[what]
    if what in ("inside", "first", "last", "north", "south"):
        assert valids[0].any()
    if covers:
        # the bands cover the grid: their MAX is the square march, bitwise
        sq = twin.march_from_geometry(
            torch.from_numpy(dem), tp, geo, k_cross=k, cells_per_deg=CPD,
            lat_hint_deg=34.0)[0].numpy()
        np.testing.assert_array_equal(np.max(parts, axis=0), sq)


def test_band_edge_batch():
    """A batch of 3 viewpoints, each with a (nj, ni) band of its own grid
    and its own packed colour band (the card's B 3 band case): the port's
    batched banded march against the JAX banded march of each viewpoint."""
    b, n, w, k, (j_off, nj, j_hi) = 3, 100, 37, 129, (30, 31, 30.0)
    i = np.arange(b)
    dems = np.stack([make_dem(n, seed=5 + v) for v in range(b)])
    bands = np.ascontiguousarray(dems[:, j_off:j_off + nj])
    rng = np.random.default_rng(3)
    cols = rng.integers(0, 256, (b, 3, nj, n)).astype(np.float32)
    vis, vjs = 40.3 + 9.1 * i, 28.6 + 21.3 * i
    jps = [jax_params(vis[v], vjs[v], viewer_z(dems[v], vis[v], vjs[v]),
                      az0=-180.0 + 23.0 * v, az1=150.0 - 31.0 * v,
                      znear=(10.0, 100.0, 50.0)[v],
                      zfar=(8000.0, 2500.0, 20000.0)[v],
                      curv=(0.0, 6.8e-8, 6.8e-8)[v]) for v in range(b)]
    jplanes = [jtex.pack_cell_colors(jnp.asarray(cols[v])) for v in range(b)]
    geos = [geo_to_torch(_jax_geometry(jp, w)) for jp in jps]
    # per viewpoint fields stacked; the north cell size is one constant
    geo = type(geos[0])(*(xs[0] if f == "cell_m_north" else torch.stack(xs)
                          for f, xs in zip(geos[0]._fields, zip(*geos))))
    tp = params_from_jax(jax.tree.map(lambda *x: jnp.stack(x), *jps), "cpu")
    tt, dists, tx = twin.march_from_geometry(
        torch.from_numpy(bands), tp, geo, k_cross=k, cells_per_deg=CPD,
        lat_hint_deg=34.0, j_hi=j_hi, j_offset=j_off,
        color_planes=torch.from_numpy(np.stack(
            [np.asarray(x) for x in jplanes])))
    q = twin.N_NEAR
    for v in range(b):
        jt, jdrop, jtr, jx = _jax_band(
            jnp.asarray(bands[v]), jps[v], jnp.float32(j_hi),
            jnp.int32(j_off), jplanes[v], w, k)
        jt, jx = np.asarray(jt), np.asarray(jx)
        assert int(jdrop) == 0 and int(dists.dropped[v]) == 0
        assert int(dists.truncated[v]) == int(jtr)
        np.testing.assert_array_equal(tt[v, :, q:].numpy(), jt[:, q:])
        np.testing.assert_array_equal(tx[v, :, q:].numpy(), jx[:, q:])
        _near_band_close(tt[v, :, :q].numpy(), jt[:, :q], min_bitwise=0.95)
        assert (jt[:, q:] > NEG).any()


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
