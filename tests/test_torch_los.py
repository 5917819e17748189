"""Port parity for line of sight: ops/los (sightline, intervisible,
intervisibility_matrix), the API's intervisible / sightline /
visible_peaks, geojson's points_geojson / line_geojson and the CLI's
--pois-out, against horizonator_tpu on the same inputs.

Tolerances, and why:
- ``sightline``: every field bitwise. The JAX package calls it eagerly, one
  rounding per operation and true divisions, which the port repeats (its
  division by K + 1 goes through a device tensor, since CUDA multiplies by
  the reciprocal of a host scalar divisor);
- ``intervisible`` and ``intervisibility_matrix``: the JAX package jits
  them, and XLA may fuse a product into an add there, so a pair may flip
  only where the minimum clearance of the JAX package's (eager) profile
  lies within 8 ulp of its largest height of 0 (measured: no flips);
- the port's answers are bitwise the same in any chunk of pairs (the
  budget ``ops.los.LOS_BYTES`` monkeypatched down to a few pairs);
- ``visible_peaks``: the same dicts (its geometry is float64 host math);
- the GeoJSON text and the CLI's --pois-out file: byte for byte.
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizonator_tpu import geojson as jgj
from horizonator_tpu import horizonator as JHorizonator
from horizonator_tpu.ops import los as jlos
from horizonator_tpu_torch import geojson as tgj
from horizonator_tpu_torch import horizonator as THorizonator
from horizonator_tpu_torch.ops import los as tlos
from tests.conftest import make_synthetic_dem_dir
from tests.test_torch_cli import POIS, RENDER, _run_both
from tests.test_torch_cli import dem_dir as cli_dem_dir  # noqa: F401

CPD = 1200
KW = dict(cells_per_deg=CPD, cos_lat=math.cos(math.radians(34.0)))


def _terrain(n=128, seed=3):
    """tests/test_los.py's symmetry terrain, smoothed so that a fair share
    of pairs see each other."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 4 * np.pi, n)
    z = (300 * np.abs(np.sin(x[None, :]) * np.cos(0.7 * x[:, None]))
         + 10 * rng.standard_normal((n, n))).astype(np.float32)
    return np.maximum(z, 0)


def _pairs(n, k, seed, lo=4.0, hi=None):
    rng = np.random.default_rng(seed)
    hi = n - 5.0 if hi is None else hi
    return (rng.uniform(lo, hi, (k, 2)).astype(np.float32),
            rng.uniform(lo, hi, (k, 2)).astype(np.float32))


def _flips_ok(vis_j, vis_t, prof_j, z):
    """Pairs may differ only where the JAX profile's minimum clearance is
    within 8 ulp of the largest height of 0."""
    eps = 8 * float(np.spacing(np.float32(np.abs(z).max() + 1000.0)))
    min_clear = np.asarray(prof_j.clearance).min(-1)
    flip = np.asarray(vis_j) != np.asarray(vis_t)
    assert (np.abs(min_clear[flip]) <= eps).all()


@pytest.mark.parametrize("curvature", ["none", "spherical", "refracted"])
@pytest.mark.parametrize("case", ["in_grid", "out_of_grid", "elevations",
                                  "triangulated", "packed"])
def test_sightline_matches_jax(case, curvature):
    z = _terrain()
    a, b = _pairs(128, 48, 11, *((-12.0, 140.0) if case == "out_of_grid"
                                 else ()))
    kw = dict(KW, nsteps=200, observer_height_m=30.0, target_height_m=5.0,
              curvature=curvature)
    if case == "elevations":
        ele = np.random.default_rng(2).uniform(0, 600, 48).astype(np.float32)
        kw.update(ele_a=ele, ele_b=ele[::-1].copy())
    if case == "triangulated":
        kw["surface"] = "triangulated"
    dj, dt = jnp.asarray(z), torch.from_numpy(z)
    if case == "packed":
        from horizonator_tpu.render.raymarch import pack_dem_pairs as jpack
        from horizonator_tpu_torch.render.raymarch import (pack_dem_pairs
                                                           as tpack)
        dj, dt = jpack(dj), tpack(dt)
    pj = jlos.sightline(dj, a, b, **kw)
    pt = tlos.sightline(dt, a, b, **kw)
    assert isinstance(pt, tlos.Sightline)
    for f in tlos.Sightline._fields:
        x, y = np.asarray(getattr(pj, f)), getattr(pt, f).numpy()
        assert x.shape == y.shape and x.dtype == y.dtype, f
        np.testing.assert_array_equal(y, x, err_msg=f)
    vis = pt.visible.numpy()
    assert 0 < vis.sum() < len(vis) or case == "out_of_grid"
    if case == "out_of_grid":
        outside = ((a < 0) | (a > 127) | (b < 0) | (b > 127)).any(-1)
        assert outside.any() and not vis[outside].any()


@pytest.mark.parametrize("curvature", ["none", "spherical", "refracted"])
def test_intervisible_matches_jax(curvature):
    z = _terrain()
    a, b = _pairs(128, 200, 5, -8.0, 136.0)
    kw = dict(KW, nsteps=256, observer_height_m=60.0, target_height_m=20.0,
              curvature=curvature)
    vj = np.asarray(jlos.intervisible(jnp.asarray(z), a, b, **kw))
    vt = tlos.intervisible(torch.from_numpy(z), a, b, **kw)
    assert vt.dtype == torch.bool and vt.shape == (200,)
    _flips_ok(vj, vt.numpy(), jlos.sightline(jnp.asarray(z), a, b, **kw), z)
    assert 10 < vt.sum() < 190


def test_intervisible_broadcasts():
    """tests/test_los.py:61 on the port: (4, 1) x (1, 5) pairs."""
    dem = torch.zeros(256, 256)
    a = np.zeros((4, 1, 2)) + np.array([128.0, 64.0])
    b = np.zeros((1, 5, 2)) + np.array([128.0, 192.0])
    vis = tlos.intervisible(dem, a, b, nsteps=128, **KW)
    assert vis.shape == (4, 5) and bool(vis.all())
    assert not bool(tlos.intervisible(torch.zeros(64, 64), [10.0, 10.0],
                                      [70.0, 10.0], **KW))


@pytest.mark.parametrize("nsteps", [None, 192])
def test_intervisibility_matrix_matches_jax(nsteps):
    z = _terrain(160, 4)
    pts = np.random.default_rng(8).uniform(4, 155, (24, 2)).astype(
        np.float32)
    kw = dict(KW, nsteps=nsteps, observer_height_m=15.0)
    mj = np.asarray(jlos.intervisibility_matrix(jnp.asarray(z), pts, **kw))
    mt = tlos.intervisibility_matrix(torch.from_numpy(z), pts, **kw)
    assert mt.shape == (24, 24) and mt.dtype == torch.bool
    mt = mt.numpy()
    assert mt.diagonal().all() and (mt == mt.T).all()
    k = tlos.auto_nsteps(pts) if nsteps is None else nsteps
    prof = jlos.sightline(jnp.asarray(z), pts[:, None, :], pts[None, :, :],
                          nsteps=k, **{**KW, "observer_height_m": 15.0,
                                       "target_height_m": 15.0})
    _flips_ok(mj & ~np.eye(24, dtype=bool), mt & ~np.eye(24, dtype=bool),
              prof, z)
    assert 0.1 < mt.mean() < 0.9


def test_intervisible_chunks_bitwise(monkeypatch):
    """Each pair's answer is the same in any chunk: the budget cut to 3
    pairs a chunk (and to 1) against one chunk and against sightline."""
    z = torch.from_numpy(_terrain())
    a, b = _pairs(128, 37, 9, -6.0, 134.0)
    kw = dict(KW, nsteps=160, observer_height_m=25.0, curvature="refracted",
              ele_b=np.linspace(0, 400, 37, dtype=np.float32))
    whole = tlos.intervisible(z, a, b, **kw)
    np.testing.assert_array_equal(whole, tlos.sightline(z, a, b,
                                                        **kw).visible)
    for pairs in (3, 1):
        monkeypatch.setattr(tlos, "LOS_BYTES",
                            pairs * 160 * tlos.LOS_SAMPLE_BYTES)
        np.testing.assert_array_equal(tlos.intervisible(z, a, b, **kw),
                                      whole)
    pts = np.concatenate([a, b])
    m3 = tlos.intervisibility_matrix(z, pts, **KW)
    monkeypatch.setattr(tlos, "LOS_BYTES", 10 ** 12)
    np.testing.assert_array_equal(tlos.intervisibility_matrix(z, pts, **KW),
                                  m3)


# -- the API, geojson and the CLI ---------------------------------------------

def _one_peak(lat, lon):
    """tests/test_los.py:144: one 2500 m peak on the -117.45 meridian."""
    z = 200 + 0 * lat
    return z + 2500 * np.exp(-((lat - 34.55) ** 2 + (lon + 117.45) ** 2)
                             / (2 * 0.02 ** 2))


@pytest.fixture(scope="module")
def api_scenes(tmp_path_factory):
    d = make_synthetic_dem_dir(tmp_path_factory.mktemp("torch_los"),
                               {(34, -118): _one_peak})
    kw = dict(dir_dems=d, render_radius_m=30000.0)
    return (JHorizonator(34.40, -117.45, 256, 96, **kw),
            THorizonator(34.40, -117.45, 256, 96, device="cpu", **kw))


def test_api_intervisible_matches_jax(api_scenes):
    hj, ht = api_scenes
    # tests/test_los.py:156: the peak blocks the meridian, not 0.15 deg east
    assert not ht.intervisible(34.40, -117.45, 34.70, -117.45)
    assert ht.intervisible(34.40, -117.30, 34.70, -117.30)
    lons = np.array([-117.45, -117.30, -117.40, -117.6, -118.5])
    for kw in ({}, {"curvature": "spherical", "observer_height_m": 50.0},
               {"nsteps": 256, "target_height_m": 300.0}):
        vt = ht.intervisible(34.40, lons, 34.70, lons, **kw)
        vj = hj.intervisible(34.40, lons, 34.70, lons, **kw)
        assert isinstance(vt, np.ndarray) and vt.dtype == bool
        np.testing.assert_array_equal(vt, vj)
    assert not ht.intervisible(34.40, -117.45, 34.70, -118.5)  # off-mosaic


def test_api_sightline_matches_jax(api_scenes):
    hj, ht = api_scenes
    pj = hj.sightline(34.40, -117.45, 34.70, -117.45)
    pt = ht.sightline(34.40, -117.45, 34.70, -117.45)
    for f in pt._fields:
        x, y = getattr(pj, f), getattr(pt, f)
        assert isinstance(y, np.ndarray)
        np.testing.assert_array_equal(y, x, err_msg=f)
    assert not bool(pt.visible)
    d_peak = 0.15 * 6371000.0 * math.pi / 180.0      # tests/test_los.py:168
    assert abs(float(pt.block_d) - d_peak) < 3000.0
    assert float(pt.z.max()) > 1500.0


def test_api_visible_peaks_matches_jax(api_scenes, tmp_path):
    hj, ht = api_scenes
    rng = np.random.default_rng(4)
    pois = [{"name": f"p{k}", "lat": float(34.40 + rng.uniform(-0.2, 0.3)),
             "lon": float(-117.45 + rng.uniform(-0.25, 0.25)),
             "ele_m": float(rng.uniform(200, 2700))} for k in range(40)]
    pois.append({"name": "The Peak", "lat": 34.55, "lon": -117.45,
                 "ele": 2700.0})
    path = tmp_path / "pois.json"
    path.write_text(json.dumps(pois))
    for arg, kw in ((pois, {}), (str(path), {"curvature": "refracted",
                                             "observer_height_m": 40.0,
                                             "target_height_m": 10.0})):
        rt = ht.visible_peaks(arg, **kw)
        assert rt == hj.visible_peaks(arg, **kw)
        assert 0 < sum(p["visible"] for p in rt) < len(rt)
    assert rt[-1]["name"] == "The Peak" and rt[-1]["ele_m"] == 2700.0
    assert ht.visible_peaks([]) == []


@pytest.mark.parametrize("props", [None, {"kind": "x"}, "list"])
def test_geojson_points_and_lines_match_jax(props):
    rng = np.random.default_rng(6)
    lat = 34.0 + rng.uniform(0, 1, 7)
    lon = -118.0 + rng.uniform(0, 1, 7)
    pp = ([{"k": k, "v": float(lat[k])} for k in range(7)]
          if props == "list" else props)
    assert (tgj.points_geojson(lat, lon, properties=pp)
            == jgj.points_geojson(lat, lon, properties=pp))
    lat2, lon2 = lat.reshape(1, 7).repeat(3, 0), lon.reshape(1, 7).repeat(3, 0)
    lp = pp[:3] if props == "list" else pp
    assert (tgj.line_geojson(lat2, lon2, properties=lp)
            == jgj.line_geojson(lat2, lon2, properties=lp))
    assert tgj.line_geojson(lat, lon) == jgj.line_geojson(lat, lon)
    with pytest.raises(ValueError):
        tgj.points_geojson(lat, lon[:3])


@pytest.mark.parametrize("mode", ["image", "standalone"])
def test_cli_pois_out_matches_jax(cli_dem_dir, tmp_path, mode):  # noqa: F811
    pois = tmp_path / "pois.json"
    pois.write_text(json.dumps(POIS + [
        {"name": "Hidden", "lat": 34.60, "lon": -117.45, "ele_m": 300},
        {"name": "Plain", "lat": 34.35, "lon": -117.50, "ele_m": 200},
        {"name": "Far", "lat": 34.9, "lon": -117.0, "ele_m": 500}]))
    argv = ["--width", "300", "--dirdems", str(cli_dem_dir), *RENDER,
            "--pois", str(pois), "--pois-out", "{out}"]
    if mode == "image":
        argv += ["--height", "100", "--image", "{out}.png"]
    res = _run_both(tmp_path, "peaks.geojson",
                    argv + ["34.40", "-117.45", "0", "60"])
    (rj, dj, _), (rt, dt, _) = res["jax"], res["torch"]
    assert rj == rt == 0
    text = (dt / "peaks.geojson").read_text()
    assert text == (dj / "peaks.geojson").read_text()
    feats = json.loads(text)["features"]
    assert [f["properties"]["name"] for f in feats][:2] == ["Big Peak",
                                                             "Round Top"]
    assert {f["properties"]["visible"] for f in feats} == {True, False}
    assert (dt / "peaks.geojson.png").exists() == (mode == "image")
