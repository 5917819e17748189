"""Port parity for the skyline slice: api.skyline, geojson, the CLI's
--horizon-out (with and without --image) and render(debug_fill=), against
horizonator_tpu on the same inputs.

The scene is tests/test_skyline.py's: a Gaussian ridge wall due north of
the viewer with a known crest. Tolerances, and why:
- skyline: ``az_deg`` within 1e-5 deg (the azimuths differ by at most an
  ulp of their float32 radians, measured 3.4e-6 deg); ``el_deg`` within
  1e-4 deg (the march's near band and the arctan differ by ulps, measured
  2.0e-6); the argmax lands on the same sample, read as ``dist_m`` within
  1e-4 relative, at >= 99.5% of columns (measured 100%, 1.4e-7), and there
  ``lat`` / ``lon`` within 1e-6 deg (measured bitwise);
- geojson: the same text for the same dict (a host copy of the module);
- the CLI's files: the skyline's tolerances plus their printed rounding
  (az / el to 1e-4 deg, dist to 0.1 m, lat / lon to 1e-7 deg);
- debug_fill: test_torch_textured's ``_compare_textured``.
"""

import csv
import io
import json

import numpy as np
import pytest

from horizonator_tpu import geojson as jgj
from horizonator_tpu import horizonator as JHorizonator
from horizonator_tpu_torch import geojson as tgj
from horizonator_tpu_torch import horizonator as THorizonator
from tests.conftest import make_synthetic_dem_dir
from tests.test_skyline import (D_CREST, M_PER_DEG, VLAT, VLON, _oracle_max_el,
                                _wall)
from tests.test_torch_cli import _run_both
from tests.test_torch_render import VIEW
from tests.test_torch_render import dem_dir as render_dem_dir  # noqa: F401
from tests.test_torch_textured import _compare_textured


@pytest.fixture(scope="module")
def wall_dir(tmp_path_factory):
    return make_synthetic_dem_dir(tmp_path_factory.mktemp("torch_skyline"),
                                  {(34, -118): _wall})


@pytest.fixture(scope="module")
def apis(wall_dir):
    kw = dict(dir_dems=wall_dir, render_radius_m=35000.0)
    return (JHorizonator(VLAT, VLON, 96, 48, **kw),
            THorizonator(VLAT, VLON, 96, 48, device="cpu", **kw))


def _same_sample(sj, st):
    """Columns whose argmax landed on the same sample (by its distance)."""
    return np.abs(st["dist_m"] - sj["dist_m"]) <= 1e-4 * sj["dist_m"]


@pytest.mark.parametrize("az0,az1,width", [(-20.0, 20.0, 81),
                                           (-180.0, 180.0, 256),
                                           (100.0, 300.0, 96)])
def test_skyline_matches_jax(apis, az0, az1, width):
    hj, ht = apis
    sj = hj.skyline(az0, az1, width=width)
    st = ht.skyline(az0, az1, width=width)
    assert set(st) == {"az_deg", "el_deg", "dist_m", "lat", "lon"}
    for k, v in st.items():
        assert v.shape == (width,) and v.dtype == np.float64, k
    np.testing.assert_allclose(st["az_deg"], sj["az_deg"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(st["el_deg"], sj["el_deg"], atol=1e-4, rtol=0)
    same = _same_sample(sj, st)
    assert same.mean() >= 0.995
    for k in ("lat", "lon"):
        np.testing.assert_allclose(st[k][same], sj[k][same], atol=1e-6,
                                   rtol=0)


def test_skyline_geolocates_the_ridge(apis):
    """tests/test_skyline.py:60 on the port."""
    _, h = apis
    sky = h.skyline(-20.0, 20.0, width=81)
    c = int(np.argmin(np.abs(sky["az_deg"])))          # the az ~ 0 column
    el_ref, d_ref = _oracle_max_el(h.viewer_z)
    assert abs(sky["el_deg"][c] - el_ref) < 0.1
    assert abs(sky["dist_m"][c] - d_ref) < 400.0       # ~4 cells
    assert abs(sky["lat"][c] - (VLAT + sky["dist_m"][c] / M_PER_DEG)) < 1e-3
    assert abs(sky["lon"][c] - VLON) < 1e-3
    expect = D_CREST / np.cos(np.radians(sky["az_deg"]))
    assert np.all(np.abs(sky["dist_m"] - expect) < 1500.0)
    # the same march as horizon(): only the arctan's precision differs
    az, tan_el = h.horizon(-20.0, 20.0, width=81)
    np.testing.assert_allclose(sky["el_deg"], np.degrees(np.arctan(tan_el)),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(sky["az_deg"], np.degrees(az), atol=1e-5,
                               rtol=0)


def test_skyline_guard_warns(wall_dir):
    h = THorizonator(VLAT, VLON, 64, 32, dir_dems=wall_dir,
                     render_radius_m=35000.0, nsteps=64, device="cpu")
    with pytest.warns(RuntimeWarning, match=r"skyline\(\).*masked"):
        h.skyline(-10.0, 10.0)


def test_geojson_text_matches_jax(apis, tmp_path):
    hj, _ = apis
    sky = hj.skyline(-10.0, 10.0, width=17)
    props = {"viewer_lat": VLAT, "viewer_ele_m": 812.5}
    t = tgj.skyline_geojson(sky, tmp_path / "t.geojson", properties=props)
    assert t == jgj.skyline_geojson(sky, properties=props)
    assert (tmp_path / "t.geojson").read_text() == t
    assert not (tmp_path / "t.geojson.tmp").exists()       # atomic write
    assert tgj.skyline_csv(sky, tmp_path / "t.csv") == jgj.skyline_csv(sky)


def _read_horizon(path):
    """(per-column rows of az, el, dist, lat, lon, viewer props or None)."""
    text = path.read_text()
    if path.suffix == ".csv":
        rows = list(csv.reader(io.StringIO(text)))
        assert rows[0] == ["az_deg", "el_deg", "dist_m", "lat", "lon"]
        return np.array(rows[1:], dtype=np.float64), None
    (feat,) = json.loads(text)["features"]
    p = feat["properties"]
    lonlat = np.array(feat["geometry"]["coordinates"], dtype=np.float64)
    cols = np.stack([p["az_deg"], p["el_deg"], p["dist_m"], lonlat[:, 1],
                     lonlat[:, 0]], axis=1)
    viewer = {k: v for k, v in p.items() if k.startswith("viewer")}
    return cols, viewer


@pytest.mark.parametrize("ext", [".geojson", ".csv"])
@pytest.mark.parametrize("image", [False, True], ids=["headless", "image"])
def test_cli_horizon_out_matches_jax(wall_dir, tmp_path, ext, image):
    argv = ["--dirdems", wall_dir, "--width", "33", "--zfar", "35000",
            "--horizon-out", "{out}"]
    if image:
        argv += ["--image", "{out}.png"]
    res = _run_both(tmp_path, "sky" + ext, argv + [str(VLAT), str(VLON), "0",
                                                   "15"])
    (rj, dj, _), (rt, dt, _) = res["jax"], res["torch"]
    assert rj == rt == 0
    assert (dt / ("sky" + ext + ".png")).exists() == image
    cj, vj = _read_horizon(dj / ("sky" + ext))
    ct, vt = _read_horizon(dt / ("sky" + ext))
    assert ct.shape == cj.shape == (33, 5)
    assert vt == vj and (vt is None) == (ext == ".csv")
    np.testing.assert_allclose(ct[:, 0], cj[:, 0], atol=1e-4 + 1e-5, rtol=0)
    np.testing.assert_allclose(ct[:, 1], cj[:, 1], atol=2e-4, rtol=0)
    same = np.abs(ct[:, 2] - cj[:, 2]) <= 1e-4 * cj[:, 2] + 0.1
    assert same.mean() >= 0.995
    np.testing.assert_allclose(ct[same, 3:], cj[same, 3:], atol=1.1e-6,
                               rtol=0)
    # the ridge due north, as tests/test_skyline.py's CLI case checks
    assert ct[:, 1].max() > 1.0
    assert abs(ct[np.argmax(ct[:, 1]), 2] - D_CREST) < 2000.0


@pytest.mark.parametrize("mode", ["wireframe", "point"])
def test_debug_fill_matches_jax(render_dem_dir, mode):  # noqa: F811
    kw = dict(dir_dems=render_dem_dir, render_radius_cells=128)
    hj = JHorizonator(VIEW["lat"], VIEW["lon"], 256, 96, **kw)
    ht = THorizonator(VIEW["lat"], VIEW["lon"], 256, 96, device="cpu", **kw)
    img_j, rng_j = hj.render(-180, 180, zfar=15000.0, debug_fill=mode)
    img_t, rng_t = ht.render(-180, 180, zfar=15000.0, debug_fill=mode)
    _compare_textured(img_j, rng_j, img_t, rng_t)
    # the lattice is green on dark terrain: B == R - the red ramp
    terr = rng_t > 0
    g = img_t[terr][:, 1].astype(int)
    assert g.max() >= 150 and g.min() <= 40
    # the lattice planes do not change the ranges
    np.testing.assert_array_equal(rng_t, ht.render(-180, 180, zfar=15000.0,
                                                   return_image=False))
    assert ht._debug_cp[0] == mode
    assert ht._debug_planes(mode) is ht._debug_cp[1]        # cached


def test_debug_fill_errors(render_dem_dir):  # noqa: F811
    kw = dict(dir_dems=render_dem_dir, render_radius_cells=128)
    ht = THorizonator(VIEW["lat"], VIEW["lon"], 64, 32, device="cpu", **kw)
    hj = JHorizonator(VIEW["lat"], VIEW["lon"], 64, 32, **kw)
    for h in (ht, hj):
        with pytest.raises(ValueError, match="wireframe"):
            h.render(-60, 60, zfar=15000.0, debug_fill="solid")
    # a render that swaps to the LOD march has no debug view, in both
    hl = THorizonator(VIEW["lat"], VIEW["lon"], 64, 32, device="cpu",
                      nsteps=2048, **kw)
    with pytest.raises(ValueError, match="window sampler"):
        hl.render(-60, 60, debug_fill="wireframe")
