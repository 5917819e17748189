"""Port parity for the CLI slice: projection math, pick, horizon, resized,
the annotator and the CLI, against horizonator_tpu on the same inputs.

Both CLIs run in-process (``main(argv)``) with the same argv, the port's
with ``--device cpu`` added, at the JAX package's own CLI test sizes on
the same synthetic SRTM3 tile. Tolerances, and why:
- ``pixel_az_el_rad`` and ``unproject`` within 1 ulp of their largest
  magnitude (measured bitwise): the port converts to float32 where the JAX
  package's eager code does;
- ``project``: range within 1, y within 4 and x within 16 ulps of their
  largest magnitude (measured 1, 3.5 and 7): torch.atan2 differs from
  XLA's by an ulp, the port's x goes through the render's x_from_az (a
  product with 1/(2 pi) where the JAX package's eager code divides), and a
  narrow window multiplies an azimuth error by its pixels per radian (1146
  at 20 deg over 400 px); ``visible`` equal. The annotator's bearing ticks
  land within 0.0011 px of the JAX package's;
- ``pick``: on pixels whose ranges agree bitwise, lat/lon within 1 ulp;
  a pick beyond 2 km re-projects into its own column within 0.5 px (the
  float32 lat/lon it returns is quantized to ~0.7 m, which nearer picks
  turn into larger angles);
- ``horizon``: az within 1 ulp (tests/test_torch_geometry.py), tan_el
  within 1e-5 (tests/test_torch_window.py);
- images and ranges: tests/test_torch_render.py's tolerances
  (``_compare``), hillshade and texture test_torch_textured.py's;
- annotations: the same labels in the same places (bearing ticks within
  0.05 px), >= 99% of the link cells shared (a cell's range is read from
  the render, whose sky mask may flip a pixel), and each shared link's
  lat/lon within 5e-5 deg (about 5 m: its range may differ by 1e-4
  relative, and the URL prints 6 decimals);
- the golden anchor: the port's CLI at tests/test_golden.py's CANONICAL
  view against tests/golden/canonical_800.png, at most 0.1% of pixels
  differing and terrain within 1 (measured bitwise).
"""

import json
import math
import re
import subprocess
import sys
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

from horizonator_tpu import cli as jcli
from horizonator_tpu import geometry as jgeom
from horizonator_tpu import horizonator as JHorizonator
from horizonator_tpu_torch import cli as tcli
from horizonator_tpu_torch import geometry as tgeom
from horizonator_tpu_torch import horizonator as THorizonator
from horizonator_tpu_torch.render.crossing import k_cross_for
from tests.conftest import make_synthetic_dem_dir
from tests.test_golden import CANONICAL, GOLDEN_DIR, _scene
from tests.test_torch_geometry import CPD, ulps
from tests.test_torch_render import REPO, _compare
from tests.test_torch_textured import _compare_textured, _write_tiles

LAT, LON = 34.40, -117.45
RENDER = ["--zfar", "25000", "--nsteps", "512"]
POIS = [{"name": "Big Peak", "lat": 34.48, "lon": -117.38, "ele_m": 3000},
        {"name": "Round Top", "lat": 34.55, "lon": -117.45, "ele_m": 2400}]
WINDOWS = [(-60.0, 60.0), (350.0, 370.0), (170.0, -170.0), (0.0, 540.0),
           (-180.0, 180.0)]


def _peaks(lat, lon):
    """tests/test_api.py's tile: two Gaussian peaks on a 200 m plain."""
    z = 200.0 + 0.0 * lat
    for plat, plon, h, s in [(34.55, -117.45, 2200, 0.03),
                             (34.48, -117.38, 2800, 0.015)]:
        z = z + h * np.exp(-((lat - plat) ** 2 + (lon - plon) ** 2)
                           / (2 * s * s))
    return np.round(z).astype(np.int16)


@pytest.fixture(scope="module")
def dem_dir(tmp_path_factory):
    return make_synthetic_dem_dir(tmp_path_factory.mktemp("cli_dems"),
                                  {(34, -118): _peaks})


@pytest.fixture(scope="module")
def apis(dem_dir):
    kw = dict(dir_dems=dem_dir, render_radius_m=25000.0, nsteps=1024)
    return (JHorizonator(LAT, LON, 400, 150, **kw),
            THorizonator(LAT, LON, 400, 150, device="cpu", **kw))


def _run_both(tmp_path, name, argv, capsys=None):
    """Run both CLIs with the same argv; {"jax"|"torch": (rc, out dir)}."""
    res = {}
    for side, cli, extra in (("jax", jcli, []),
                             ("torch", tcli, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        args = [a.replace("{out}", str(d / name)) for a in argv]
        rc = cli.main(extra + args)
        res[side] = (rc, d, capsys.readouterr().err if capsys else None)
    return res


def _png_bgr(path):
    return np.asarray(Image.open(path))[:, :, ::-1]


# -- projection math --------------------------------------------------------

@pytest.mark.parametrize("az0,az1", WINDOWS)
def test_projection_math_matches_jax(az0, az1):
    rng = np.random.default_rng(5)
    cl = math.cos(math.radians(LAT))
    plat = LAT + rng.uniform(-0.3, 0.3, 400)
    plon = LON + rng.uniform(-0.3, 0.3, 400)
    pele = rng.uniform(0.0, 3000.0, 400)
    for curv in (0.0, tgeom.curvature_coeff("refracted")):
        args = (LAT, cl, LON, 812.5, plat, plon, pele, math.radians(az0),
                math.radians(az1), 400, 150)
        jx, jy, jr, jv = jgeom.project(*args, curv=curv)
        tx, ty, tr, tv = tgeom.project(*args, curv=curv)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert ulps(np.asarray(jx), tx.numpy()) <= 16
        assert ulps(np.asarray(jy), ty.numpy()) <= 4
        assert ulps(np.asarray(jr), tr.numpy()) <= 1
    xs = rng.uniform(0, 400, (20, 30))
    ys = rng.uniform(0, 150, (20, 30))
    rr = rng.uniform(100.0, 30000.0, (20, 30))
    for ref, got in zip(jgeom.pixel_az_el_rad(xs, ys, az0, az1, 400, 150),
                        tgeom.pixel_az_el_rad(xs, ys, az0, az1, 400, 150)):
        assert ulps(np.asarray(ref), got.numpy()) <= 1
    for x, y, r in ((xs, ys, rr), (12.0, 40.0, 5000.0)):
        ref = jgeom.unproject(x, y, r, -1.0, LAT, cl, LON, az0, az1, 400, 150)
        got = tgeom.unproject(x, y, r, -1.0, LAT, cl, LON, az0, az1, 400, 150)
        for a, b in zip(ref, got):
            assert ulps(np.asarray(a), b.numpy()) <= 1
    # range_en wins where positive
    a = tgeom.unproject(xs, ys, rr, rr, LAT, cl, LON, az0, az1, 400, 150)
    b = jgeom.unproject(xs, ys, rr, rr, LAT, cl, LON, az0, az1, 400, 150)
    assert ulps(np.asarray(b[0]), a[0].numpy()) <= 1


# -- API: pick, horizon, resized ---------------------------------------------

def test_pick_matches_jax(apis, dem_dir):
    hj, ht = apis
    with pytest.raises(RuntimeError, match="before render"):
        THorizonator(LAT, LON, 8, 8, dir_dems=dem_dir, render_radius_m=2000.0,
                     device="cpu").pick(0, 0)
    _, rj = hj.render(-60, 60)
    _, rt = ht.render(-60, 60)
    same = np.argwhere((rt > 2000.0) & (rt == rj))
    assert len(same) > 100
    for y, x in same[np.linspace(0, len(same) - 1, 12).astype(int)]:
        pj, pt = hj.pick(x, y), ht.pick(x, y)
        assert ulps(np.array(pj), np.array(pt)) <= 1
        px, _, _, _ = tgeom.project(
            LAT, math.cos(math.radians(LAT)), LON, ht.viewer_z, pt[0], pt[1],
            0.0, math.radians(-60.0), math.radians(60.0), 400, 150)
        assert abs(float(px) - x) <= 0.5
    sy, sx = np.argwhere(rt < 0)[0]
    assert ht.pick(sx, sy) is None and hj.pick(sx, sy) is None
    # a render that returns no ranges still serves pick() (lazy copy)
    ht.render(-60, 60, return_range=False)
    y, x = same[len(same) // 2]
    assert ht.pick(x, y) == pytest.approx(hj.pick(x, y), abs=1e-5)


@pytest.mark.parametrize("az0,az1,width", [(-60, 60, 256), (300, 90, 96)])
def test_horizon_matches_jax(apis, az0, az1, width):
    hj, ht = apis
    azj, tj = hj.horizon(az0, az1, width=width, zfar=20000.0)
    azt, tt = ht.horizon(az0, az1, width=width, zfar=20000.0)
    assert azt.shape == tt.shape == (width,) and tt.dtype == np.float32
    assert ulps(azj, azt) <= 1
    np.testing.assert_allclose(tt, tj, atol=1e-5)
    assert np.isfinite(tt).all() and tt.max() > 0.01


ORACLE_APIS = [dict(sampler="step"), dict(sampler="crossing"),
               dict(surface="triangulated"),
               dict(sampler="crossing", render_texture=True)]


@pytest.mark.parametrize("kw", ORACLE_APIS,
                         ids=["step", "crossing", "triangulated",
                              "crossing textured"])
def test_api_oracle_samplers_match_jax(dem_dir, tmp_path, kw):
    """The API through the oracle samplers (surface="triangulated" takes
    the step sampler under "auto"; a textured oracle render gathers the
    atlas per pixel): render and render_batch within _compare's (textured:
    _compare_textured's) tolerances, each batch viewpoint bitwise its own
    render(); horizon and skyline (the crossing march for every sampler
    but the window one) within 1e-5 and az within 2 ulps, pick within 1
    ulp, the uniform-step
    budget equal; no coverage warning (the oracles mask nothing)."""
    kw = dict(kw, dir_dems=dem_dir, render_radius_m=25000.0)
    cmp = _compare
    if kw.get("render_texture"):
        _write_tiles(tmp_path, LAT, LON, 420)
        kw.update(dir_tiles=str(tmp_path), allow_downloads=False)
        cmp = _compare_textured
    hj = JHorizonator(LAT, LON, 200, 80, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ht = THorizonator(LAT, LON, 200, 80, device="cpu", **kw)
        assert ht.sampler == hj.sampler != "window"
        assert ht._auto_nsteps(100.0, 25000.0) == hj._auto_nsteps(100.0,
                                                                  25000.0)
        cmp(*hj.render(-60, 60, zfar=20000.0),
            *ht.render(-60, 60, zfar=20000.0))
        azj, tj = hj.horizon(-60, 60, zfar=20000.0)
        azt, tt = ht.horizon(-60, 60, zfar=20000.0)
        # XLA folds the column azimuths by the march that takes them
        # (test_torch_geometry): 2 ulps here
        assert ulps(azj, azt) <= 2
        np.testing.assert_allclose(tt, tj, atol=1e-5)
        sj, st = hj.skyline(-60, 60, zfar=20000.0), ht.skyline(-60, 60,
                                                               zfar=20000.0)
        np.testing.assert_allclose(np.tan(np.radians(st["el_deg"])),
                                   np.tan(np.radians(sj["el_deg"])),
                                   atol=1e-5)
        _, rj = hj.render(-60, 60)
        _, rt = ht.render(-60, 60)
        y, x = np.argwhere((rt > 2000.0) & (rt == rj))[0]
        assert ulps(np.array(hj.pick(x, y)), np.array(ht.pick(x, y))) <= 1
        lats, lons = [34.40, 34.43], [-117.45, -117.49]
        bj = hj.render_batch(-60, 60, lats, lons, zfar=20000.0)
        bt = ht.render_batch(-60, 60, lats, lons, zfar=20000.0)
        for b in range(2):
            cmp(bj[0][b], bj[1][b], bt[0][b], bt[1][b])
            one = ht.render(-60, 60, lat=lats[b], lon=lons[b], zfar=20000.0)
            np.testing.assert_array_equal(bt[0][b], one[0])
            np.testing.assert_array_equal(bt[1][b], one[1])


def test_api_sampler_choices(dem_dir):
    """"auto" is window on the bilinear surface and step on the
    triangulated one; the step sampler's pair plane serves the LOS ops;
    the JAX package's silent misrenders and refusals raise here: 'lod'
    (there it marches the pair planes as elevations), hillshade off the
    window sampler, an unknown sampler or surface."""
    kw = dict(dir_dems=dem_dir, render_radius_m=8000.0, device="cpu")
    assert THorizonator(LAT, LON, 32, 16, **kw).sampler == "window"
    hs = THorizonator(LAT, LON, 32, 16, surface="triangulated", **kw)
    assert hs.sampler == "step" and hs._dem_packed_pairs() is hs._scene
    for bad, match in ((dict(sampler="lod"), "not a scene sampler"),
                       (dict(sampler="step", hillshade=True),
                        "hillshade requires"),
                       (dict(sampler="bogus"), "unknown sampler"),
                       (dict(surface="smooth"), "unknown surface")):
        with pytest.raises(ValueError, match=match):
            THorizonator(LAT, LON, 32, 16, **bad, **kw)


def test_horizon_guard_warns(dem_dir):
    h = THorizonator(LAT, LON, 64, 32, dir_dems=dem_dir,
                     render_radius_m=25000.0, nsteps=64, device="cpu")
    with pytest.warns(RuntimeWarning, match=r"horizon\(\).*masked"):
        h.horizon(-60, 60)


def test_resized_matches_jax(dem_dir):
    kw = dict(dir_dems=dem_dir, render_radius_m=25000.0, nsteps=1024)
    hj = JHorizonator(LAT, LON, 64, 32, **kw)
    ht = THorizonator(LAT, LON, 64, 32, device="cpu", **kw)
    hj.resized(300, 100)
    ht.resized(300, 100)
    assert (ht.width, ht.height) == (300, 100)
    _compare(*hj.render(0, 90), *ht.render(0, 90))


# -- the CLI ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["plain", "hillshade", "texture"])
def test_cli_png_and_ranges_match_jax(dem_dir, tmp_path, kind):
    argv = ["--width", "300", "--height", "100", "--image", "{out}",
            "--ranges", "{out}.npy", "--dirdems", dem_dir, *RENDER]
    compare = _compare
    if kind == "hillshade":
        argv += ["--hillshade", "--sun-az", "200", "--sun-alt", "30"]
        compare = _compare_textured
    elif kind == "texture":
        _write_tiles(tmp_path, LAT, LON, 420)
        argv += ["--texture", "--dirtiles", str(tmp_path)]
        compare = _compare_textured
    res = _run_both(tmp_path, "pano.png", argv + ["34.40", "-117.45", "0",
                                                  "60"])
    (rj, dj, _), (rt, dt, _) = res["jax"], res["torch"]
    assert rj == rt == 0
    img_t = _png_bgr(dt / "pano.png")
    rng_t = np.load(dt / "pano.png.npy")
    assert img_t.shape == (100, 300, 3) and rng_t.dtype == np.float32
    compare(_png_bgr(dj / "pano.png"), np.load(dj / "pano.png.npy"), img_t,
            rng_t)
    if kind != "plain":
        terr = rng_t > 0
        b, g = img_t[terr][:, 0].astype(int), img_t[terr][:, 1].astype(int)
        assert (b == g).all() == (kind == "hillshade")


def test_cli_raw_ranges_and_crop(dem_dir, tmp_path):
    """--ranges with another extension writes raw little-endian f32;
    --cut-off-bottom-px crops both outputs."""
    base = ["--width", "120", "--height", "60", "--dirdems", dem_dir,
            "--device", "cpu", *RENDER, "34.40", "-117.45", "0", "60"]
    assert tcli.main(["--image", str(tmp_path / "a.png"), "--ranges",
                      str(tmp_path / "a.npy"), *base]) == 0
    assert tcli.main(["--image", str(tmp_path / "b.png"), "--ranges",
                      str(tmp_path / "b.f32"), "--cut-off-bottom-px", "10",
                      *base]) == 0
    full = np.load(tmp_path / "a.npy")
    raw = np.fromfile(tmp_path / "b.f32", dtype="<f4").reshape(50, 120)
    np.testing.assert_array_equal(raw, full[:50])
    assert Image.open(tmp_path / "b.png").size == (120, 50)


def test_cli_full_circle_radius_180(dem_dir, tmp_path):
    res = _run_both(tmp_path, "full.png", [
        "--width", "400", "--height", "120", "--image", "{out}", "--ranges",
        "{out}.npy", "--dirdems", dem_dir, *RENDER, "34.40", "-117.45", "0",
        "180"])
    (rj, dj, _), (rt, dt, _) = res["jax"], res["torch"]
    assert rj == rt == 0
    img = _png_bgr(dt / "full.png")
    _compare(_png_bgr(dj / "full.png"), np.load(dj / "full.png.npy"), img,
             np.load(dt / "full.png.npy"))
    sky = (img[:, :, 0] > 200) & (img[:, :, 2] < 50)
    horizon = sky.sum(axis=0)
    assert horizon.max() - horizon.min() > 10
    assert abs(int(horizon[0]) - int(horizon[-1])) <= 2


def _svg_parts(text):
    texts = re.findall(r'<text x="([-\d.]+)" y="([-\d.]+)"[^>]*>([^<]*)</text>',
                       text)
    links = re.findall(r'<a xlink:href="https://caltopo\.com/map\.html#ll='
                       r'([-\d.]+),([-\d.]+)&amp;z=15&amp;b=mbt" '
                       r'target="_blank"><rect x="([-\d.]+)" y="([-\d.]+)"',
                       text)
    return texts, {(x, y): (float(la), float(lo)) for la, lo, x, y in links}


def _check_links(lj, lt):
    common = lj.keys() & lt.keys()
    assert len(common) >= 0.99 * len(lj.keys() | lt.keys()) and common
    err = max(max(abs(lj[c][0] - lt[c][0]), abs(lj[c][1] - lt[c][1]))
              for c in common)
    assert err <= 5e-5, err


def test_cli_svg_pois_matches_jax(dem_dir, tmp_path):
    pf = tmp_path / "pois.json"
    pf.write_text(json.dumps(POIS))
    res = _run_both(tmp_path, "pano.svg", [
        "--width", "400", "--height", "150", "--image", "{out}", "--dirdems",
        dem_dir, "--pois", str(pf), *RENDER, "34.40", "-117.45", "30", "40"])
    assert res["jax"][0] == res["torch"][0] == 0
    tj, lj = _svg_parts((res["jax"][1] / "pano.svg").read_text())
    tt, lt = _svg_parts((res["torch"][1] / "pano.svg").read_text())
    assert [t[2] for t in tt] == [t[2] for t in tj]
    assert "Big Peak" in [t[2] for t in tt] and "0deg" in [t[2] for t in tt]
    for a, b in zip(tj, tt):
        assert abs(float(a[0]) - float(b[0])) <= 0.05
        assert abs(float(a[1]) - float(b[1])) <= 0.05
    _check_links(lj, lt)


def _pdf_parts(data):
    """(text strings of the content stream, link rects -> (lat, lon))."""
    texts = []
    for s in re.findall(rb"stream\n(.*?)\nendstream", data, re.S):
        try:
            body = zlib.decompress(s)
        except zlib.error:
            continue
        texts += re.findall(rb"\(([^)]*)\) Tj", body)
    links = re.findall(rb"/Rect \[([-\d.]+) ([-\d.]+) [-\d. ]+\] /Border "
                       rb"\[0 0 0\] /A << /S /URI /URI \(https://caltopo"
                       rb"\.com/map\.html#ll=([-\d.]+),([-\d.]+)&", data)
    return texts, {(x, y): (float(la), float(lo)) for x, y, la, lo in links}


def test_cli_pdf_matches_jax(dem_dir, tmp_path):
    pf = tmp_path / "pois.json"
    pf.write_text(json.dumps(POIS))
    res = _run_both(tmp_path, "pano.pdf", [
        "--width", "400", "--height", "150", "--image", "{out}", "--dirdems",
        dem_dir, "--pois", str(pf), "--cut-off-bottom-px", "6", *RENDER,
        "34.40", "-117.45", "30", "40"])
    assert res["jax"][0] == res["torch"][0] == 0
    dj = (res["jax"][1] / "pano.pdf").read_bytes()
    dt = (res["torch"][1] / "pano.pdf").read_bytes()
    assert dt.startswith(b"%PDF-1.4") and dt.rstrip().endswith(b"%%EOF")
    tj, lj = _pdf_parts(dj)
    tt, lt = _pdf_parts(dt)
    assert tt == tj and b"Big Peak" in tt
    _check_links(lj, lt)


def test_peaks_helpers_match_jax(tmp_path, capsys):
    """The Overpass helpers (no fetch): the query, the name fallback, the
    records --pois reads and the C initializers, as the JAX package's."""
    from horizonator_tpu.annotate import peaks as jpeaks
    from horizonator_tpu_torch.annotate import load_pois, peaks as tpeaks
    elements = [
        {"lat": 34.5, "lon": -117.4, "tags": {"ele": "2800", "name": "A",
                                              "name:en": "A (en)"}},
        {"lat": 34.6, "lon": -117.3, "tags": {"ele": "2400.5", "name": "B"}},
        {"lat": 34.7, "lon": -117.2, "tags": {"ele": "1999", "name:th": "C"}},
        {"lat": 34.8, "lon": -117.1, "tags": {"ele": "1500"}},
        {"lat": 34.9, "lon": -117.0, "tags": {"name": "no ele"}},
        {"lat": 35.0, "lon": -116.9, "tags": {"ele": "3 km", "name": "bad"}},
    ]
    assert tpeaks.overpass_query(34.4, -117.45, 25000.0) == \
        jpeaks.overpass_query(34.4, -117.45, 25000.0)
    got = tpeaks.parse_elements(elements)
    assert got == jpeaks.parse_elements(elements)
    assert [p["name"] for p in got] == ["A (en)", "B", "C", "1500m"]
    assert tpeaks.to_c_initializers(got) == jpeaks.to_c_initializers(got)
    (tmp_path / "p.json").write_text(json.dumps(got))
    assert [(p.name, p.ele_m) for p in load_pois(tmp_path / "p.json")] == \
        [("A (en)", 2800.0), ("B", 2400.5), ("C", 1999.0), ("1500m", 1500.0)]
    assert tpeaks.main(["34.4", "-117.45"]) == 1
    assert "usage" in capsys.readouterr().err


def test_cli_golden_canonical(tmp_path):
    """The port's CLI reproduces the JAX package's golden render."""
    demdir = make_synthetic_dem_dir(tmp_path, {(34, -118): _scene})
    out = tmp_path / "golden_out.png"
    assert tcli.main(["--image", str(out), "--dirdems", demdir, "--device",
                      "cpu"] + CANONICAL) == 0
    img = np.asarray(Image.open(out))
    want = np.asarray(Image.open(GOLDEN_DIR / "canonical_800.png"))
    assert img.shape == want.shape == (266, 800, 3)
    diff = np.abs(img.astype(int) - want.astype(int))
    assert (diff.max(axis=-1) > 0).mean() <= 0.001

    def sky(a):
        return (a[:, :, 2] == 255) & (a[:, :, 0] == 0)    # RGB file order
    terr = ~sky(img) & ~sky(want)
    assert terr.mean() > 0.2 and diff[terr].max(initial=0) <= 1


# the JAX CLI's validation cases: the same exit code and message
VALIDATION = [
    ["--width", "100", "34", "-117", "0", "45"],
    ["--width", "10", "--image", "x.png", "95", "-117", "0", "45"],
    ["--width", "10", "--image", "x.png", "34", "-190", "0", "45"],
    ["--width", "100", "--pois-out", "x.geojson", "34", "-117", "0", "45"],
    ["--width", "1", "--image", "x.png", "34", "-117", "0", "45"],
    ["--width", "100", "--image", "x.png", "34", "-117", "0", "0"],
    ["--height", "100", "34", "-117", "0", "45"],
    ["--image", "x.png", "34", "-117", "0", "45"],
    ["--width", "100", "--image", "x.jpg", "34", "-117", "0", "45"],
    ["--width", "100", "--image", "x.png", "--tiles", "osm", "34", "-117",
     "0", "45"],
]


@pytest.mark.parametrize("argv", VALIDATION, ids=range(len(VALIDATION)))
def test_cli_validation_matches_jax(tmp_path, capsys, argv):
    res = _run_both(tmp_path, "x",
                    [str(tmp_path / a) if a.startswith("x.") else a
                     for a in argv], capsys)
    (rj, _, ej), (rt, _, et) = res["jax"], res["torch"]
    assert rj == rt == 1
    assert et.strip() and et.strip() == ej.strip().splitlines()[-1]


UNPORTED = [
    (["--horizon-out", "h.csv", "--dem-url", "http://example.invalid/%s"],
     "dem_url_fmt"),
    (["--allow-dem-downloads"], "DEM downloader"),
    ([], "viewer.py"),
]


@pytest.mark.parametrize("extra,module", UNPORTED,
                         ids=[u[1] for u in UNPORTED])
def test_cli_unported_flags_exit(dem_dir, tmp_path, capsys, extra, module):
    image = [] if not extra else ["--width", "64", "--image",
                                  str(tmp_path / "x.png")]
    if extra and extra[0] == "--horizon-out":
        image = ["--width", "64"]
    rc = tcli.main(["--device", "cpu", "--dirdems", dem_dir, *image, *extra,
                    "34.40", "-117.45", "0", "60"])
    err = capsys.readouterr().err
    assert rc == 1 and module in err and "not ported" in err
    assert not (tmp_path / "x.png").exists()


@pytest.mark.parametrize("sampler", ["step", "crossing"])
def test_cli_viewshed_sampler_matches_jax(dem_dir, tmp_path, sampler):
    """--viewshed --viewshed-sampler step|crossing through both CLIs, each
    with its JAX budget (1.5 uniform steps a cell; k_cross_for): the TIFFs'
    tags equal and the rasters within test_torch_viewshed's tolerance
    (assert_raster_close, in the frame and params the CLIs compute: the
    step sampler's gather raster, the crossing sampler's contract)."""
    from horizonator_tpu_torch.dem import load_mosaic
    from tests.test_torch_geotiff import parse_tiff
    from tests.test_torch_viewshed import CELL_M, assert_raster_close, \
        jparams
    lat, lon, znear, zfar = 34.43, -117.47, 100.0, 9000.0
    rasters = {}
    for side, cli, extra in (("jax", jcli, []),
                             ("torch", tcli, ["--device", "cpu"])):
        out = tmp_path / f"{side}.tif"
        assert cli.main([*extra, "--dirdems", dem_dir, "--zfar", str(zfar),
                         "--viewshed", str(out), "--viewshed-sampler",
                         sampler, str(lat), str(lon), "0", "180"]) == 0
        tags, pix = parse_tiff(out)
        rasters[side] = tags, np.frombuffer(pix, np.uint8).reshape(
            tags[257][0], tags[256][0])[::-1]
    (jt, jv), (tt, tv) = rasters["jax"], rasters["torch"]
    assert tt == jt and tv.shape == jv.shape and tv.any() and not tv.all()
    m = load_mosaic(lat, lon, render_radius_m=zfar, datadir=dem_dir)
    n, (ci, cj) = m.grid.shape[0], m.viewer_cell(lat, lon)
    cos_lat = math.cos(math.radians(lat))
    hw = tv.shape[0] // 2
    width = int(min(4096, max(256, -(-2.0 * math.pi * hw // 256) * 256)))
    nsteps = (int(-(-1.5 * (zfar - znear) / CELL_M // 128) * 128)
              if sampler == "step" else k_cross_for(zfar, CPD, lat, n=n))
    p = jparams(ci, cj, m.auto_viewer_z(lat, lon), zfar=zfar,
                az0=math.radians(-180.0), az1=math.radians(180.0),
                znear=znear, cos_lat=cos_lat)
    assert_raster_close(jv.astype(bool), tv.astype(bool),
                        m.grid.astype(np.float32), p,
                        dict(out_halfwidth=hw, width=width, nsteps=nsteps,
                             sampler=sampler, lat_hint_deg=lat,
                             full_circle=True), cos_lat)


@pytest.mark.parametrize("extra", [["--surface", "triangulated"],
                                   ["--surface", "triangulated",
                                    "--horizon-out", "{out}.csv"]],
                         ids=["image", "image and skyline"])
def test_cli_surface_triangulated_matches_jax(dem_dir, tmp_path, extra):
    """--surface triangulated renders through the uniform-step sampler in
    both CLIs: image and ranges within _compare's tolerances, and the
    skyline (the crossing march there, k_cross_for's budget) within one
    printed unit (1e-4 deg) in azimuth and elevation."""
    res = _run_both(tmp_path, "tri.png", [
        "--width", "300", "--height", "100", "--image", "{out}", "--ranges",
        "{out}.npy", "--dirdems", dem_dir, "--zfar", "25000", *extra,
        "34.40", "-117.45", "0", "60"])
    (rj, dj, _), (rt, dt, _) = res["jax"], res["torch"]
    assert rj == rt == 0
    _compare(_png_bgr(dj / "tri.png"), np.load(dj / "tri.png.npy"),
             _png_bgr(dt / "tri.png"), np.load(dt / "tri.png.npy"))
    if len(extra) > 2:
        sj = np.loadtxt(dj / "tri.png.csv", delimiter=",", skiprows=1)
        st = np.loadtxt(dt / "tri.png.csv", delimiter=",", skiprows=1)
        assert sj.shape == st.shape
        np.testing.assert_allclose(st[:, :2], sj[:, :2], atol=1.01e-4,
                                   rtol=0)


def test_cli_not_ported_render_exits(dem_dir, tmp_path, capsys):
    """A render whose scene set-up is not ported (a DEM download URL) exits
    with the API's message and writes nothing."""
    rc = tcli.main(["--device", "cpu", "--width", "64", "--image",
                    str(tmp_path / "x.png"), "--dirdems", dem_dir,
                    "--dem-url", "http://example.invalid/%s", "34.40",
                    "-117.45", "0", "60"])
    err = capsys.readouterr().err
    assert rc == 1 and "not ported" in err and "dem_url_fmt" in err
    assert not (tmp_path / "x.png").exists()


def test_cli_lod_render_matches_jax(dem_dir, tmp_path):
    """A render that needs more than LOD_SWAP_NSTEPS crossing steps swaps
    to the LOD march in both CLIs (it exited 1 before the port had one)."""
    res = _run_both(tmp_path, "lod.png", [
        "--width", "300", "--height", "100", "--image", "{out}", "--ranges",
        "{out}.npy", "--dirdems", dem_dir, "--nsteps", "2048", "34.40",
        "-117.45", "0", "60"])
    (rj, dj, _), (rt, dt, _) = res["jax"], res["torch"]
    assert rj == rt == 0
    _compare(_png_bgr(dj / "lod.png"), np.load(dj / "lod.png.npy"),
             _png_bgr(dt / "lod.png"), np.load(dt / "lod.png.npy"))


def test_cli_runs_without_jax(dem_dir, tmp_path):
    """The port's CLI, annotator, LOD march, geojson writer and probe import
    no JAX and nothing of horizonator_tpu, as `python -m
    horizonator_tpu_torch.cli` runs them."""
    code = f"""
import sys
from horizonator_tpu_torch import cli
from horizonator_tpu_torch.benchmarks import profile_roll_ceiling
rc = cli.main(["--device", "cpu", "--width", "96", "--height", "32",
               "--image", {str(tmp_path / "p.pdf")!r}, "--dirdems",
               {dem_dir!r}, "--zfar", "20000", "--nsteps", "2048",
               "--horizon-out", {str(tmp_path / "h.geojson")!r}, "34.40",
               "-117.45", "0", "60"])
assert rc == 0
assert "horizonator_tpu_torch.render.lod" in sys.modules
assert "horizonator_tpu_torch.geojson" in sys.modules
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert not any(m.startswith("horizonator_tpu.") or m == "horizonator_tpu"
               for m in sys.modules)
print("ok")
"""
    home = tmp_path / "home"
    home.mkdir()
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(home),
                            "TMPDIR": str(tmp_path),
                            "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")
    assert (tmp_path / "p.pdf").read_bytes().startswith(b"%PDF")
    assert json.loads((tmp_path / "h.geojson").read_text())["features"]
