"""Port parity for the interactive viewer (viewer.py, mapwidget.py, _png.py)
and the CLI's interactive mode, against horizonator_tpu.

The cases of tests/test_viewer.py drive both viewers' HTTP servers on
127.0.0.1 over tests/test_viewer.py's 200x80 scene, the port's with
``device="cpu"``, with the same moves in the same order. After each move
the two ``state_json`` answers are equal except ``command`` (which names
each package's module), and the decoded frames and the last ranges are
within tests/test_torch_render.py's ``_compare`` tolerance. One move takes
another bound for its ranges: zoomed in to the clamp (az radius 1 deg, 100
px a degree), an ulp of torch's row map against XLA's moves a pixel's
10-bit alpha between its two samples by a quantum (0.09 m between samples
an SRTM3 cell apart: 4.4e-4 of a 200 m range). There the ranges differ
by more than 1e-4 relative at <= 1% of terrain pixels (measured 0.7%),
each by <= 2e-3 relative (measured 8.8e-4), and the images stay within
``_compare``'s bounds. The map pane's upstream tile server is a port on
127.0.0.1 that refuses at once.
"""

import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
from PIL import Image

from horizonator_tpu import cli as jcli
from horizonator_tpu import horizonator as JHorizonator
from horizonator_tpu import viewer as jviewer
from horizonator_tpu.dem import hgt
from horizonator_tpu_torch import cli as tcli
from horizonator_tpu_torch import horizonator as THorizonator
from horizonator_tpu_torch import viewer as tviewer
from horizonator_tpu_torch._png import encode_png
from tests.test_settings_gpx import GPX
from tests.test_torch_render import _compare

# as tests/test_viewer.py: ordinary viewer moves never trip the coverage
# guard
pytestmark = pytest.mark.filterwarnings("error::RuntimeWarning")

OFFLINE_TILES = "http://127.0.0.1:9/%d/%d/%d.png"


def _peak(lat, lon):
    return np.round(200 + 2000 * np.exp(-((lat - 34.55) ** 2
                                          + (lon + 117.45) ** 2)
                                        / (2 * 0.03 ** 2))).astype(np.int16)


@pytest.fixture(scope="module")
def dem_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("dems")
    edge = hgt.SRTM3_EDGE
    lat = 35.0 - np.arange(edge) / (edge - 1)
    lon = -118.0 + np.arange(edge) / (edge - 1)
    hgt.write_hgt(d / "N34W118.hgt", _peak(lat[:, None], lon[None, :]))
    return str(d)


@pytest.fixture(scope="module")
def servers(dem_dir, tmp_path_factory):
    """{"jax" | "torch": (url, state)}: both viewers over one scene."""
    out, httpds = {}, []
    for side, mod, cls, kw in (("jax", jviewer, JHorizonator, {}),
                               ("torch", tviewer, THorizonator,
                                {"device": "cpu"})):
        h = cls(34.40, -117.45, 200, 80, dir_dems=dem_dir,
                render_radius_m=20000.0, **kw)
        state = mod.ViewerState(
            h, az_center=0.0, az_radius=45.0, znear=100.0, zfar=20000.0,
            dir_tiles=str(tmp_path_factory.mktemp(f"tiles_{side}")),
            tiles_url_fmt=OFFLINE_TILES)
        state.render({})
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), mod.make_handler(state))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        httpds.append(httpd)
        out[side] = (f"http://127.0.0.1:{httpd.server_address[1]}", state)
    yield out
    for httpd in httpds:
        httpd.shutdown()
        httpd.server_close()


def _post(url, path, body):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return r.read(), r.headers.get("Content-Type")


def _rgb(png):
    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


def _same_state(sj, st):
    assert st["command"] == sj["command"].replace(
        "horizonator_tpu.viewer", "horizonator_tpu_torch.viewer")
    assert {k: v for k, v in st.items() if k != "command"} == \
        {k: v for k, v in sj.items() if k != "command"}


def _frames_close(servers, zoomed=False):
    """The served frames and the last ranges of both viewers agree
    (``zoomed``: the az radius at its 1 deg clamp; see the docstring)."""
    got = {}
    for side, (url, state) in servers.items():
        body, ctype = _get(url, "/pano.png")
        assert ctype == "image/png"
        got[side] = (_rgb(body)[:, :, ::-1], state.h._last_ranges())
    (img_j, rng_j), (img_t, rng_t) = got["jax"], got["torch"]
    if zoomed:
        terr = (rng_j > 0) & (rng_t > 0)
        assert ((rng_j < 0) == (rng_t < 0)).mean() >= 0.999
        rel = np.abs(rng_t[terr] - rng_j[terr]) / rng_j[terr]
        assert (rel > 1e-4).mean() <= 0.01 and rel.max() <= 2e-3
        rng_t = np.where(terr, rng_j, rng_t)       # the image checks below
    _compare(img_j, rng_j, img_t, rng_t)
    return {side: img[:, :, ::-1] for side, (img, _) in got.items()}


def _move(servers, body, zoomed=False):
    """POST one move to both viewers; the port's state, after the checks."""
    s = {side: _post(url, "/api/render", body)
         for side, (url, _) in servers.items()}
    _same_state(s["jax"], s["torch"])
    _frames_close(servers, zoomed)
    return s["torch"]


def test_index_and_state(servers):
    url, state = servers["torch"]
    body, ctype = _get(url, "/")
    assert b"horizonator" in body and "text/html" in ctype
    assert body == _get(servers["jax"][0], "/")[0]
    s = json.loads(_get(url, "/api/state")[0])
    _same_state(json.loads(_get(servers["jax"][0], "/api/state")[0]), s)
    assert s["lat"] == 34.40 and s["az_radius"] == 45.0
    assert "viewer 34.400000 -117.450000" in s["command"]
    assert s["command"].startswith("python -m horizonator_tpu_torch.viewer ")
    lat0, lon0, lat1, lon1 = s["bounds"]
    assert lat0 < 34.40 < lat1 and lon0 < -117.45 < lon1


def test_pano_png(servers):
    frames = _frames_close(servers)
    assert frames["torch"].shape == (80, 200, 3)
    # the served frame is the API's render of the same view, bitwise
    state = servers["torch"][1]
    img = state.h.render(-45.0, 45.0, return_range=False, znear=100.0,
                         zfar=20000.0)
    np.testing.assert_array_equal(frames["torch"], img[:, :, ::-1])


def test_render_move_and_pan_zoom(servers):
    s = _move(servers, {"lat": 34.45, "lon": -117.40})
    assert s["lat"] == 34.45
    s = _move(servers, {"az_radius": 500.0})
    assert s["az_radius"] == 179.0     # clamp (horizonator.cc:135-139)
    s = _move(servers, {"az_radius": 0.01}, zoomed=True)
    assert s["az_radius"] == 1.0
    s = _move(servers, {"az_center": 90.0, "az_radius": 30.0})
    assert s["az_center"] == 90.0
    # restore
    _move(servers, {"lat": 34.40, "lon": -117.45, "az_center": 0.0,
                    "az_radius": 45.0})


def test_live_resize(servers):
    s = _move(servers, {"width": 320, "height": 120})
    assert s["width"] == 320 and s["height"] == 120
    assert _rgb(_get(servers["torch"][0], "/pano.png")[0]).shape == \
        (120, 320, 3)
    # clamped at the extremes
    s = _move(servers, {"width": 1, "height": 99999})
    assert s["width"] == 64 and s["height"] == 4096
    s = _move(servers, {"width": 200, "height": 80})
    assert s["width"] == 200 and s["height"] == 80


def _green_px(url):
    a = _rgb(_get(url, "/pano.png")[0])
    return int(((a[:, :, 0] == 0) & (a[:, :, 1] == 255)
                & (a[:, :, 2] == 0)).sum())


def test_debug_horizon_overlay(servers):
    # the 'w' debug view: a green horizon trace over the render
    url = servers["torch"][0]
    s = _move(servers, {"debug": True})
    assert s["debug"]
    n_dbg = _green_px(url)
    assert n_dbg >= 150           # ~2 px per visible column at width 200
    assert abs(n_dbg - _green_px(servers["jax"][0])) <= 2
    s = _move(servers, {"debug": False})
    assert not s["debug"]
    assert _green_px(url) < n_dbg / 4


def test_pick_endpoint(servers):
    url, state = servers["torch"]
    for x, y in ((0.5, 0.95), (0.3, 0.9), (0.5, 0.02)):
        jj = _post(servers["jax"][0], "/api/pick", {"x": x, "y": y})
        jt = _post(url, "/api/pick", {"x": x, "y": y})
        assert jt["hit"] == jj["hit"]
        if jt["hit"]:
            assert jt["lat"] == pytest.approx(jj["lat"], abs=1e-5)
            assert jt["lon"] == pytest.approx(jj["lon"], abs=1e-5)
            assert jt == dict(zip(("lat", "lon"), state.h.pick(
                int(x * 200), int(y * 80))), hit=True)
    # bottom middle of the image: terrain; top: sky
    assert _post(url, "/api/pick", {"x": 0.5, "y": 0.95})["hit"]
    assert not _post(url, "/api/pick", {"x": 0.5, "y": 0.02})["hit"]
    # out-of-range fractions clamp to the image
    assert _post(url, "/api/pick", {"x": -3.0, "y": 7.0}) == \
        _post(servers["jax"][0], "/api/pick", {"x": -3.0, "y": 7.0})


def test_vendored_map_widget_offline(servers):
    """The map pane works with zero network: same-origin resources only,
    /map.js serves the vendored widget, /tiles/ serves the disk cache with
    a 200 gray placeholder when the tile is missing and the upstream
    refuses (orb_osmlayer.cpp:146-155)."""
    url, state = servers["torch"]
    body, _ = _get(url, "/")
    assert b"unpkg.com" not in body
    assert b'src="http' not in body and b'href="http' not in body
    assert b'src="/map.js"' in body
    js, ctype = _get(url, "/map.js")
    assert "javascript" in ctype
    assert js == _get(servers["jax"][0], "/map.js")[0]
    for api in (b"L.map", b"tileLayer", b"circleMarker", b"polyline",
                b"rectangle", b"layerGroup", b"contextmenu"):
        assert api.replace(b"L.map", b"map:") in js or api in js, api
    png, ctype = _get(url, "/tiles/12/701/1635.png")
    assert ctype == "image/png"
    im = _rgb(png)
    assert im.shape == (256, 256, 3) and (im == 200).all()
    from horizonator_tpu_torch import tiles as tiles_mod
    p = tiles_mod.tile_path(state.tiles_dir, state.tiles_name, 12, 7, 9)
    p.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(np.full((256, 256, 3), 55, np.uint8)).save(p)
    png2, _ = _get(url, "/tiles/12/7/9.png")
    assert png2 == p.read_bytes()
    # malformed tile paths and unknown routes 404 rather than crash
    for path in ("/tiles/nope", "/nope"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(url, path)
        assert e.value.code == 404


def test_leaflet_tile_url_conversion():
    for fmt in ("https://ex.org/t/%d/%d/%d.png", None):
        assert tviewer.leaflet_tile_url(fmt) == jviewer.leaflet_tile_url(fmt)
    assert (tviewer.leaflet_tile_url("https://ex.org/t/%d/%d/%d.png")
            == "https://ex.org/t/{z}/{x}/{y}.png")
    assert tviewer.leaflet_tile_url(None).endswith("/{z}/{x}/{y}.png")


def test_page_substitutes_tile_url_and_zoom_limits(servers):
    url, state = servers["torch"]
    body, _ = _get(url, "/")
    assert b"__TILE_URL__" not in body and b"__ZOOM_MAX__" not in body
    assert state.tile_url.encode() in body
    assert f"maxZoom:{state.zoom_max}".encode() in body
    assert (state.zoom_min, state.zoom_max) == \
        (servers["jax"][1].zoom_min, servers["jax"][1].zoom_max)


def _greenish_px(url):
    a = _rgb(_get(url, "/pano.png")[0]).astype(np.int32)
    return int(((a[:, :, 1] > 96) & (a[:, :, 1] > a[:, :, 0] + 40)
                & (a[:, :, 1] > a[:, :, 2] + 40)).sum())


def test_fill_mode_cycle(servers):
    """The 'e' fill modes: wireframe renders the DEM lattice green, point
    lights far fewer pixels, '' restores; a bad mode is refused."""
    url = servers["torch"][0]
    s = _move(servers, {"fill": "wireframe"})
    assert s["fill"] == "wireframe"
    n_wire = _greenish_px(url)
    assert n_wire > 200
    s = _move(servers, {"fill": "point"})
    assert s["fill"] == "point"
    n_point = _greenish_px(url)
    assert 0 < n_point < n_wire / 2
    s = _move(servers, {"fill": ""})
    assert s["fill"] is None
    assert _greenish_px(url) < n_point
    with pytest.raises(ValueError, match="bad fill mode"):
        servers["torch"][1].render({"fill": "solid"})


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (80, 200), (257, 31)])
def test_png_writer_decodes_with_pil(shape):
    rgb = np.random.default_rng(sum(shape)).integers(
        0, 256, (*shape, 3), dtype=np.uint8)
    png = encode_png(rgb[:, ::-1][:, ::-1])        # non-contiguous view
    im = Image.open(io.BytesIO(png))
    assert im.mode == "RGB" and im.size == shape[::-1]
    np.testing.assert_array_equal(np.asarray(im), rgb)
    for bad in (rgb.astype(np.int16), rgb[..., :2], rgb[0]):
        with pytest.raises(ValueError):
            encode_png(bad)


@pytest.mark.parametrize("extra", [
    [], ["--SRTM1", "--texture", "--curvature", "refracted"],
    ["--hillshade", "--shadows", "--sun-az", "200", "--dirdems", "d"]],
    ids=["plain", "srtm1 texture", "hillshade"])
def test_cli_interactive_mode_args_match_jax(monkeypatch, capsys, extra):
    """No output file: both CLIs hand their viewer the same arguments, the
    port's plus its --device."""
    got = {}
    for side, mod in (("jax", jviewer), ("torch", tviewer)):
        monkeypatch.setattr(mod, "main",
                            lambda argv, _s=side: got.setdefault(_s, argv)
                            and 0)
    argv = [*extra, "--zfar", "30000", "34.40", "-117.45", "10", "50"]
    assert jcli.main(argv) == 0
    assert tcli.main(["--device", "cpu", *argv]) == 0
    assert got["torch"] == got["jax"] + ["--device", "cpu"]
    assert got["jax"][:4] == ["34.4", "-117.45", "10.0", "50.0"]
    err = capsys.readouterr().err
    assert err.count("interactive mode: launching the web viewer") == 2


def test_viewer_main_matches_jax(monkeypatch, dem_dir, tmp_path):
    """Both viewers' main() with --gpx: the served scene (state, frame)
    agrees; serve() is stubbed to record the state and return."""
    gpx = tmp_path / "t.gpx"
    gpx.write_text(GPX)
    states = {}
    for side, mod in (("jax", jviewer), ("torch", tviewer)):
        monkeypatch.setattr(mod, "serve",
                            lambda state, port, _s=side:
                            states.setdefault(_s, (state, port)))
    argv = ["34.40", "-117.45", "20", "40", "--width", "160", "--height",
            "64", "--dirdems", dem_dir, "--zfar", "20000", "--gpx", str(gpx),
            "--port", "8123"]
    assert jviewer.main(argv) == 0
    assert tviewer.main(argv + ["--device", "cpu"]) == 0
    (sj, pj), (st, pt) = states["jax"], states["torch"]
    assert pj == pt == 8123
    assert str(st.h.device) == "cpu"
    _same_state(sj.state_json(), st.state_json())
    assert len(st.gpx) == 3
    _compare(_rgb(sj.png)[:, :, ::-1], sj.h._last_ranges(),
             _rgb(st.png)[:, :, ::-1], st.h._last_ranges())


def test_viewer_and_cli_default_to_cuda(monkeypatch, dem_dir):
    """Without --device, viewer.main and the CLI's interactive mode build
    the scene on cuda (the constructor is stubbed)."""
    from horizonator_tpu_torch import api

    class Stop(Exception):
        pass

    seen = []

    def stub(*a, device="cuda", **kw):
        seen.append(device)
        raise Stop
    monkeypatch.setattr(api, "horizonator", stub)
    for run in (lambda: tviewer.main(["34.4", "-117.45"]),
                lambda: tcli.main(["34.4", "-117.45", "0", "45"])):
        with pytest.raises(Stop):
            run()
    assert seen == ["cuda", "cuda"]
