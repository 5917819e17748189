"""Port parity for the host paths that need neither PIL nor ``requests``:
``tiles.fetch_tile`` and ``build_atlas`` downloading through urllib, the
viewer's ``/tiles/`` route, ``annotate.peaks.fetch_peaks`` posting through
urllib, and the SVG annotator's embedded PNG through ``_png``, each against
horizonator_tpu (``requests`` and PIL).

Every download comes from a loopback HTTP server on 127.0.0.1. Files, the
``.expires`` records, the request paths, the ``User-Agent`` and the POST
bodies are equal; the SVGs are equal outside their base64 payload, whose
pixels are equal. A subprocess with PIL and ``requests`` blocked runs the
tile, atlas, SVG and peak paths.
"""

import base64
import io
import json
import re
import subprocess
import sys
import threading
import urllib.error
from email.utils import format_datetime
from datetime import datetime, timedelta, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import requests
from PIL import Image

from horizonator_tpu import tiles as jtiles
from horizonator_tpu import viewer as jviewer
from horizonator_tpu.annotate import peaks as jpeaks
from horizonator_tpu.annotate import scene as jscene
from horizonator_tpu.annotate import svg as jsvg
from horizonator_tpu_torch import _png
from horizonator_tpu_torch import tiles as ttiles
from horizonator_tpu_torch import viewer as tviewer
from horizonator_tpu_torch.annotate import peaks as tpeaks
from horizonator_tpu_torch.annotate import scene as tscene
from horizonator_tpu_torch.annotate import svg as tsvg
from horizonator_tpu_torch.render.texture import tile_xy_from_latlon

REPO = Path(__file__).resolve().parent.parent
TILES = (("jax", jtiles), ("torch", ttiles))
ELEMENTS = [{"lat": 34.5, "lon": -117.4, "tags": {"ele": "2800",
                                                  "name": "Peak A"}},
            {"lat": 34.6, "lon": -117.3, "tags": {"ele": "2400.5"}},
            {"lat": 34.7, "lon": -117.2, "tags": {"name": "no ele"}}]


def tile_png(seed, mode="RGB"):
    """A seeded 256x256 tile as PIL writes it (its filters and zlib)."""
    a = np.random.default_rng(seed).integers(0, 256, (256, 256, 3)).astype(
        np.uint8)
    buf = io.BytesIO()
    im = Image.fromarray(a)
    (im.quantize(64) if mode == "P" else im).save(buf, format="PNG")
    return buf.getvalue()


class Served:
    """A loopback HTTP server: GET ``routes[path]`` = (status, body,
    headers); POST answers ``post`` as JSON. Records every request as
    (method, path, User-Agent, Content-Type, body)."""

    def __init__(self, routes=None, post=None):
        self.routes = dict(routes or {})
        self.post = post
        self.seen = []
        served = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _answer(self, status, body, headers=()):
                self.send_response(status)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _record(self, body=b""):
                served.seen.append((self.command, self.path,
                                    self.headers.get("User-Agent"),
                                    self.headers.get("Content-Type"), body))

            def do_GET(self):
                self._record()
                self._answer(*served.routes.get(self.path, (404, b"")))

            def do_POST(self):
                self._record(self.rfile.read(
                    int(self.headers["Content-Length"])))
                if served.post is None:
                    self._answer(500, b"")
                else:
                    self._answer(200, json.dumps(served.post).encode(),
                                 [("Content-Type", "application/json")])

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        self.fmt = self.url + "/%d/%d/%d.png"
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.fixture
def served():
    servers = []

    def make(routes=None, post=None):
        servers.append(Served(routes, post))
        return servers[-1]

    yield make
    for s in servers:
        s.close()


def _http_date(days):
    return format_datetime(datetime.now(timezone.utc) + timedelta(days=days),
                           usegmt=True)


def test_fetch_tile_same_request_and_files(served, tmp_path):
    expires = _http_date(3)
    srv = served({"/12/700/1630.png": (200, tile_png(1),
                                       [("Expires", expires)]),
                  "/12/701/1630.png": (200, tile_png(2, "P"), [])})
    for side, mod in TILES:
        for x in (700, 701):
            p = mod.fetch_tile(str(tmp_path / side), "mapnik", srv.fmt, 12,
                               x, 1630, allow_downloads=True)
            assert p.read_bytes() == srv.routes[f"/12/{x}/1630.png"][1]
        assert not list(p.parent.glob("*.part"))
    jseen = [s[:3] for s in srv.seen[:2]]
    tseen = [s[:3] for s in srv.seen[2:]]
    assert tseen == jseen and tseen[0] == ("GET", "/12/700/1630.png",
                                           "horizonator")
    exp = [ttiles.tile_path(str(tmp_path / side), "mapnik", 12, 700, 1630)
           .with_name("1630.png.expires").read_text() for side, _ in TILES]
    assert exp[0] == exp[1] == (
        f"{ttiles._parse_expires({'Expires': expires}):.0f}\n")
    for side, _ in TILES:       # no Expires header: no record
        assert not ttiles.tile_path(str(tmp_path / side), "mapnik", 12, 701,
                                    1630).with_name(
                                        "1630.png.expires").exists()
    # the cached tiles decode alike: PIL in the JAX package, _png here
    for x in (700, 701):
        p = ttiles.tile_path(str(tmp_path / "torch"), "mapnik", 12, x, 1630)
        np.testing.assert_array_equal(ttiles._decode_tile_bgr(p),
                                      jtiles._decode_tile_bgr(p))


def _expired(root, side, body):
    p = ttiles.tile_path(str(root / side), "mapnik", 12, 700, 1630)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(body)
    p.with_name("1630.png.expires").write_text("1000\n")
    return p


def test_expired_tile_fetched_again(served, tmp_path):
    srv = served({"/12/700/1630.png": (200, tile_png(3), [])})
    for side, mod in TILES:
        p = _expired(tmp_path, side, b"old")
        assert mod.fetch_tile(str(tmp_path / side), "mapnik", srv.fmt, 12,
                              700, 1630, True) == p
        assert p.read_bytes() == tile_png(3)
        assert not p.with_name("1630.png.expires").exists()
        # not allowed to download: the stale copy, no request
        _expired(tmp_path, side, b"old")
        assert mod.fetch_tile(str(tmp_path / side), "mapnik", srv.fmt, 12,
                              700, 1630, False).read_bytes() == b"old"
    assert len(srv.seen) == 2


def test_failed_refresh_serves_stale(served, tmp_path, capsys):
    srv = served({"/12/700/1630.png": (500, b"", [])})
    for side, mod in TILES:
        p = _expired(tmp_path, side, b"stale")
        assert mod.fetch_tile(str(tmp_path / side), "mapnik", srv.fmt, 12,
                              700, 1630, True) == p
        assert p.read_bytes() == b"stale"
        err = capsys.readouterr().err
        assert "serving the stale copy" in err and "500" in err
    assert len(srv.seen) == 2


def test_missing_tile_404_raises(served, tmp_path):
    srv = served()
    raises = {"jax": requests.HTTPError, "torch": urllib.error.HTTPError}
    for side, mod in TILES:
        with pytest.raises(raises[side], match="404"):
            mod.fetch_tile(str(tmp_path / side), "mapnik", srv.fmt, 12, 700,
                           1630, True)
        assert not ttiles.tile_path(str(tmp_path / side), "mapnik", 12,
                                    700, 1630).parent.exists()


def test_build_atlas_downloads_and_placeholder(served, tmp_path):
    lat, lon, radius, cpd = 34.40, -117.45, 40, 1200
    x0, y0 = tile_xy_from_latlon(lat + radius / cpd, lon - radius / cpd, 12)
    x1, y1 = tile_xy_from_latlon(lat - radius / cpd, lon + radius / cpd, 12)
    coords = [(x, y) for y in range(y0, y1 + 1) for x in range(x0, x1 + 1)]
    assert len(coords) >= 2
    routes = {f"/12/{x}/{y}.png": (200, tile_png(x * 7 + y,
                                                 "P" if x % 2 else "RGB"), [])
              for x, y in coords[1:]}         # the first tile: 404
    srv = served(routes)
    kw = dict(tiles_url_fmt=srv.fmt, allow_downloads=True,
              on_error="placeholder")
    atlases = {side: mod.build_atlas(lat, lon, radius, cpd, -117.6, 34.2,
                                     dir_tiles=str(tmp_path / side), **kw)
               for side, mod in TILES}
    (aj, pj), (at, pt) = atlases["jax"], atlases["torch"]
    np.testing.assert_array_equal(at, aj)
    assert tuple(pt) == tuple(pj)
    assert (at[:256, :256] == 200).all()
    x, y = coords[1]
    c = (x - x0) * 256
    r = (y - y0) * 256
    want = np.asarray(Image.open(io.BytesIO(routes[f"/12/{x}/{y}.png"][1]))
                      .convert("RGB"))[:, :, ::-1]
    np.testing.assert_array_equal(at[r:r + 256, c:c + 256], want)
    with pytest.raises(urllib.error.HTTPError):
        ttiles.build_atlas(lat, lon, radius, cpd, -117.6, 34.2,
                           dir_tiles=str(tmp_path / "again"),
                           tiles_url_fmt=srv.fmt)


def test_viewer_tile_route_fetches(served, tmp_path):
    srv = served({"/12/700/1630.png": (200, tile_png(4), [])})
    got = {}
    for side, mod in (("jax", jviewer), ("torch", tviewer)):
        st = mod.ViewerState(None, 0.0, 45.0, 100.0, 1000.0,
                             tiles_url_fmt=srv.fmt,
                             dir_tiles=str(tmp_path / side))
        got[side] = (st.map_tile(12, 700, 1630), st.map_tile(12, 9, 9))
    assert got["torch"][0] == got["jax"][0] == tile_png(4)
    assert (tmp_path / "torch" / "mapnik" / "12" / "700" / "1630.png"
            ).read_bytes() == tile_png(4)
    # unavailable upstream: the same flat-gray placeholder's pixels
    np.testing.assert_array_equal(_png.decode_png(got["torch"][1]),
                                  _png.decode_png(got["jax"][1]))
    assert (_png.decode_png(got["torch"][1]) == 200).all()


def test_fetch_peaks_same_form_body(served):
    srv = served(post={"elements": ELEMENTS})
    got = [mod.fetch_peaks(34.4, -117.45, 25000.0, url=srv.url + "/api")
           for mod in (jpeaks, tpeaks)]
    assert got[1] == got[0] == tpeaks.parse_elements(ELEMENTS)
    (mj, pj, _, cj, bj), (mt, pt, _, ct, bt) = srv.seen
    assert (mt, pt, ct, bt) == (mj, pj, cj, bj)
    assert ct == "application/x-www-form-urlencoded"
    assert bt.startswith(b"data=%0A%5Bout%3Ajson%5D")
    bad = served()
    with pytest.raises(urllib.error.HTTPError, match="500"):
        tpeaks.fetch_peaks(34.4, -117.45, 25000.0, url=bad.url + "/api")


def _scene(mod, img):
    return mod.AnnotationScene(
        width=img.shape[1], height=img.shape[0], image_rgb=img,
        link_rects=[mod.LinkRect(1.0, 2.0, 14.0, 14.0,
                                 mod.caltopo_url(34.5, -117.4))],
        lines=[mod.Line(3.0, 4.0, 30.0, 5.5)],
        texts=[mod.Text(10.0, 20.0, "Peak <A> & B", 8.0,
                        url=mod.caltopo_url(34.5, -117.4)),
               mod.Text(50.0, 9.0, "90deg", 6.0, centered=True)])


_PAYLOAD = re.compile(r"data:image/png;base64,([A-Za-z0-9+/=]+)")


def test_svg_equal_outside_payload(tmp_path):
    img = np.random.default_rng(8).integers(0, 256, (37, 61, 3)).astype(
        np.uint8)
    svgs = {}
    for side, sc, sv in (("jax", jscene, jsvg), ("torch", tscene, tsvg)):
        sv.write_svg(_scene(sc, img), str(tmp_path / f"{side}.svg"))
        svgs[side] = (tmp_path / f"{side}.svg").read_text()
    rest = {side: _PAYLOAD.sub("PAYLOAD", s) for side, s in svgs.items()}
    assert rest["torch"] == rest["jax"] and "Peak &lt;A&gt; &amp; B" in \
        rest["torch"]
    pngs = {side: base64.b64decode(_PAYLOAD.search(s).group(1))
            for side, s in svgs.items()}
    for data in pngs.values():
        np.testing.assert_array_equal(_png.decode_png(data), img)
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), img)


def test_paths_without_pil_or_requests(served, tmp_path):
    """A fresh process with PIL and requests blocked: the atlas from a
    PIL-written cache, a download, the peaks and an SVG."""
    lat, lon, radius, cpd = 34.40, -117.45, 40, 1200
    x0, y0 = tile_xy_from_latlon(lat + radius / cpd, lon - radius / cpd, 12)
    x1, y1 = tile_xy_from_latlon(lat - radius / cpd, lon + radius / cpd, 12)
    for x in range(x0, x1 + 1):
        for y in range(y0, y1 + 1):
            p = ttiles.tile_path(str(tmp_path / "cache"), "mapnik", 12, x, y)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(tile_png(x + 3 * y, "P" if y % 2 else "RGB"))
    want, _ = jtiles.build_atlas(lat, lon, radius, cpd, -117.6, 34.2,
                                 dir_tiles=str(tmp_path / "cache"),
                                 allow_downloads=False)
    np.save(tmp_path / "want.npy", want)
    srv = served({"/12/5/6.png": (200, tile_png(5), [])},
                 post={"elements": ELEMENTS})
    code = f"""
import sys
sys.modules["PIL"] = None
sys.modules["requests"] = None
import numpy as np
from horizonator_tpu_torch import _png, tiles
from horizonator_tpu_torch.annotate import peaks, scene, svg
root = {str(tmp_path)!r}
atlas, _ = tiles.build_atlas({lat}, {lon}, {radius}, {cpd}, -117.6, 34.2,
                             dir_tiles=root + "/cache", allow_downloads=False)
assert np.array_equal(atlas, np.load(root + "/want.npy"))
p = tiles.fetch_tile(root + "/dl", "mapnik", {srv.fmt!r}, 12, 5, 6, True)
assert tiles._decode_tile_bgr(p).shape == (256, 256, 3)
assert [q["name"] for q in peaks.fetch_peaks(1.0, 2.0, 3.0,
                                             url={srv.url!r})] == \\
    ["Peak A", "2400m"]
img = np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3)
svg.write_svg(scene.AnnotationScene(width=7, height=5, image_rgb=img),
              root + "/out.svg")
assert "data:image/png;base64," in open(root + "/out.svg").read()
assert "jax" not in sys.modules
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                            "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")
    assert [s[1] for s in srv.seen] == ["/12/5/6.png", "/"]
