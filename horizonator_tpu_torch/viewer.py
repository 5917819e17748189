"""Interactive viewer: slippy map + live render, as a local web app.

The port's counterpart of horizonator_tpu.viewer, with the same page,
routes, JSON, clamps and fill modes. The reference's interactive layer is
an FLTK desktop app pairing the vendored florb map widget with a GL render
(horizonator.cc, florb/). Here a thin browser client drives the library
API: every camera move renders on ``--device`` (default ``cuda``: the
window march and resolve kernels, their textured entries for
``--hillshade``, ``--texture`` and the fill modes), the map pane is the
VENDORED widget in mapwidget.py (no CDN; tiles come from this server's
/tiles/ endpoint = the reference-layout disk cache, so a warm cache works
fully offline), the server is a small stdlib HTTP server, and frames are
PNG-encoded with the standard library (``_png``). Feature parity with the
reference's GUI:

- map right-click -> re-render from that point (horizonator.cc:390-415);
- render click -> pick: range-image unproject, marker on the map
  (horizonator.cc:342-359, horizonator-lib.c:1216-1296);
- wheel/drag azimuth pan-zoom with the az-radius clamp to [1, 179] deg
  (horizonator.cc:135-168);
- status bar showing the exact CLI command reproducing the view, with a copy
  button (horizonator.cc:56-99);
- the loaded-DEM extent rectangle on the map (slippymap-annotations.cc:40-59).

``render`` and ``pick`` hold the state's lock, so the kernels are built
and launched from one handler thread at a time, on that thread's current
stream.

Run: python -m horizonator_tpu_torch.viewer LAT LON [AZ_CENTER [AZ_RADIUS]]
     [--port 8080] [--device cuda|cpu] [--dirdems DIR] [--SRTM1] ...
"""

from __future__ import annotations

import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ._png import encode_png

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>horizonator-tpu</title>
<script src="/map.js"></script>
<style>
 body{margin:0;display:flex;flex-direction:column;height:100vh;font-family:sans-serif}
 #map{flex:1;min-height:200px}
 #pano-wrap{flex:1;min-height:150px;overflow:hidden;background:#001;position:relative}
 #pano{width:100%;height:100%;object-fit:fill;cursor:crosshair}
 #status{padding:4px 8px;background:#222;color:#eee;font-size:12px;display:flex;gap:8px;align-items:center}
 #cmd{flex:1;font-family:monospace;overflow:hidden;text-overflow:ellipsis;white-space:nowrap}
 button{font-size:12px}
</style></head><body>
<div id="map"></div>
<div id="pano-wrap"><img id="pano"/></div>
<div id="status"><span id="cmd"></span><button onclick="copyCmd()">copy</button>
<span id="busy"></span></div>
<script>
let S = null;           // view state from the server
const map = L.map('map', {minZoom:__ZOOM_MIN__, maxZoom:__ZOOM_MAX__});
L.tileLayer('__TILE_URL__',
            {maxZoom:__ZOOM_MAX__, attribution:'&copy; OSM'}).addTo(map);
let viewerMarker = null, pickMarker = null, demRect = null, fovLines = null;
let gpxDrawn = false;

function drawOverlays(){
  if(!S) return;
  if(viewerMarker) map.removeLayer(viewerMarker);
  viewerMarker = L.marker([S.lat, S.lon]).addTo(map);
  if(demRect) map.removeLayer(demRect);
  demRect = L.rectangle([[S.bounds[0],S.bounds[1]],[S.bounds[2],S.bounds[3]]],
                        {color:'red', weight:1, fill:false}).addTo(map);
  if(fovLines) map.removeLayer(fovLines);
  const R = 2.0;  // deg-ish ray length
  function ray(az){
    const r = az*Math.PI/180;
    return [[S.lat,S.lon],[S.lat+R*Math.cos(r), S.lon+R*Math.sin(r)/Math.cos(S.lat*Math.PI/180)]];
  }
  fovLines = L.layerGroup([
    L.polyline(ray(S.az_center-S.az_radius), {color:'blue',weight:1}),
    L.polyline(ray(S.az_center+S.az_radius), {color:'blue',weight:1}),
    L.polyline(ray(S.az_center), {color:'blue',weight:2,dashArray:'4'}),
  ]).addTo(map);
  if(!gpxDrawn && S.gpx && S.gpx.length){
    for(const seg of S.gpx)
      L.polyline(seg, {color:'purple', weight:2}).addTo(map);
    gpxDrawn = true;
  }
  let txt = S.command;
  if(S.debug) txt += '   [debug horizon: w to toggle]';
  if(S.texture_failed) txt += '   [tiles unavailable: untextured]';
  document.getElementById('cmd').textContent = txt;
}
function copyCmd(){ navigator.clipboard.writeText(S.command); }

async function call(path, body){
  // finally-clears the busy marker and surfaces errors in the status bar
  // instead of wedging the UI with a stuck hourglass and a null S
  document.getElementById('busy').textContent = '⏳';
  try {
    const r = await fetch(path, {method:'POST',
                                 body: JSON.stringify(body||{})});
    if (!r.ok) throw new Error(path + ' -> HTTP ' + r.status);
    return await r.json();
  } catch (err) {
    document.getElementById('cmd').textContent = 'render failed: ' + err;
    throw err;
  } finally {
    document.getElementById('busy').textContent = '';
  }
}
async function refresh(move){
  S = await call('/api/render', move);
  document.getElementById('pano').src = '/pano.png?t=' + Date.now();
  drawOverlays();
}
map.on('contextmenu', e => refresh({lat:e.latlng.lat, lon:e.latlng.lng}));
document.getElementById('pano').addEventListener('contextmenu', async e => {
  e.preventDefault();
  const img = e.target, r = img.getBoundingClientRect();
  const x = (e.clientX-r.left)/r.width, y = (e.clientY-r.top)/r.height;
  const j = await call('/api/pick', {x:x, y:y});
  if(j.hit){
    if(pickMarker) map.removeLayer(pickMarker);
    pickMarker = L.circleMarker([j.lat, j.lon], {radius:5, color:'red'}).addTo(map);
  }
});
// wheel: vertical = zoom the azimuth window, horizontal = pan the yaw
// (GLWidget::pan_and_zoom, horizonator.cc:141-168: the reference maps
// wheel-up/down to zoom and wheel-left/right to azimuth pan)
document.getElementById('pano-wrap').addEventListener('wheel', async e => {
  e.preventDefault();
  if(Math.abs(e.deltaX) > Math.abs(e.deltaY)){
    const daz = Math.sign(e.deltaX) * S.az_radius * 0.2;
    await refresh({az_center: S.az_center + daz});
  } else {
    const k = e.deltaY > 0 ? 1.25 : 0.8;
    await refresh({az_radius: S.az_radius * k});
  }
}, {passive:false});
let dragX = null;
document.getElementById('pano').addEventListener('mousedown', e => {if(e.button==0) dragX = e.clientX;});
window.addEventListener('mouseup', async e => {
  if(dragX === null) return;
  const img = document.getElementById('pano'), r = img.getBoundingClientRect();
  const daz = (dragX - e.clientX)/r.width * 2 * S.az_radius;
  dragX = null;
  if(Math.abs(daz) > 0.01) await refresh({az_center: S.az_center + daz});
});
// 'w': horizon-profile debug overlay; 'e': cycle fill modes
// normal -> wireframe -> point (the reference's GLUT debug keys,
// standalone.c:68-97 -- its 'w' cycles GL_FILL/GL_LINE/GL_POINT; here
// the DEM lattice rides the in-kernel texture path instead of a
// rasterizer state). 'r' (winding flip) has no rasterizer to flip.
window.addEventListener('keydown', async e => {
  if(e.key === 'w' && S) await refresh({debug: !S.debug});
  if(e.key === 'e' && S) {
    const next = S.fill === 'wireframe' ? 'point'
               : S.fill === 'point' ? '' : 'wireframe';
    await refresh({fill: next});
  }
});
// live viewport resize (horizonator_resized parity): render at the pane's
// real pixel size, debounced
let rszTimer = null;
new ResizeObserver(() => {
  if(!S) return;
  clearTimeout(rszTimer);
  rszTimer = setTimeout(async () => {
    const r = document.getElementById('pano-wrap').getBoundingClientRect();
    const w = Math.round(r.width), h = Math.round(r.height);
    if(Math.abs(w - S.width) > 16 || Math.abs(h - S.height) > 16)
      await refresh({width: w, height: h});
  }, 400);
}).observe(document.getElementById('pano-wrap'));
(async () => { await refresh({}); map.setView([S.lat, S.lon], 11); })();
</script></body></html>
"""


def leaflet_tile_url(tiles_url_fmt: str | None = None) -> str:
    """Slippy-tile URL template for the Leaflet client.

    With a ``--tiles NAME=FMT`` format string, the reference's printf-style
    ``%d/%d/%d`` placeholders (z, x, y order, horizonator.cc:448-457)
    convert to Leaflet's ``{z}/{x}/{y}``; otherwise the
    ``osm::tileserver`` settings.xml entry is used (the same source the
    reference map widget reads, orb_settings.cpp:41)."""
    if tiles_url_fmt:
        url = tiles_url_fmt
        for repl in ("{z}", "{x}", "{y}"):
            url = url.replace("%d", repl, 1)
        return url
    from .settings import instance
    server = instance().get("osm::tileserver",
                            "https://tile.openstreetmap.org/")
    return server.rstrip("/") + "/{z}/{x}/{y}.png"


class ViewerState:
    """Server-side scene: one horizonator instance + camera."""

    def __init__(self, h, az_center, az_radius, znear, zfar, gpx=None,
                 texture_failed=False, tiles_url_fmt=None,
                 dir_tiles=None, tiles_name=None):
        self.h = h
        self.az_center = float(az_center)
        self.az_radius = float(az_radius)
        self.znear = znear
        self.zfar = zfar
        self.gpx = gpx or []      # list of [(lat, lon), ...] polylines
        self.debug = False        # horizon-profile overlay (the 'w' key)
        self.fill = None          # None|'wireframe'|'point' (the 'e' key)
        self.texture_failed = bool(texture_failed)
        # map-client config: zoom limits from settings.xml
        # (osm::zoommin/zoommax, orb_settings.cpp:42-43 -> the map widget's
        # viewport clamps). The map pane loads tiles through THIS server's
        # /tiles/{z}/{x}/{y}.png endpoint -- the reference-layout disk
        # cache with fetch fallback -- so a warm cache keeps the whole
        # viewer working offline (orb_tilecache.cpp:89-124 parity).
        from .settings import instance
        from . import tiles as _tiles
        s = instance()
        self.tile_url = "/tiles/{z}/{x}/{y}.png"
        self.tiles_dir = (_tiles.DEFAULT_DIR_TILES if dir_tiles is None
                          else dir_tiles)
        self.tiles_name = (_tiles.DEFAULT_TILES_NAME if tiles_name is None
                           else tiles_name)
        self.tiles_url_fmt_upstream = (
            tiles_url_fmt if tiles_url_fmt
            else (_tiles._settings_url_fmt()
                  or _tiles.DEFAULT_TILES_URL_FMT))
        self.zoom_min = s.get("osm::zoommin", 0, type=int)
        self.zoom_max = s.get("osm::zoommax", 18, type=int)
        self.lock = threading.Lock()
        self.png = b""

    _GRAY_TILE = None

    def map_tile(self, z: int, x: int, y: int) -> bytes:
        """One map-pane tile: the florb cache-then-fetch contract
        (orb_tilecache.cpp:89-124 + orb_osmlayer.cpp:146-155). Serves the
        reference-layout disk cache, downloads on a miss, and degrades to
        a flat-gray placeholder when both fail -- the map pane never 404s
        and works fully offline from a warm cache."""
        from . import tiles as _tiles
        try:
            p = _tiles.fetch_tile(self.tiles_dir, self.tiles_name,
                                  self.tiles_url_fmt_upstream,
                                  int(z), int(x), int(y),
                                  allow_downloads=True)
            return p.read_bytes()
        except Exception:
            if ViewerState._GRAY_TILE is None:
                import numpy as np
                ViewerState._GRAY_TILE = encode_png(
                    np.full((256, 256, 3), 200, np.uint8))
            return ViewerState._GRAY_TILE

    def command(self):
        return (f"python -m horizonator_tpu_torch.viewer "
                f"{self.h.viewer_lat:.6f} "
                f"{self.h.viewer_lon:.6f} {self.az_center:.2f} "
                f"{self.az_radius:.2f}")

    def state_json(self):
        lat0, lon0, lat1, lon1 = self.h.mosaic.bounds_latlon_deg()
        return {
            "lat": self.h.viewer_lat, "lon": self.h.viewer_lon,
            "ele": self.h.viewer_z,
            "az_center": self.az_center, "az_radius": self.az_radius,
            "width": self.h.width, "height": self.h.height,
            "debug": self.debug,
            "fill": self.fill,
            "texture_failed": self.texture_failed,
            "bounds": [lat0, lon0, lat1, lon1],
            "command": self.command(),
            "gpx": self.gpx,
        }

    def render(self, move):
        with self.lock:
            if "az_radius" in move:
                # clamp like the reference (horizonator.cc:135-139)
                self.az_radius = min(179.0, max(1.0, float(move["az_radius"])))
            if "az_center" in move:
                self.az_center = float(move["az_center"])
            if "debug" in move:
                self.debug = bool(move["debug"])
            if "fill" in move:
                f = move["fill"] or None
                if f not in (None, "wireframe", "point"):
                    raise ValueError(f"bad fill mode {f!r}")
                self.fill = f
            if "width" in move or "height" in move:
                # live viewport resize (horizonator_resized,
                # horizonator-lib.c:838-856; exercised by glutReshapeFunc)
                w = int(move.get("width", self.h.width))
                hh = int(move.get("height", self.h.height))
                self.h.resized(min(max(w, 64), 8192), min(max(hh, 32), 4096))
            kw = {}
            if "lat" in move and "lon" in move:
                kw = dict(lat=float(move["lat"]), lon=float(move["lon"]))
            image = self.h.render(self.az_center - self.az_radius,
                                  self.az_center + self.az_radius,
                                  return_range=False,
                                  znear=self.znear, zfar=self.zfar,
                                  debug_fill=self.fill, **kw)
            if self.debug:
                image = self._overlay_horizon(image)
            self.png = encode_png(image[:, :, ::-1])     # BGR -> RGB
            return self.state_json()

    def _overlay_horizon(self, image_bgr):
        """Debug view: trace the horizon (first visible row per column) in
        green over the render -- the TPU-native answer to the reference's
        'w' wireframe/point fill modes (standalone.c:68-97), which
        visualized the geometry the z-buffer resolved. Uses the range image
        of the render that just ran."""
        import numpy as np
        ranges = self.h._last_ranges()
        vis = ranges > 0
        any_vis = vis.any(axis=0)
        first = vis.argmax(axis=0)
        img = image_bgr.copy()
        cols = np.nonzero(any_vis)[0]
        img[first[cols], cols] = (0, 255, 0)     # BGR green
        below = np.minimum(first + 1, img.shape[0] - 1)
        img[below[cols], cols] = (0, 255, 0)
        return img

    def pick(self, xf, yf):
        with self.lock:
            x = int(xf * self.h.width)
            y = int(yf * self.h.height)
            x = min(max(x, 0), self.h.width - 1)
            y = min(max(y, 0), self.h.height - 1)
            out = self.h.pick(x, y)
            if out is None:
                return {"hit": False}
            return {"hit": True, "lat": out[0], "lon": out[1]}


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                page = (_PAGE
                        .replace("__TILE_URL__", state.tile_url)
                        .replace("__ZOOM_MIN__", str(state.zoom_min))
                        .replace("__ZOOM_MAX__", str(state.zoom_max)))
                self._send(200, page.encode(), "text/html; charset=utf-8")
            elif self.path.startswith("/pano.png"):
                self._send(200, state.png, "image/png")
            elif self.path == "/map.js":
                # the vendored slippy-map widget: zero CDN deps (florb
                # self-containment parity)
                from .mapwidget import MAP_JS
                self._send(200, MAP_JS.encode(),
                           "application/javascript; charset=utf-8")
            elif self.path.startswith("/tiles/"):
                try:
                    z, x, y = self.path[len("/tiles/"):].split("?")[0] \
                        .removesuffix(".png").split("/")
                    body = state.map_tile(int(z), int(x), int(y))
                except (ValueError, TypeError):
                    self._send(404, b"{}")
                    return
                self._send(200, body, "image/png")
            elif self.path.startswith("/api/state"):
                self._send(200, json.dumps(state.state_json()).encode())
            else:
                self._send(404, b"{}")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if self.path == "/api/render":
                self._send(200, json.dumps(state.render(body)).encode())
            elif self.path == "/api/pick":
                self._send(200, json.dumps(
                    state.pick(float(body.get("x", 0.5)),
                               float(body.get("y", 0.5)))).encode())
            else:
                self._send(404, b"{}")

    return Handler


def serve(state: ViewerState, port: int = 8080, *, poll=None):
    httpd = ThreadingHTTPServer(("127.0.0.1", port), make_handler(state))
    print(f"horizonator-tpu-torch viewer: http://127.0.0.1:{port}/",
          flush=True)
    try:
        httpd.serve_forever(poll_interval=poll or 0.5)
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def main(argv=None) -> int:
    import argparse
    from .api import horizonator, ZNEAR_DEFAULT, ZFAR_DEFAULT

    p = argparse.ArgumentParser(prog="horizonator-tpu-torch-viewer")
    p.add_argument("lat", type=float)
    p.add_argument("lon", type=float)
    p.add_argument("az_center", type=float, nargs="?", default=0.0)
    p.add_argument("az_radius", type=float, nargs="?", default=45.0)
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--width", type=int, default=1200)
    p.add_argument("--height", type=int, default=400)
    p.add_argument("--dirdems", type=str, default=None)
    p.add_argument("--SRTM1", action="store_true")
    p.add_argument("--curvature",
                   choices=["none", "spherical", "refracted"],
                   default="none")
    p.add_argument("--texture", action="store_true")
    p.add_argument("--hillshade", action="store_true",
                   help="Lambertian sun shading from the DEM (no tiles)")
    p.add_argument("--sun-az", type=float, default=315.0, dest="sun_az")
    p.add_argument("--sun-alt", type=float, default=45.0, dest="sun_alt")
    p.add_argument("--shadows", action="store_true",
                   help="with --hillshade: cast terrain shadows")
    p.add_argument("--sun-time", type=str, default=None, dest="sun_time",
                   metavar="ISO8601", help="astronomical sun for this UTC "
                                           "time (overrides az/alt)")
    p.add_argument("--dirtiles", type=str, default=None)
    p.add_argument("--tiles", type=str, default=None, metavar="NAME=FMT",
                   help="tile set name and printf-style URL format "
                        "(z, x, y %%d placeholders), like the reference "
                        "GUI's --tiles (horizonator.cc:448-457); also "
                        "drives the slippy-map layer")
    p.add_argument("--allow-tile-downloads", action="store_true",
                   dest="allow_downloads")
    p.add_argument("--znear", type=float, default=ZNEAR_DEFAULT)
    p.add_argument("--zfar", type=float, default=ZFAR_DEFAULT)
    p.add_argument("--gpx", type=str, default=None,
                   help="GPX file; tracks drawn on the map "
                        "(florb orb_gpxlayer parity)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the render (default cuda; cpu runs "
                        "the kernels' plain versions)")
    args = p.parse_args(argv)

    gpx = None
    if args.gpx:
        from .gpx import load_gpx
        gpx = load_gpx(args.gpx)

    tiles_name = tiles_url_fmt = None
    if args.tiles:
        if "=" not in args.tiles:
            p.error("--tiles wants NAME=FMT")
        tiles_name, tiles_url_fmt = args.tiles.split("=", 1)

    kw = dict(render_texture=args.texture, SRTM1=args.SRTM1,
              dir_dems=args.dirdems, dir_tiles=args.dirtiles,
              tiles_name=tiles_name, tiles_url_fmt=tiles_url_fmt,
              allow_downloads=args.allow_downloads,
              render_radius_m=args.zfar,
              curvature=args.curvature,
              hillshade=args.hillshade, sun_az_deg=args.sun_az,
              sun_alt_deg=args.sun_alt, sun_time=args.sun_time,
              shadows=args.shadows, device=args.device,
              # per-tile failures become gray placeholders + warnings
              # (reference GUI behavior, orb_osmlayer.cpp:146-155)
              texture_on_error="placeholder")
    texture_failed = False
    try:
        h = horizonator(args.lat, args.lon, args.width, args.height, **kw)
    except Exception as e:
        if not args.texture:
            raise
        # total texture failure (no cache, downloads off/unreachable):
        # warn and keep the session alive untextured instead of dying
        print(f"horizonator_tpu_torch: texture atlas unavailable ({e}); "
              f"falling back to untextured render", file=sys.stderr)
        kw["render_texture"] = False
        texture_failed = True
        h = horizonator(args.lat, args.lon, args.width, args.height, **kw)
    state = ViewerState(h, args.az_center, args.az_radius,
                        args.znear, args.zfar, gpx=gpx,
                        texture_failed=texture_failed,
                        tiles_url_fmt=tiles_url_fmt,
                        dir_tiles=args.dirtiles, tiles_name=tiles_name)
    state.render({})
    serve(state, args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
