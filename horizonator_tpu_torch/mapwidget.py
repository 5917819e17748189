"""Vendored slippy-map widget: the viewer's map pane with zero CDN deps.

The port's own copy of horizonator_tpu.mapwidget; ``MAP_JS`` is the same
script. The reference GUI's map pane is the vendored florb widget
(florb/orb_mapctrl.cpp), which works fully OFFLINE from its tile cache
(orb_tilecache.cpp:89-124). This is a ~250-line vanilla-JS slippy map
exposing the small Leaflet API subset the viewer page uses
(``L.map``/``tileLayer``/``marker``/``circleMarker``/``polyline``/
``rectangle``/``layerGroup``, ``map.on('contextmenu')``, ``setView``,
``removeLayer``), served by the viewer's own HTTP server at ``/map.js``.
Tiles come from the viewer server's ``/tiles/{z}/{x}/{y}.png`` endpoint,
which serves the reference-layout disk cache (tiles.fetch_tile) -- so a
warm cache gives a fully offline session, and a failed tile renders flat
gray exactly like the GUI's placeholder path (orb_osmlayer.cpp:146-155).
"""

MAP_JS = r"""
// horizonator-tpu vendored map widget: a minimal Leaflet-compatible slippy
// map (pan, wheel zoom, markers, polylines, rectangles) in vanilla JS.
'use strict';
const L = (() => {

const TILE = 256;
const rad = d => d * Math.PI / 180;
const deg = r => r * 180 / Math.PI;
// spherical-mercator world pixels at zoom z (same equations as
// render/texture.py tile_xy_from_latlon)
function project(lat, lon, z) {
  const n = TILE * Math.pow(2, z);
  const x = (lon / 360 + 0.5) * n;
  const s = Math.sin(rad(Math.max(-85.05113, Math.min(85.05113, lat))));
  const y = (0.5 - Math.log((1 + s) / (1 - s)) / (4 * Math.PI)) * n;
  return [x, y];
}
function unproject(x, y, z) {
  const n = TILE * Math.pow(2, z);
  const lon = (x / n - 0.5) * 360;
  const t = Math.PI * (1 - 2 * y / n);
  const lat = deg(Math.atan(Math.sinh(t)));
  return {lat: lat, lng: lon};
}
const GRAY = 'data:image/gif;base64,R0lGODlhAQABAIAAAMzMzAAAACH5BAAAAAAALAAAAAABAAEAAAICRAEAOw==';

class Layer {
  addTo(map) { map._addLayer(this); return this; }
}
class Marker extends Layer {
  constructor(ll, style) { super(); this.ll = ll; this.style = style || {}; }
  _draw(map, svg) {
    const p = map._toScreen(this.ll[0], this.ll[1]);
    const g = document.createElementNS('http://www.w3.org/2000/svg', 'g');
    if (this.style.radius) {            // circleMarker
      g.innerHTML = `<circle cx="${p[0]}" cy="${p[1]}"` +
        ` r="${this.style.radius}" fill="none"` +
        ` stroke="${this.style.color || 'blue'}" stroke-width="2"/>`;
    } else {                            // pin marker
      g.innerHTML =
        `<line x1="${p[0]}" y1="${p[1]}" x2="${p[0]}" y2="${p[1] - 14}"` +
        ` stroke="#2563eb" stroke-width="3"/>` +
        `<circle cx="${p[0]}" cy="${p[1] - 17}" r="6" fill="#2563eb"` +
        ` stroke="white" stroke-width="2"/>`;
    }
    svg.appendChild(g);
  }
}
class Polyline extends Layer {
  constructor(pts, style) { super(); this.pts = pts; this.style = style || {}; }
  _draw(map, svg) {
    const d = this.pts.map((q, i) => {
      const p = map._toScreen(q[0], q[1]);
      return (i ? 'L' : 'M') + p[0].toFixed(1) + ' ' + p[1].toFixed(1);
    }).join('');
    const el = document.createElementNS('http://www.w3.org/2000/svg', 'path');
    el.setAttribute('d', d);
    el.setAttribute('fill', 'none');
    el.setAttribute('stroke', this.style.color || 'blue');
    el.setAttribute('stroke-width', this.style.weight || 2);
    if (this.style.dashArray)
      el.setAttribute('stroke-dasharray', this.style.dashArray);
    svg.appendChild(el);
  }
}
class Rectangle extends Polyline {
  constructor(b, style) {   // b = [[lat0,lon0],[lat1,lon1]]
    super([[b[0][0], b[0][1]], [b[0][0], b[1][1]],
           [b[1][0], b[1][1]], [b[1][0], b[0][1]],
           [b[0][0], b[0][1]]], style);
  }
}
class LayerGroup extends Layer {
  constructor(layers) { super(); this.layers = layers || []; }
  _draw(map, svg) { for (const l of this.layers) l._draw(map, svg); }
}

class MiniMap {
  constructor(el, opts) {
    this.el = typeof el === 'string' ? document.getElementById(el) : el;
    this.minZoom = (opts && opts.minZoom) || 0;
    this.maxZoom = (opts && opts.maxZoom) || 18;
    this.zoom = 11; this.lat = 0; this.lon = 0;
    this.tileUrl = null;
    this._layers = []; this._tiles = new Map(); this._events = {};
    const s = this.el.style;
    s.position = 'relative'; s.overflow = 'hidden';
    s.background = '#ddd'; s.cursor = 'grab'; s.userSelect = 'none';
    this.pane = document.createElement('div');
    this.pane.style.position = 'absolute';
    this.el.appendChild(this.pane);
    this.svg = document.createElementNS('http://www.w3.org/2000/svg', 'svg');
    const v = this.svg.style;
    v.position = 'absolute'; v.left = 0; v.top = 0;
    v.width = '100%'; v.height = '100%'; v.pointerEvents = 'none';
    this.el.appendChild(this.svg);
    this.attr = document.createElement('div');
    this.attr.style.cssText = 'position:absolute;right:2px;bottom:2px;' +
      'font:10px sans-serif;background:rgba(255,255,255,.7);padding:0 3px;';
    this.el.appendChild(this.attr);
    this._bind();
    new ResizeObserver(() => this._render()).observe(this.el);
  }
  on(ev, cb) { (this._events[ev] = this._events[ev] || []).push(cb); }
  _fire(ev, arg) { for (const cb of this._events[ev] || []) cb(arg); }
  setView(ll, z) {
    this.lat = ll[0]; this.lon = ll[1];
    if (z !== undefined)
      this.zoom = Math.max(this.minZoom, Math.min(this.maxZoom, z));
    this._render();
  }
  _addLayer(l) { this._layers.push(l); this._drawOverlays(); }
  removeLayer(l) {
    this._layers = this._layers.filter(x => x !== l);
    this._drawOverlays();
  }
  _toScreen(lat, lon) {   // lat/lon -> container px
    const c = project(this.lat, this.lon, this.zoom);
    const p = project(lat, lon, this.zoom);
    const r = this.el.getBoundingClientRect();
    return [p[0] - c[0] + r.width / 2, p[1] - c[1] + r.height / 2];
  }
  _fromScreen(clientX, clientY) {   // browser client coords -> latlng
    const c = project(this.lat, this.lon, this.zoom);
    const r = this.el.getBoundingClientRect();
    return unproject(c[0] + (clientX - r.left) - r.width / 2,
                     c[1] + (clientY - r.top) - r.height / 2, this.zoom);
  }
  _render() {
    if (!this.tileUrl) return;
    const r = this.el.getBoundingClientRect();
    if (!r.width || !r.height) return;
    const z = this.zoom, nmax = Math.pow(2, z) - 1;
    const c = project(this.lat, this.lon, z);
    const x0 = c[0] - r.width / 2, y0 = c[1] - r.height / 2;
    const tx0 = Math.floor(x0 / TILE), ty0 = Math.floor(y0 / TILE);
    const tx1 = Math.floor((x0 + r.width) / TILE);
    const ty1 = Math.floor((y0 + r.height) / TILE);
    const want = new Set();
    for (let ty = Math.max(0, ty0); ty <= Math.min(nmax, ty1); ty++)
      for (let tx = tx0; tx <= tx1; tx++) {
        const wx = ((tx % (nmax + 1)) + nmax + 1) % (nmax + 1);  // wrap lon
        const key = z + '/' + tx + '/' + ty;
        want.add(key);
        let img = this._tiles.get(key);
        if (!img) {
          img = document.createElement('img');
          img.width = TILE; img.height = TILE;
          img.style.position = 'absolute';
          img.draggable = false;
          img.onerror = () => { img.onerror = null; img.src = GRAY; };
          img.src = this.tileUrl.replace('{z}', z).replace('{x}', wx)
                                .replace('{y}', ty);
          this.pane.appendChild(img);
          this._tiles.set(key, img);
        }
        img.style.left = (tx * TILE - x0) + 'px';
        img.style.top = (ty * TILE - y0) + 'px';
      }
    for (const [key, img] of this._tiles)
      if (!want.has(key)) { img.remove(); this._tiles.delete(key); }
    this._drawOverlays();
  }
  _drawOverlays() {
    this.svg.innerHTML = '';
    for (const l of this._layers) l._draw(this, this.svg);
  }
  _bind() {
    let drag = null, moved = false;
    this.el.addEventListener('mousedown', e => {
      if (e.button !== 0) return;
      drag = [e.clientX, e.clientY]; moved = false;
      this.el.style.cursor = 'grabbing';
    });
    window.addEventListener('mousemove', e => {
      if (!drag) return;
      const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
      if (Math.abs(dx) + Math.abs(dy) < 3 && !moved) return;
      moved = true;
      drag = [e.clientX, e.clientY];
      const c = project(this.lat, this.lon, this.zoom);
      const ll = unproject(c[0] - dx, c[1] - dy, this.zoom);
      this.lat = ll.lat; this.lon = ll.lng;
      this._render();
    });
    window.addEventListener('mouseup', () => {
      drag = null; this.el.style.cursor = 'grab';
    });
    this.el.addEventListener('wheel', e => {
      e.preventDefault();
      const dz = e.deltaY < 0 ? 1 : -1;
      const z2 = Math.max(this.minZoom, Math.min(this.maxZoom,
                                                 this.zoom + dz));
      if (z2 === this.zoom) return;
      // zoom about the cursor: keep the latlng under it fixed
      const r = this.el.getBoundingClientRect();
      const sx = e.clientX - r.left, sy = e.clientY - r.top;
      const under = this._fromScreen(e.clientX, e.clientY);
      this.zoom = z2;
      const p = project(under.lat, under.lng, z2);
      const ll = unproject(p[0] - (sx - r.width / 2),
                           p[1] - (sy - r.height / 2), z2);
      this.lat = ll.lat; this.lon = ll.lng;
      this._render();
    }, {passive: false});
    this.el.addEventListener('contextmenu', e => {
      e.preventDefault();
      this._fire('contextmenu',
                 {latlng: this._fromScreen(e.clientX, e.clientY)});
    });
    this.el.addEventListener('dblclick', e => {
      this.setView([this.lat, this.lon], this.zoom + 1);
    });
  }
}

return {
  map: (el, opts) => new MiniMap(el, opts),
  tileLayer: (url, opts) => ({
    addTo: m => {
      m.tileUrl = url;
      if (opts && opts.attribution) m.attr.innerHTML = opts.attribution;
      m._render();
      return m;
    }}),
  marker: ll => new Marker(ll),
  circleMarker: (ll, style) => new Marker(ll, style),
  polyline: (pts, style) => new Polyline(pts, style),
  rectangle: (b, style) => new Rectangle(b, style),
  layerGroup: ls => new LayerGroup(ls),
};
})();
"""
