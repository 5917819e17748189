"""Dependency-free GeoJSON / CSV writers for the skyline.

The host copy of horizonator_tpu.geojson's skyline writers (that package's
import pulls in JAX): the geolocated skyline ridgeline
(``api.horizonator.skyline``) as RFC 7946 GeoJSON (coordinates are [lon,
lat], WGS84, the only CRS the spec allows) or flat CSV. QGIS / geojson.io
/ Leaflet open both directly.

No reference analog: the reference's only geometry read-back is the
per-pixel pick (horizonator-lib.c:1216-1296). Writes are atomic
(tmp + rename), matching the tile-cache and GeoTIFF writers.
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["skyline_geojson", "skyline_csv"]


def _atomic_write_text(path, text):
    tmp = str(path) + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(text)
    os.replace(tmp, path)


def _round(a, nd):
    return [round(float(v), nd) for v in np.asarray(a).ravel()]


def skyline_geojson(sky, path=None, *, properties=None) -> str:
    """``skyline()`` dict -> a GeoJSON FeatureCollection string.

    One LineString Feature tracing the horizon ridgeline (coordinates
    [lon, lat] per RFC 7946 section 3.1.1), with the per-vertex scalars
    (``az_deg``/``el_deg``/``dist_m``) carried as parallel list properties
    -- GeoJSON has no per-vertex attributes, and M-coordinates are not
    portable, so parallel arrays are the interoperable encoding.
    ``properties``: extra key/values merged into the feature (e.g. the
    viewer position). Writes atomically when ``path`` is given.
    """
    props = {
        "kind": "horizonator_tpu.skyline",
        "az_deg": _round(sky["az_deg"], 4),
        "el_deg": _round(sky["el_deg"], 4),
        "dist_m": _round(sky["dist_m"], 1),
    }
    if properties:
        props.update(properties)
    coords = [[round(float(lo), 7), round(float(la), 7)]
              for la, lo in zip(np.asarray(sky["lat"]).ravel(),
                                np.asarray(sky["lon"]).ravel())]
    doc = {"type": "FeatureCollection",
           "features": [{"type": "Feature",
                         "geometry": {"type": "LineString",
                                      "coordinates": coords},
                         "properties": props}]}
    text = json.dumps(doc, separators=(",", ":"))
    if path is not None:
        _atomic_write_text(path, text)
    return text


def skyline_csv(sky, path=None) -> str:
    """``skyline()`` dict -> CSV text (az_deg,el_deg,dist_m,lat,lon rows)."""
    cols = ("az_deg", "el_deg", "dist_m", "lat", "lon")
    arrs = [np.asarray(sky[c]).ravel() for c in cols]
    lines = [",".join(cols)]
    for row in zip(*arrs):
        lines.append("%.4f,%.4f,%.1f,%.7f,%.7f" % row)
    text = "\n".join(lines) + "\n"
    if path is not None:
        _atomic_write_text(path, text)
    return text
