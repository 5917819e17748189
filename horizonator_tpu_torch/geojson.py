"""Dependency-free GeoJSON / CSV writers for the vector products.

The host copy of horizonator_tpu.geojson (that package's import pulls in
JAX): the geolocated skyline ridgeline (``api.horizonator.skyline``), the
visible-peaks report (``api.horizonator.visible_peaks``) and sight lines
(ops/los.py) as RFC 7946 GeoJSON (coordinates are [lon, lat], WGS84, the
only CRS the spec allows) or flat CSV. QGIS / geojson.io / Leaflet open
both directly. The text is byte for byte the JAX package's.

No reference analog: the reference's only geometry read-back is the
per-pixel pick (horizonator-lib.c:1216-1296). Writes are atomic
(tmp + rename), matching the tile-cache and GeoTIFF writers.
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["skyline_geojson", "skyline_csv", "line_geojson",
           "points_geojson"]


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


def points_geojson(lat, lon, path=None, *, properties=None) -> str:
    """(N,) lat/lon -> a FeatureCollection of Point features.

    ``properties``: a list of N dicts (one per point) or one dict applied
    to all. Used for the visible-peaks report (api.visible_peaks).
    """
    lat = np.asarray(lat, np.float64).ravel()
    lon = np.asarray(lon, np.float64).ravel()
    if lat.shape != lon.shape:
        raise ValueError(f"lat {lat.shape} vs lon {lon.shape}")
    feats = []
    for k in range(lat.shape[0]):
        props = (properties[k] if isinstance(properties, (list, tuple))
                 else dict(properties or {}))
        feats.append({"type": "Feature",
                      "geometry": {"type": "Point",
                                   "coordinates": [round(float(lon[k]), 7),
                                                   round(float(lat[k]), 7)]},
                      "properties": props})
    text = json.dumps({"type": "FeatureCollection", "features": feats},
                      separators=(",", ":"))
    if path is not None:
        _atomic_write_text(path, text)
    return text


def line_geojson(lat, lon, path=None, *, properties=None) -> str:
    """Arbitrary lat/lon polyline(s) -> GeoJSON (e.g. ops.los sightlines).

    ``lat``/``lon``: (N,) for one LineString or (B, N) for B features.
    ``properties``: dict applied to every feature, or a list of B dicts.
    """
    lat = np.atleast_2d(np.asarray(lat, np.float64))
    lon = np.atleast_2d(np.asarray(lon, np.float64))
    if lat.shape != lon.shape:
        raise ValueError(f"lat {lat.shape} vs lon {lon.shape}")
    feats = []
    for b in range(lat.shape[0]):
        props = (properties[b] if isinstance(properties, (list, tuple))
                 else dict(properties or {}))
        coords = [[round(float(lo), 7), round(float(la), 7)]
                  for la, lo in zip(lat[b], lon[b])]
        feats.append({"type": "Feature",
                      "geometry": {"type": "LineString",
                                   "coordinates": coords},
                      "properties": props})
    text = json.dumps({"type": "FeatureCollection", "features": feats},
                      separators=(",", ":"))
    if path is not None:
        _atomic_write_text(path, text)
    return text
