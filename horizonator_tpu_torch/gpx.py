"""GPX track parsing + map overlay data.

The reference compiles in a GPX layer (florb/orb_gpxlayer.cpp:26-124,
tinyxml-parsed ``<trkpt lat lon>`` polyline drawn on the slippy map) even
though the horizonator tools never activate it. Here it is a live feature:
``load_gpx`` parses tracks with the stdlib, and the interactive viewer
draws them on the Leaflet map (``--gpx FILE``).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET


def load_gpx(path: str) -> list[list[tuple[float, float]]]:
    """Parse a GPX file into track segments: a list of [(lat, lon), ...]
    polylines (one per <trkseg>; <rte> routes are read too)."""
    root = ET.parse(path).getroot()

    def strip(tag):
        return tag.rsplit("}", 1)[-1]

    segs = []
    for el in root.iter():
        if strip(el.tag) not in ("trkseg", "rte"):
            continue
        pts = []
        for pt in el:
            if strip(pt.tag) in ("trkpt", "rtept"):
                try:
                    pts.append((float(pt.get("lat")), float(pt.get("lon"))))
                except (TypeError, ValueError):
                    continue
        if len(pts) >= 2:
            segs.append(pts)
    return segs
