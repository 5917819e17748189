"""POI projection + occlusion test against the range image.

Vectorized port of the reference's per-POI loop (annotator.c:279-348):
project each point of interest; gate its range to [MIN_MARKER_DIST,
MAX_MARKER_DIST]; then scan the range image vertically within +/-FUZZ_PIXEL_Y
rows of the predicted position for a rendered range within FUZZ_RANGE of the
predicted one ("the rendered peaks usually don't end up exactly where the POI
list says"), keeping the reference's early-exit semantics: track the
best-so-far error top-down and stop at the first row that's worse.
"""

from __future__ import annotations

import math

import numpy as np

from .. import geometry

MAX_MARKER_DIST = 100000.0   # annotator.c:19
MIN_MARKER_DIST = 500.0      # annotator.c:20
FUZZ_RANGE = 500.0           # annotator.c:22
FUZZ_PIXEL_Y = 6             # annotator.c:23


def project_and_occlusion_test(range_image: np.ndarray,
                               poi_lat, poi_lon, poi_ele,
                               lat: float, lon: float, ele_m: float,
                               az_deg0: float, az_deg1: float,
                               height_out: int, curv: float = 0.0):
    """Returns (keep mask, x, y_label) arrays over the POIs.

    ``y_label`` is the fuzz-adjusted crosshair row (crosshair_y + best fuzz),
    matching annotator.c:342-347.
    """
    h, w = range_image.shape
    poi_lat = np.asarray(poi_lat, np.float64)
    poi_lon = np.asarray(poi_lon, np.float64)
    poi_ele = np.asarray(poi_ele, np.float64)
    n = poi_lat.shape[0]
    if n == 0:
        z = np.zeros(0)
        return np.zeros(0, bool), z, z

    cos_lat = math.cos(math.radians(lat))
    x, y, range_have, vis = geometry.project(
        lat, cos_lat, lon, ele_m, poi_lat, poi_lon, poi_ele,
        math.radians(az_deg0), math.radians(az_deg1), w, h, curv=curv)
    x = x.numpy().astype(np.float64)
    y = y.numpy().astype(np.float64)
    range_have = range_have.numpy().astype(np.float64)
    vis = vis.numpy()

    # The reference checks az visibility in project() and el visibility via
    # the same +-1 ndc test; the fuzz loop then re-checks rows.
    gate = vis & (range_have >= MIN_MARKER_DIST) & (range_have <= MAX_MARKER_DIST)

    xi = np.clip(np.round(x).astype(np.int64), 0, w - 1)
    yi = np.round(y).astype(np.int64)

    # rows -6..+5: the reference's loop is `fuzz < FUZZ_PIXEL_Y` (exclusive
    # top, annotator.c:314) -- the asymmetry is deliberate parity, not an
    # off-by-one here
    fuzz = np.arange(-FUZZ_PIXEL_Y, FUZZ_PIXEL_Y)               # (12,)
    rows = yi[:, None] + fuzz[None, :]                          # (N,12)
    in_img = (rows >= 0) & (rows < height_out)
    rows_c = np.clip(rows, 0, h - 1)
    r = range_image[rows_c, xi[:, None]]                        # (N,12)
    valid = in_img & (r > 0.0)
    err = np.where(valid, np.abs(range_have[:, None] - r), np.inf)

    # Early-exit emulation (annotator.c:331-339): the scan stops at the first
    # row whose error exceeds the best seen so far; rows at/after that point
    # don't update the minimum. The reference also BREAKS (not continues) when
    # a row is below the image; rows past height_out therefore end the scan.
    below = (rows >= height_out)
    run_min = np.minimum.accumulate(np.where(np.isinf(err), np.inf, err), axis=1)
    prev_min = np.concatenate(
        [np.full((n, 1), np.inf), run_min[:, :-1]], axis=1)
    worse = valid & (err > prev_min)
    stopped = np.cumsum(worse | below, axis=1) > 0
    eff_err = np.where(stopped, np.inf, err)
    best = eff_err.min(axis=1)
    best_f = np.where(np.isfinite(best), fuzz[np.argmin(eff_err, axis=1)], 0)

    keep = gate & (best < FUZZ_RANGE)
    y_label = y + best_f
    return keep, x, y_label
