"""Plain reference of the DEM window that a renderer loads around a viewer.

The upstream's rules (dem.c): a (2R, 2R) window whose SW corner cell is
``floor(coord * cpd) - (R - 1)`` on each axis, taken from the mosaic of
1-degree tiles that share their edge rows; grid row 0 is south; the viewer
stands 1 m above the highest of its four surrounding cells.
"""

from __future__ import annotations

import math

import numpy as np


class Window:
    """The window of a mosaic (row 0 south, SW corner at integer degrees
    ``sw_lat``, ``sw_lon``) around (lat0, lon0), ``radius`` cells."""

    def __init__(self, mosaic, sw_lat, sw_lon, cpd, lat0, lon0, radius):
        origin_dem, origin_cell = [0, 0], [0, 0]
        for axis, coord in enumerate((lon0, lat0)):
            icell = math.floor(coord * cpd) - (radius - 1)
            oc = float(np.float32(icell) / np.float32(cpd))
            origin_dem[axis] = math.floor(oc)
            origin_cell[axis] = int(round((oc - origin_dem[axis]) * cpd))
        self.cpd = cpd
        self.origin_dem = origin_dem
        self.origin_cell = origin_cell
        n = 2 * radius
        gi = (origin_dem[0] - sw_lon) * cpd + origin_cell[0]
        gj = (origin_dem[1] - sw_lat) * cpd + origin_cell[1]
        grid = np.zeros((n, n), np.int16)
        si, sj = max(gi, 0), max(gj, 0)
        ei = min(gi + n, mosaic.shape[1])
        ej = min(gj + n, mosaic.shape[0])
        if si < ei and sj < ej:
            grid[sj - gj:ej - gj, si - gi:ei - gi] = mosaic[sj:ej, si:ei]
        self.grid = np.maximum(grid, 0)

    def cell(self, lat, lon):
        """Fractional (i, j) of a lat/lon in the window."""
        return ((lon - self.origin_dem[0]) * self.cpd - self.origin_cell[0],
                (lat - self.origin_dem[1]) * self.cpd - self.origin_cell[1])

    def lat_of(self, cj) -> float:
        """Latitude of fractional grid row cj."""
        return self.origin_dem[1] + (self.origin_cell[1] + cj) / self.cpd

    def ground_z(self, ci, cj) -> float:
        """The highest of the four cells around (ci, cj), -1 outside."""
        i0, j0 = math.floor(ci), math.floor(cj)
        n = self.grid.shape[0]

        def at(i, j):
            return int(self.grid[j, i]) if 0 <= i < n and 0 <= j < n else -1
        return float(max(at(i0, j0), at(i0 + 1, j0), at(i0, j0 + 1),
                         at(i0 + 1, j0 + 1)))

    def viewer_z(self, lat, lon) -> float:
        return self.ground_z(*self.cell(lat, lon)) + 1.0
