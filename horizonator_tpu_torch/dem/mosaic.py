"""Seamless DEM mosaic: the render window as one dense elevation grid.

numpy only; the grid is bit for bit the JAX package's loader's. Semantics
from the reference (dem.c):

- origin-cell math: ``icell_origin = floor(coord*cells_per_deg) - (R-1)``,
  split into the containing 1-degree tile and the cell offset inside it
  (dem.c:136-159);
- ``radius_m -> radius_cells`` through the worst-case east-west cell size
  (dem.c:106-127);
- neighboring tiles share one row/col (dem.c:161-171, 285-291);
- missing or zero-size tiles are elevation-0 "sea", with a warning for
  missing files only (dem.c:199-221);
- negative elevations clamp to 0 (dem.c:307-308); out-of-window point
  queries return -1 (dem.c:270, 293).

Tiles are read by the native loader (``_native``, one fused C++ pass a
tile) where it builds, else by numpy; both give the same grid. Missing
tiles may be fetched first from a URL template (``_fetch_dem``, stdlib
``urllib``) into ``datadir``.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field

import numpy as np

from . import hgt

RADIUS_CELLS_DEFAULT_PY = 1000  # horizonator-pywrap.c:65
EARTH_RADIUS_M = 6371000.0      # vertex.glsl:30


def _msg(fmt, *args):
    print("horizonator_tpu_torch:", fmt % args if args else fmt,
          file=sys.stderr)


def radius_cells_from_m(render_radius_m: float, viewer_lat: float,
                        cpd: int) -> int:
    """Render radius in meters -> grid cells (dem.c:106-127)."""
    cos_viewer_lat = math.cos(math.pi / 180.0 * viewer_lat)
    cell_m = EARTH_RADIUS_M * math.pi / 180.0 * cos_viewer_lat / cpd
    return int(0.5 + float(render_radius_m) / cell_m)


@dataclass
class DemMosaic:
    """A loaded ``(2R, 2R)`` elevation window addressed from its SW origin.

    ``grid[j, i]``: elevation in meters at cell (i east, j north), int16,
    native byte order, sea-level clamped; row 0 = SOUTH edge."""
    grid: np.ndarray
    radius_cells: int
    cells_per_deg: int
    origin_dem_lon_lat: tuple[int, int]   # 1-deg tile holding the SW corner
    origin_dem_cellij: tuple[int, int]    # cell offset of SW corner in it
    missing_tiles: list[str] = field(default_factory=list)

    @property
    def n(self) -> int:
        return 2 * self.radius_cells

    @property
    def origin_cell_lon_deg(self) -> float:
        """Longitude of grid cell i=0 (horizonator-lib.c:579-581)."""
        return (self.origin_dem_lon_lat[0]
                + self.origin_dem_cellij[0] / self.cells_per_deg)

    @property
    def origin_cell_lat_deg(self) -> float:
        """Latitude of grid cell j=0 (horizonator-lib.c:582-584)."""
        return (self.origin_dem_lon_lat[1]
                + self.origin_dem_cellij[1] / self.cells_per_deg)

    def viewer_cell(self, viewer_lat: float,
                    viewer_lon: float) -> tuple[float, float]:
        """Fractional grid coordinates of a lat/lon
        (horizonator-lib.c:765-770)."""
        i = ((viewer_lon - self.origin_dem_lon_lat[0]) * self.cells_per_deg
             - self.origin_dem_cellij[0])
        j = ((viewer_lat - self.origin_dem_lon_lat[1]) * self.cells_per_deg
             - self.origin_dem_cellij[1])
        return i, j

    def sample(self, i: int, j: int) -> int:
        """Point query; -1 outside the window (dem.c:270,293)."""
        if i < 0 or j < 0 or i >= self.n or j >= self.n:
            return -1
        return int(self.grid[j, i])

    def auto_viewer_z(self, viewer_lat: float, viewer_lon: float) -> float:
        """Max of the 4 surrounding cells + 1 m (horizonator-lib.c:775-789)."""
        ci, cj = self.viewer_cell(viewer_lat, viewer_lon)
        i0, j0 = math.floor(ci), math.floor(cj)
        return float(max(self.sample(i0, j0), self.sample(i0 + 1, j0),
                         self.sample(i0, j0 + 1), self.sample(i0 + 1, j0 + 1))
                     ) + 1.0

    def bounds_latlon_deg(self) -> tuple[float, float, float, float]:
        """(lat0, lon0, lat1, lon1) of first/last cells, INCLUSIVE
        (dem.c:313-330)."""
        cpd = self.cells_per_deg
        lon0 = self.origin_dem_lon_lat[0] + self.origin_dem_cellij[0] / cpd
        lat0 = self.origin_dem_lon_lat[1] + self.origin_dem_cellij[1] / cpd
        lon1 = (self.origin_dem_lon_lat[0]
                + (self.origin_dem_cellij[0] + 2 * self.radius_cells - 1) / cpd)
        lat1 = (self.origin_dem_lon_lat[1]
                + (self.origin_dem_cellij[1] + 2 * self.radius_cells - 1) / cpd)
        return lat0, lon0, lat1, lon1


# Default DEM download source for SRTM1: the public AWS terrain-tiles
# "skadi" bucket serves gzipped 3601^2 .hgt files. SRTM3 has no canonical
# free mirror of raw .hgt: pass an explicit dem_url_fmt for one.
DEM_URL_FMT_SRTM1 = ("https://s3.amazonaws.com/elevation-tiles-prod/"
                     "skadi/{ns}/{name}.gz")


def _fetch_dem(url_fmt: str, path, warn: bool = True) -> bool:
    """Download one missing .hgt tile into the cache dir. ``url_fmt`` may
    use printf ``%s`` (the filename) or format fields ``{name}``
    (N34W118.hgt) and ``{ns}`` (N34). Transparently unwraps gzip and
    zip payloads; writes atomically. Returns True on success."""
    import os
    import urllib.request
    name = path.name
    if "%s" in url_fmt:
        url = url_fmt % (name,)
    else:
        url = url_fmt.format(name=name, ns=name[:3])
    try:
        with urllib.request.urlopen(url, timeout=120) as r:   # raises on 4xx
            data = r.read()
        if data[:4] == b"PK\x03\x04":
            import io
            import zipfile
            with zipfile.ZipFile(io.BytesIO(data)) as z:
                members = [m for m in z.namelist()
                           if m.lower().endswith(".hgt")]
                if not members:
                    raise ValueError("no .hgt member in zip")
                # multi-tile archives (e.g. viewfinderpanoramas zips hold
                # a whole region): pick the member for THIS tile, never
                # just the first -- caching the wrong tile's elevations
                # would silently corrupt every later render
                want = name.lower()
                match = [m for m in members
                         if m.replace("\\", "/").rsplit("/", 1)[-1].lower()
                         == want]
                if not match:
                    if len(members) > 1:
                        raise ValueError(
                            f"zip has {len(members)} .hgt members, none "
                            f"named {name}")
                    match = members
                data = z.read(match[0])
        elif data[:2] == b"\x1f\x8b":
            import gzip
            data = gzip.decompress(data)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".part")
        tmp.write_bytes(data)
        os.replace(tmp, path)
        _msg("downloaded DEM %s (%d bytes)", name, len(data))
        return True
    except Exception as e:           # noqa: BLE001 -- degrade to sea+warning
        if warn:
            _msg("Warning: DEM download failed for '%s' (%s)", url, e)
        return False


def load_mosaic(viewer_lat: float, viewer_lon: float, *,
                render_radius_cells: int = -1,
                render_radius_m: float = -1.0,
                datadir: str | None = None,
                srtm1: bool = False,
                warn_missing: bool = True,
                dem_url_fmt: str | None = None) -> DemMosaic:
    """Load the DEM window centered on the viewer.

    Exactly one of render_radius_cells / render_radius_m must be > 0
    (dem.c:90-99). ``datadir`` defaults to ``~/.horizonator/DEMs_SRTM3`` or
    ``DEMs_SRTM1`` (horizonator-lib.c:94-97).

    ``dem_url_fmt``: when set, tiles missing from ``datadir`` are fetched
    from this URL template first (then cached on disk like the reference's
    manually-downloaded tiles); failures degrade to the usual sea+warning.
    See DEM_URL_FMT_SRTM1 and _fetch_dem for the template fields."""
    if (render_radius_cells > 0) == (render_radius_m > 0):
        raise ValueError("Exactly one of (render_radius_cells, "
                         "render_radius_m) must be > 0")
    if datadir is None:
        datadir = ("~/.horizonator/DEMs_SRTM1" if srtm1
                   else "~/.horizonator/DEMs_SRTM3")

    cpd = hgt.cells_per_deg(srtm1)
    if render_radius_cells > 0:
        radius = int(render_radius_cells)
    else:
        radius = radius_cells_from_m(render_radius_m, viewer_lat, cpd)

    # Origin-cell math per coordinate (dem.c:136-159); index 0 = lon, 1 = lat.
    origin_dem = [0, 0]
    origin_cell = [0, 0]
    ndems = [0, 0]
    for axis, coord in enumerate((viewer_lon, viewer_lat)):
        icell_origin = math.floor(coord * cpd) - (radius - 1)
        origin_coord = float(np.float32(icell_origin) / np.float32(cpd))
        origin_dem[axis] = math.floor(origin_coord)
        origin_cell[axis] = int(round((origin_coord - origin_dem[axis]) * cpd))
        # tiles spanned (dem.c:161-171): a last cell on the next tile's first
        # row is already the previous tile's overlap row
        cellij_last = origin_cell[axis] + radius * 2 - 1
        idem_last = cellij_last // cpd
        ndems[axis] = idem_last + 1
        if cellij_last == idem_last * cpd:
            ndems[axis] -= 1

    n = 2 * radius
    grid = np.zeros((n, n), dtype=np.int16)
    missing: list[str] = []
    wi0, wj0 = origin_cell

    from .. import _native
    native = _native.get_lib()

    def sea(path):
        missing.append(str(path))
        if warn_missing:
            _msg("Warning: couldn't open DEM file '%s'. Assuming "
                 "elevation=0 (sea surface?)", path)

    for tj in range(ndems[1]):
        for ti in range(ndems[0]):
            path = hgt.hgt_path(datadir, origin_dem[1] + tj,
                                origin_dem[0] + ti)
            if not path.exists() and dem_url_fmt:
                _fetch_dem(dem_url_fmt, path, warn=warn_missing)
            if not path.exists():
                sea(path)
                continue
            if native is not None:
                # fused native pass: decode+flip+clamp+window-copy
                rc = _native.blit_window(path, cpd + 1, grid,
                                         ti * cpd - wi0, tj * cpd - wj0)
                if rc == 0 or rc == 1:   # 1: zero-size -> silent sea
                    continue
                if rc == 2:
                    raise ValueError(
                        f"The DEM file '{path}' has unexpected size. Is this "
                        f"a {'1' if srtm1 else '3'}-arc-sec SRTM DEM?")
                if rc == 4:
                    # exists but unreadable (permissions, a race after the
                    # exists() check): warn and treat as sea like the
                    # reference's couldn't-open path (dem.c:199-208), not
                    # silently like a zero-size file
                    sea(path)
                    continue
                raise OSError(f"couldn't read DEM file '{path}' (rc={rc})")
            tile = hgt.read_hgt(path, srtm1)
            if tile is None:
                continue  # zero-size: silent sea, dem.c:210-221
            # tile (ti, tj) covers global cells [ti*cpd, ti*cpd + cpd]
            # inclusive; flip to south-first rows
            south_first = tile[::-1, :]
            gi0, gj0 = ti * cpd, tj * cpd
            ilo, ihi = max(gi0, wi0), min(gi0 + cpd, wi0 + n - 1)
            jlo, jhi = max(gj0, wj0), min(gj0 + cpd, wj0 + n - 1)
            if ilo > ihi or jlo > jhi:
                continue
            dst = south_first[jlo - gj0: jhi - gj0 + 1,
                              ilo - gi0: ihi - gi0 + 1].astype(np.int16)
            np.maximum(dst, 0, out=dst)
            grid[jlo - wj0: jhi - wj0 + 1, ilo - wi0: ihi - wi0 + 1] = dst

    return DemMosaic(grid=grid, radius_cells=radius, cells_per_deg=cpd,
                     origin_dem_lon_lat=(origin_dem[0], origin_dem[1]),
                     origin_dem_cellij=(origin_cell[0], origin_cell[1]),
                     missing_tiles=missing)
