"""Slippy-map tile fetch/cache and texture-atlas assembly (host side).

A copy of horizonator_tpu.tiles for the port, which must not import the
JAX package. The reference's disk-cache layout
``{dir_tiles}/{name}/{z}/{x}/{y}.png`` is kept (horizonator-lib.c:272-275).
PIL decodes tiles and ``requests`` downloads them; both are imported only
when a tile is decoded or fetched, so a cache-free ``allow_downloads=False``
call needs neither. With no URL format given, the florb ``settings.xml``
tile server (``settings.py``) applies when the user set one.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import sys
from pathlib import Path

import numpy as np

from ..dem.hgt import expand_user_dir
from ..render.texture import (AtlasParams, OSM_RENDER_ZOOM, OSM_TILE_PX,
                              tile_xy_from_latlon)

DEFAULT_TILES_NAME = "mapnik"                                     # horizonator-lib.c:91
DEFAULT_TILES_URL_FMT = "https://a.tile.openstreetmap.org/%d/%d/%d.png"  # :93


def _settings_url_fmt():
    """The florb settings.xml tileserver (osm::tileserver,
    orb_settings.cpp:41) as a %d/%d/%d.png format, if the user set one."""
    try:
        from ..settings import instance
        base = instance().get("osm::tileserver", None)
    except Exception:
        return None
    if not base or "openstreetmap.org" in base:
        return None         # default server: keep the reference URL format
    return base.rstrip("/") + "/%d/%d/%d.png"
DEFAULT_DIR_TILES = "~/.horizonator/tiles"                        # :101
USER_AGENT = "horizonator"                                        # :314


def _msg(fmt, *args):
    print("horizonator_tpu_torch:", fmt % args if args else fmt,
          file=sys.stderr)


def tile_path(dir_tiles: str, tiles_name: str, zoom: int, x: int,
              y: int) -> Path:
    return (Path(expand_user_dir(dir_tiles)) / tiles_name / str(zoom)
            / str(x) / f"{y}.png")


def _expires_path(p: Path) -> Path:
    return p.with_name(p.name + ".expires")


def _parse_expires(headers) -> float | None:
    """Epoch seconds from an HTTP ``Expires`` header
    (orb_tileserver.cpp:149-185)."""
    raw = headers.get("Expires")
    if not raw:
        return None
    from email.utils import parsedate_to_datetime
    try:
        return parsedate_to_datetime(raw).timestamp()
    except (TypeError, ValueError):
        return None


def tile_is_stale(p: Path) -> bool:
    """True when the tile's recorded expiry has passed; tiles without one
    are fresh forever (orb_tilecache.cpp:41)."""
    import time
    ep = _expires_path(p)
    if not ep.exists():
        return False
    try:
        return time.time() > float(ep.read_text().strip())
    except (OSError, ValueError):
        return False


def fetch_tile(dir_tiles: str, tiles_name: str, tiles_url_fmt: str,
               zoom: int, x: int, y: int, allow_downloads: bool) -> Path:
    """On-disk path of one tile, downloading if permitted. An expired tile
    is re-downloaded, and served stale with a warning if that fails.
    Raises FileNotFoundError when missing and downloads are disallowed
    (horizonator-lib.c:283-289)."""
    p = tile_path(dir_tiles, tiles_name, zoom, x, y)
    have = p.exists()
    stale = have and allow_downloads and tile_is_stale(p)
    if have and not stale:
        return p
    if not allow_downloads:
        if have:
            return p
        raise FileNotFoundError(
            f"Tile '{p}' doesn't exist on disk, and downloads aren't allowed")
    import requests
    url = tiles_url_fmt % (zoom, x, y)
    try:
        r = requests.get(url, headers={"User-Agent": USER_AGENT}, timeout=30)
        r.raise_for_status()
    except Exception as e:
        if have:
            _msg("Warning: refresh of expired tile '%s' failed (%s); "
                 "serving the stale copy", p, e)
            return p
        raise
    p.parent.mkdir(parents=True, exist_ok=True)
    # atomic publish: a process killed mid-write leaves no truncated PNG
    tmp = p.with_suffix(f"{p.suffix}.{os.getpid()}.part")
    tmp.write_bytes(r.content)
    os.replace(tmp, p)
    exp = _parse_expires(r.headers)
    ep = _expires_path(p)
    if exp is not None:
        ep.write_text(f"{exp:.0f}\n")
    elif ep.exists():
        ep.unlink()
    return p


def _decode_tile_bgr(path: Path) -> np.ndarray:
    """Decode a 256x256 tile to uint8 BGR (de-palettizing, like
    horizonator-lib.c:339-352)."""
    from PIL import Image
    im = Image.open(path).convert("RGB")
    arr = np.asarray(im, dtype=np.uint8)
    if arr.shape[:2] != (OSM_TILE_PX, OSM_TILE_PX):
        raise ValueError(f"tile {path} has shape {arr.shape}, expected "
                         "256x256")
    return arr[:, :, ::-1]


def build_atlas(viewer_lat: float, viewer_lon: float, radius_cells: int,
                cells_per_deg: int,
                origin_cell_lon_deg: float, origin_cell_lat_deg: float, *,
                dir_tiles: str | None = None,
                tiles_name: str | None = None,
                tiles_url_fmt: str | None = None,
                allow_downloads: bool = True,
                zoom: int = OSM_RENDER_ZOOM,
                max_workers: int = 8,
                on_error: str = "raise") -> tuple[np.ndarray, AtlasParams]:
    """Assemble the texture atlas covering the DEM window: the tile range
    from the viewer +- radius corners (horizonator-lib.c:373-400), rows
    from the NORTH edge. ``on_error``: 'raise' propagates the first tile
    failure; 'placeholder' warns and fills that tile flat gray
    (orb_osmlayer.cpp:146-155).

    Returns (atlas uint8 (Hat, Wat, 3) BGR, AtlasParams)."""
    if on_error not in ("raise", "placeholder"):
        raise ValueError(f"on_error must be 'raise'|'placeholder', "
                         f"got {on_error!r}")
    dir_tiles = DEFAULT_DIR_TILES if dir_tiles is None else dir_tiles
    tiles_name = DEFAULT_TILES_NAME if tiles_name is None else tiles_name
    tiles_url_fmt = ((_settings_url_fmt() or DEFAULT_TILES_URL_FMT)
                     if tiles_url_fmt is None else tiles_url_fmt)

    lowest_e = viewer_lon - radius_cells / cells_per_deg
    lowest_n = viewer_lat - radius_cells / cells_per_deg
    highest_e = viewer_lon + radius_cells / cells_per_deg
    highest_n = viewer_lat + radius_cells / cells_per_deg

    # ytile decreases with lat (horizonator-lib.c:380-386)
    x_lo, y_lo = tile_xy_from_latlon(highest_n, lowest_e, zoom)
    x_hi, y_hi = tile_xy_from_latlon(lowest_n, highest_e, zoom)
    ntx = x_hi - x_lo + 1
    nty = y_hi - y_lo + 1

    atlas = np.zeros((nty * OSM_TILE_PX, ntx * OSM_TILE_PX, 3), np.uint8)
    placeholder = np.full((OSM_TILE_PX, OSM_TILE_PX, 3), 200, np.uint8)
    failed = []

    def work(xy):
        x, y = xy
        try:
            p = fetch_tile(dir_tiles, tiles_name, tiles_url_fmt, zoom, x, y,
                           allow_downloads)
            return x, y, _decode_tile_bgr(p)
        except Exception as e:
            if on_error == "raise":
                raise
            failed.append((x, y))
            _msg("Warning: tile %d/%d/%d unavailable (%s); using flat gray",
                 zoom, x, y, e)
            return x, y, placeholder

    coords = [(x, y) for y in range(y_lo, y_hi + 1)
              for x in range(x_lo, x_hi + 1)]
    with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
        for x, y, tile in ex.map(work, coords):
            r0 = (y - y_lo) * OSM_TILE_PX
            c0 = (x - x_lo) * OSM_TILE_PX
            atlas[r0:r0 + OSM_TILE_PX, c0:c0 + OSM_TILE_PX] = tile
    if failed:
        _msg("Warning: %d of %d atlas tiles unavailable", len(failed),
             len(coords))

    params = AtlasParams(origin_cell_lon_deg=origin_cell_lon_deg,
                         origin_cell_lat_deg=origin_cell_lat_deg,
                         osmtile_lowest_x=x_lo, osmtile_lowest_y=y_lo,
                         ntiles_x=ntx, ntiles_y=nty, zoom=zoom)
    return atlas, params
