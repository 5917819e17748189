"""Seeded slippy-map tiles and the PNG cache writer, for the textured cells.

The upstream renderer textures its terrain with OpenStreetMap tiles at zoom
12, 256 px each, read from ``{dir}/{name}/{z}/{x}/{y}.png``
(horizonator-lib.c:25-27, :272-275). The repository holds no real tile, so
a run writes its own, from the seed, over the tile range that the upstream
computes around the viewer (``tile_range``: horizonator-lib.c:225-245,
:373-400). Their content is map-like and continuous across tile edges,
in global texel coordinates:

- land-use regions, ~1 km across: on blocks of 4 x 4 texels, the nearest
  site of a jittered 32-texel grid, each site one of 48 map colours;
  three quarters of those colours are "textured" (forest, scrub,
  farmland), whose texels take one of four shades a few levels apart, as
  a map's patterns do;
- roads: seeded straight lines 2-4 texels wide across the whole range,
  ~80 texels apart each way, in 16 road colours.

Every tile is a 256-colour palette image (64 colours x 4 shades). Tiles
with x + y odd are written as 8-bit palette PNGs and the others as 8-bit
RGB, each with its rows' filters cycling through 0-4, so both of a
decoder's routes and every filter are taken; zlib at level 3 gives
~25-30 KB a palette tile and ~40-48 KB an RGB one (level 6 saves a few
KB at three times the time). ``write_cache`` returns the pixels it encoded: the
reference builds its atlas from them and never decodes a PNG.

Only numpy and the standard library (``zlib``, ``struct``); nothing of the
program.
"""

from __future__ import annotations

import concurrent.futures as cf
import math
import multiprocessing as mp
import os
import struct
import zlib
from pathlib import Path
from typing import NamedTuple

import numpy as np

from .terrain import rng

TILE_PX = 256
SITE_PX = 32                 # the land-use sites' grid pitch, texels
BLOCK_PX = 4                 # the regions' resolution, texels
ROAD_PX = 80                 # mean spacing of the roads, texels
SHADES = (0, 3, -3, 6)       # a textured colour's four shades
N_LAND, N_FLAT, N_ROAD = 48, 12, 16
WORKERS = 8                  # the writer's processes
ZLIB_LEVEL = 3
# OpenStreetMap carto's land-use and road colours, RGB
_LAND = [(0xf2, 0xef, 0xe9), (0xe0, 0xdf, 0xdf), (0xad, 0xd1, 0x9e),
         (0xcd, 0xeb, 0xb0), (0xaa, 0xd3, 0xdf), (0xee, 0xf0, 0xd5),
         (0xeb, 0xdb, 0xe8), (0xc8, 0xfa, 0xcc), (0xf5, 0xe9, 0xc6),
         (0xd9, 0xd0, 0xc9), (0xe3, 0xe9, 0xc2), (0xde, 0xf6, 0xc0)]
_ROAD = [(0xff, 0xff, 0xff), (0xf7, 0xfa, 0xbf), (0xfc, 0xd6, 0xa4),
         (0xe8, 0x92, 0xa2), (0xbb, 0xbb, 0xbb), (0xa0, 0x6b, 0x00)]


class TileCache(NamedTuple):
    """What ``write_cache`` wrote: the tile range and each tile's RGB
    pixels, ``pixels[(x, y)]`` (256, 256, 3) uint8, row 0 = north."""
    zoom: int
    x_lo: int
    y_lo: int
    x_hi: int
    y_hi: int
    pixels: dict


def tile_xy(lat_deg: float, lon_deg: float, zoom: int) -> tuple[int, int]:
    """The slippy tile (x, y) holding a lat/lon (horizonator-lib.c:
    225-245): x from the longitude, clamped into [0, 2^z]; y from the
    spherical Mercator latitude, growing southward."""
    n = float(1 << zoom)
    lon, lat = math.radians(lon_deg), math.radians(lat_deg)
    x = int(min(n, max(0.0, lon * n / (2 * math.pi) + n / 2)))
    y = int(n / 2 * (1.0 - math.log((math.sin(lat) + 1.0) / math.cos(lat))
                     / math.pi))
    return x, y


def tile_range(lat_deg: float, lon_deg: float, radius_cells: int,
               cells_per_deg: int, zoom: int) -> tuple[int, int, int, int]:
    """(x_lo, y_lo, x_hi, y_hi): the tiles covering the viewer +- the DEM
    window's radius (horizonator-lib.c:373-400); y_lo is the northern
    edge."""
    r = radius_cells / cells_per_deg
    x_lo, y_lo = tile_xy(lat_deg + r, lon_deg - r, zoom)
    x_hi, y_hi = tile_xy(lat_deg - r, lon_deg + r, zoom)
    return x_lo, y_lo, x_hi, y_hi


def palette(seed: int) -> np.ndarray:
    """(256, 3) uint8 RGB: colour c's shade s at index 4 c + s; colours
    0-47 land use (12-47 textured: the flat hues a few levels darker),
    48-63 roads; every colour moved by a few seeded levels."""
    g = rng(seed, 40)
    base = [tuple(v - 8 * (i // N_FLAT) for v in _LAND[i % N_FLAT])
            for i in range(N_LAND)]
    base += [_ROAD[i % len(_ROAD)] for i in range(N_ROAD)]
    base = np.asarray(base, np.int32) + g.integers(-6, 7, (64, 3))
    pal = base[:, None, :] + np.asarray(SHADES, np.int32)[None, :, None]
    return np.clip(pal, 0, 255).reshape(256, 3).astype(np.uint8)


def _mix(*words) -> np.ndarray:
    """A 64-bit hash of integer arrays (splitmix64's finalizer over their
    combination), so a site's draw depends on its global cell alone."""
    h = np.uint64(0x9E3779B97F4A7C15)
    with np.errstate(over="ignore"):
        for w in words:
            h = (h ^ np.asarray(w).astype(np.uint64)) * np.uint64(
                0xBF58476D1CE4E5B9)
            h ^= h >> np.uint64(31)
            h *= np.uint64(0x94D049BB133111EB)
            h ^= h >> np.uint64(29)
    return h


def _roads(seed: int, x_lo, y_lo, x_hi, y_hi):
    """Seeded roads over the tile range, in global texels: (vertical, a0,
    slope, half width, colour, origin) each; a vertical road runs x = a0 +
    slope * (y - origin), the others y = a0 + slope * (x - origin), the
    origin being the range's northern or western edge."""
    g = rng(seed, 41)
    out = []
    for vertical, lo, hi in ((True, x_lo, x_hi), (False, y_lo, y_hi)):
        span = (hi + 1 - lo) * TILE_PX
        for _ in range(max(1, span // ROAD_PX)):
            out.append((vertical, lo * TILE_PX + g.uniform(0, span),
                        g.uniform(-0.25, 0.25), g.uniform(1.0, 2.0),
                        48 + int(g.integers(N_ROAD)),
                        (y_lo if vertical else x_lo) * TILE_PX))
    return out


def tile_index(seed: int, x: int, y: int, roads) -> np.ndarray:
    """(256, 256) uint8 palette indices of tile (x, y)."""
    # the regions on blocks of BLOCK_PX texels: each block's centre takes
    # the nearest site among the 3 x 3 cells around its own, each site
    # hashed from its global cell
    nb = TILE_PX // BLOCK_PX
    by = (y * TILE_PX + BLOCK_PX * np.arange(nb) + (BLOCK_PX - 1) / 2)[
        :, None].astype(np.float32)
    bx = (x * TILE_PX + BLOCK_PX * np.arange(nb) + (BLOCK_PX - 1) / 2)[
        None, :].astype(np.float32)
    c0x, c0y = x * TILE_PX // SITE_PX - 1, y * TILE_PX // SITE_PX - 1
    cy, cx = np.mgrid[c0y:((y + 1) * TILE_PX - 1) // SITE_PX + 2,
                      c0x:((x + 1) * TILE_PX - 1) // SITE_PX + 2]
    h = _mix(np.uint64(seed % (1 << 64)), cx, cy)
    sx = (cx * SITE_PX + (h & np.uint64(63)).astype(np.int64) * (
        SITE_PX / 64.0)).astype(np.float32).ravel()
    sy = (cy * SITE_PX + ((h >> np.uint64(6)) & np.uint64(63)).astype(
        np.int64) * (SITE_PX / 64.0)).astype(np.float32).ravel()
    site_colour = ((h >> np.uint64(12)) % np.uint64(N_LAND)).astype(
        np.uint8).ravel()
    ncx = cx.shape[1]
    cell = ((by // SITE_PX).astype(np.int64) - c0y) * ncx + (
        (bx // SITE_PX).astype(np.int64) - c0x)
    best = np.full(cell.shape, np.inf, np.float32)
    colour = np.zeros(cell.shape, np.uint8)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            at = cell + (dy * ncx + dx)
            d = np.square(bx - sx[at]) + np.square(by - sy[at])
            near = d < best
            best = np.where(near, d, best)
            colour = np.where(near, site_colour[at], colour)
    colour = colour.repeat(BLOCK_PX, 0).repeat(BLOCK_PX, 1)
    shade = rng(seed, 42, x, y).integers(0, 4, colour.shape, dtype=np.uint8)
    index = 4 * colour + np.where(colour >= N_FLAT, shade, np.uint8(0))
    # each road's texels: along each row (or column) the few texels
    # around its centre line that lie within its half width
    t = np.arange(TILE_PX)
    near = np.arange(6)                     # > 2 half widths + 1
    for vertical, a0, slope, half, c, origin in roads:
        along, across = (y, x) if vertical else (x, y)
        centre = a0 + slope * (along * TILE_PX + t - origin)
        lo = across * TILE_PX
        if centre.max() + half < lo or centre.min() - half > lo + TILE_PX - 1:
            continue                       # the road misses this tile
        g = np.floor(centre - half).astype(np.int64)[:, None] + near
        on = ((np.abs(g - centre[:, None]) <= half) & (g >= lo)
              & (g < lo + TILE_PX))
        a, b = np.broadcast_to(t[:, None], g.shape)[on], g[on] - lo
        if vertical:
            index[a, b] = 4 * c
        else:
            index[b, a] = 4 * c
    return index


def _filtered(img: np.ndarray, bpp: int) -> np.ndarray:
    """(h, 1 + stride) uint8 rows of a (h, stride) byte image, row r
    filtered with type r % 5 (None, Sub, Up, Average, Paeth); each filter
    computed on its own rows alone."""
    h, w = img.shape
    cur = img.astype(np.int16)
    up = np.vstack([np.zeros((1, w), np.int16), cur[:-1]])
    out = np.empty((h, 1 + w), np.uint8)
    out[:, 0] = np.arange(h) % 5
    for f in range(5):
        c, u = cur[f::5], up[f::5]
        left = np.zeros_like(c)
        left[:, bpp:] = c[:, :-bpp]
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = u
        elif f == 3:
            pred = (left + u) // 2
        else:
            ul = np.zeros_like(c)
            ul[:, bpp:] = u[:, :-bpp]
            est = left + u - ul
            pa, pb, pc = abs(est - left), abs(est - u), abs(est - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, u, ul))
        out[f::5, 1:] = (c - pred) & 255
    return out


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def png_bytes(index: np.ndarray, pal: np.ndarray, as_palette: bool) -> bytes:
    """The PNG of palette image ``index``: 8-bit palette, or 8-bit RGB of
    ``pal[index]``; rows filtered 0-4 in turn, zlib level ``ZLIB_LEVEL``."""
    h, w = index.shape
    if as_palette:
        rows, ctype, plte = _filtered(index, 1), 3, _chunk(b"PLTE",
                                                           pal.tobytes())
    else:
        rows = _filtered(pal[index].reshape(h, 3 * w), 3)
        ctype, plte = 2, b""
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                          0))
            + plte + _chunk(b"IDAT", zlib.compress(rows.tobytes(),
                                                       ZLIB_LEVEL))
            + _chunk(b"IEND", b""))


def tile_path(root, name: str, zoom: int, x: int, y: int) -> Path:
    """The cache's layout, {dir}/{name}/{z}/{x}/{y}.png."""
    return Path(root) / name / str(zoom) / str(x) / f"{y}.png"


def _write_tiles(seed: int, root, name: str, zoom: int,
                 rng_xy: tuple[int, int, int, int], coords) -> list:
    """Encode and write tiles ``coords`` of the range (one worker's
    share); [((x, y), palette indices)]."""
    pal, roads = palette(seed), _roads(seed, *rng_xy)
    out = []
    for x, y in coords:
        index = tile_index(seed, x, y, roads)
        path = tile_path(root, name, zoom, x, y)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + f".{os.getpid()}.part")
        tmp.write_bytes(png_bytes(index, pal, (x + y) % 2 == 1))
        os.replace(tmp, path)
        out.append(((x, y), index))
    return out


def write_cache(seed: int, root, name: str, zoom: int,
                rng_xy: tuple[int, int, int, int]) -> TileCache:
    """Write the seeded tiles of ``rng_xy`` = (x_lo, y_lo, x_hi, y_hi)
    under ``root`` in ``WORKERS`` processes (threads would queue on the
    interpreter lock: most of a tile is small numpy steps), four shares
    each; returns what was written."""
    x_lo, y_lo, x_hi, y_hi = rng_xy
    coords = [(x, y) for y in range(y_lo, y_hi + 1)
              for x in range(x_lo, x_hi + 1)]
    shares = [coords[i::4 * WORKERS] for i in range(4 * WORKERS)]
    args = [(seed, str(root), name, zoom, rng_xy, c) for c in shares if c]
    # forked, so that no worker re-runs the caller's main module; a worker
    # touches numpy, zlib and its files alone, never CUDA or torch
    with cf.ProcessPoolExecutor(min(WORKERS, len(args)),
                                mp_context=mp.get_context("fork")) as ex:
        done = [t for share in ex.map(_write_tiles, *zip(*args))
                for t in share]
    pal = palette(seed)
    return TileCache(zoom, x_lo, y_lo, x_hi, y_hi,
                     {xy: pal[index] for xy, index in done})
