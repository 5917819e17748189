"""SRTM ``.hgt`` tile naming and decoding (numpy only).

Semantics of the reference's dem.c:

- file naming ``N34W118.hgt``: 2-digit latitude, 3-digit longitude,
  hemisphere letters from the signs of the integer tile coordinates
  (dem.c:23-76);
- each tile is ``edge x edge`` big-endian int16 samples, ``edge`` = 1201
  (SRTM3) or 3601 (SRTM1), starting at the NW corner (dem.c:17-20, 300-308);
- the last row/col of a tile overlaps the first row/col of its neighbor;
- a ``~/``-prefixed data dir resolves against ``$HOME`` (dem.c:54-67).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

SRTM3_EDGE = 1201
SRTM1_EDGE = 3601


def cells_per_deg(srtm1: bool) -> int:
    """Grid cells per degree: tile edge minus the 1-cell overlap."""
    return (SRTM1_EDGE if srtm1 else SRTM3_EDGE) - 1


def expand_user_dir(datadir: str) -> str:
    """Resolve a leading ``~/`` against $HOME, like dem.c:54-67."""
    if datadir.startswith("~/"):
        home = os.environ.get("HOME")
        if home is None:
            raise RuntimeError(
                "datadir starts with '~/' but the HOME env var isn't defined")
        return os.path.join(home, datadir[2:])
    return datadir


def hgt_filename(tile_lat: int, tile_lon: int) -> str:
    """Name of the 1-degree tile whose SW corner is (tile_lat, tile_lon)."""
    ns = "N" if tile_lat >= 0 else "S"
    ew = "E" if tile_lon >= 0 else "W"
    return f"{ns}{abs(tile_lat):02d}{ew}{abs(tile_lon):03d}.hgt"


def hgt_path(datadir: str, tile_lat: int, tile_lon: int) -> Path:
    return Path(expand_user_dir(datadir)) / hgt_filename(tile_lat, tile_lon)


def read_hgt(path: str | Path, srtm1: bool) -> np.ndarray | None:
    """Read one tile as an ``(edge, edge)`` big-endian int16 array, row 0 =
    NORTH edge. None when the file is missing or zero-size (both are "sea",
    dem.c:199-221); a size mismatch raises (dem.c:234-239)."""
    path = Path(path)
    edge = SRTM1_EDGE if srtm1 else SRTM3_EDGE
    expected_bytes = edge * edge * 2
    try:
        size = path.stat().st_size
    except FileNotFoundError:
        return None
    if size == 0:
        return None
    if size != expected_bytes:
        raise ValueError(
            f"DEM file '{path}' has unexpected size {size} != "
            f"{expected_bytes}. "
            f"Is this a {'1' if srtm1 else '3'}-arc-sec SRTM DEM?")
    return np.memmap(path, dtype=">i2", mode="r", shape=(edge, edge))


def write_hgt(path: str | Path, grid_north_first: np.ndarray) -> None:
    """Write an ``.hgt`` tile (row 0 = north edge)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(grid_north_first, dtype=np.int16)
    if arr.shape[0] != arr.shape[1] or arr.shape[0] not in (SRTM3_EDGE,
                                                            SRTM1_EDGE):
        raise ValueError(f"bad hgt tile shape {arr.shape}")
    arr.astype(">i2").tofile(path)
