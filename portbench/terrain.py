"""Seeded synthetic SRTM terrain and the .hgt writer.

The relief is benchmarks/suite.py's ``synth_dem`` formula (two products of
sines, 500 m and 200 m, on 600 m) plus 30 m of seeded Gaussian noise,
evaluated in global cell coordinates over a whole mosaic so that tiles
join, rounded to integer metres and clamped at sea level as SRTM is. The
mosaic is one int16 array, row 0 = south, column 0 = west; a tile is the
(cpd + 1)^2 block at its corner, sharing its edge rows with its
neighbours.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

RELIEF_M = 500.0
NOISE_M = 30.0


def rng(seed: int, *stream: int) -> np.random.Generator:
    """numpy's generator for a seed of any size and a stream label."""
    return np.random.default_rng([seed % (1 << 64), *stream])


def mosaic(seed: int, tiles_lat: int, tiles_lon: int, cpd: int):
    """(tiles_lat * cpd + 1, tiles_lon * cpd + 1) int16 elevations."""
    nj, ni = tiles_lat * cpd + 1, tiles_lon * cpd + 1
    jj = np.arange(nj, dtype=np.float32)[:, None]
    ii = np.arange(ni, dtype=np.float32)[None, :]
    z = (600.0 + RELIEF_M * np.sin(ii / 223.0) * np.cos(jj / 181.0)
         + 0.4 * RELIEF_M * np.sin(ii / 37.0 + 1.3) * np.cos(jj / 53.0))
    z = z + NOISE_M * rng(seed, 0).standard_normal((nj, ni),
                                                   dtype=np.float32)
    return np.round(np.maximum(z, 0.0)).astype(np.int16)


def hgt_name(lat: int, lon: int) -> str:
    ns, ew = ("N" if lat >= 0 else "S"), ("E" if lon >= 0 else "W")
    return f"{ns}{abs(lat):02d}{ew}{abs(lon):03d}.hgt"


def write_tiles(grid, sw_lat: int, sw_lon: int, cpd: int, out_dir) -> list:
    """Write every 1-degree tile of a mosaic whose SW corner is (sw_lat,
    sw_lon) as big-endian .hgt files (row 0 = north); returns the paths."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for tj in range((grid.shape[0] - 1) // cpd):
        for ti in range((grid.shape[1] - 1) // cpd):
            tile = grid[tj * cpd:(tj + 1) * cpd + 1,
                        ti * cpd:(ti + 1) * cpd + 1][::-1]
            path = out_dir / hgt_name(sw_lat + tj, sw_lon + ti)
            tmp = path.with_name(path.name + f".{os.getpid()}.part")
            tile.astype(">i2").tofile(tmp)
            os.replace(tmp, path)
            paths.append(path)
    return paths
