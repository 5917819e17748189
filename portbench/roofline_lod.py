"""The LOD march's and its resolve's least work, on ``roofline.py``'s
yardstick (its peaks and conventions).

A LOD render launches the window march once a level, each over the
level's viewer-centred crop with the level's band [d_lo, d_hi) as its
clip (``reference/render_lod.py``). A level's least work:

- reads each cell of the level's grid that the band's annulus reaches
  (d_lo <= distance <= d_hi from the viewer, cell centres at the level's
  integer positions), four bytes a cell: the crop is sized to hold the
  whole annulus, so these are crop cells;
- reads its per-column parameters (8 float32) and the viewpoint's
  scalars (4 float32), writes the (W, k_len) float32 crossings the render
  keeps (the near band's lanes are another kernel's); 30 float32
  operations a kept sample.

The resolve reads the whole field, (W, N_NEAR + sum k_len) float32, and
writes (W, H) idx, alpha and ok, as ``roofline.py`` counts it.
"""

from __future__ import annotations

import math

from . import roofline
from .reference.render import DEG, EARTH_RADIUS_M, N_NEAR


def annulus_cells(n: int, vi: float, vj: float, d_lo: float, d_hi: float,
                  cell_n: float, cell_e: float, device="cpu") -> int:
    """Cells of an (n, n) grid whose centre lies within [d_lo, d_hi] of
    the viewer at fractional cell (vi, vj); counted over the band's
    bounding box."""
    import torch
    f64 = dict(dtype=torch.float64, device=device)

    def axis(v, cell):
        r = int(math.ceil(d_hi / cell)) + 1
        lo, hi = max(0, math.floor(v) - r), min(n, math.floor(v) + r + 2)
        return (torch.arange(lo, hi, **f64) - v) * cell

    de, dn = axis(vi, cell_e), axis(vj, cell_n)
    d2 = dn[:, None] ** 2 + de[None, :] ** 2
    return int(((d2 >= d_lo * d_lo) & (d2 <= d_hi * d_hi)).sum())


def level_work(n, vi, vj, lv, *, width, cpd, lat_deg,
               device="cpu") -> tuple[int, int]:
    """(bytes, float32 operations) of one level's march launch for one
    viewpoint at fractional cell (vi, vj) of the base (n, n) grid; ``lv``
    a band of ``render_lod.plan``."""
    s = 2 ** lv.level
    cell_n = EARTH_RADIUS_M * DEG / cpd * s
    cell_e = cell_n * math.cos(math.radians(lat_deg))
    cells = annulus_cells(-(-n // s), (vi - 0.5 * (s - 1)) / s,
                          (vj - 0.5 * (s - 1)) / s, lv.d_lo, lv.d_hi,
                          cell_n, cell_e, device)
    lanes = width * lv.k_len
    nbytes = 4 * cells + width * 8 * 4 + 4 * 4 + 4 * lanes
    return nbytes, roofline.MARCH_FLOPS * lanes


def march_bound_s(n, vi, vj, bands, **kw) -> float:
    """The least time of one LOD render's level marches, summed."""
    return sum(roofline.bound_s(*level_work(n, vi, vj, lv, **kw),
                                roofline.FP32_OPS_PER_S) for lv in bands)


def resolve_bound_s(bands, *, width, height) -> float:
    """The least time of one render's resolve launch over the LOD field,
    K = N_NEAR + sum k_len."""
    k = N_NEAR + sum(lv.k_len for lv in bands)
    cols = width
    nbytes = 4 * cols * k + 9 * cols * height
    return roofline.bound_s(nbytes, cols * (4 * k + 12 * height),
                            roofline.INT32_OPS_PER_S)
