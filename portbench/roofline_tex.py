"""The textured window march's and resolve's least work, on
``roofline.py``'s yardstick (its peaks, its reached cells).

Both kernels' textured entries move what their untextured entries move
(``roofline.py``'s docstring) and more:

- the march reads two half-cell texels of each DEM cell it reaches and
  writes each sample's int32 colour: (B, W, k) x 4 bytes more. A sample
  on DEM grid line a of the (2n, 2n) int32 colour plane interpolates
  along the plane's line 2a alone (window_march.cu's ``TEX`` loads: row
  2a of a j-dominant column, column 2a of an i-dominant one), and a
  cell's stretch of that line holds two texels: 8 bytes a cell. A cell
  on a diagonal, reached from both kinds of column, needs a third texel;
  those cells are too few to count, and leaving them out keeps the bound
  a least time;
- the resolve reads each sample's colour, (B * W, K) x 4 bytes, and
  writes each pixel's, (B * W, H) x 4 bytes.

Their operations are counted as the untextured entries' (the bytes bind
both by ~10x). At the bench shape of PERF.md's kernel table (4096 x 1024,
360 degrees, zfar 40 km over a 3400^2 grid at 34.3 degrees) that is a
march of 27.51 MB and a resolve of 73.53 MB. (PERF.md's kernel table
counts 33.18 MB for the same march: all four texels of a cell, two of
which no sample reads.)
"""

from __future__ import annotations

from . import roofline
from .reference.render import N_NEAR, k_cross_for, step_budget


def march_work(n, vi, vj, *, width, zfar_m, cpd, lat_deg,
               device="cpu") -> tuple[int, int]:
    """(bytes, float32 operations) of one textured march launch over
    viewpoints (vi, vj) of an (n, n) grid at ``width`` columns."""
    b = len(vi)
    k = step_budget(k_cross_for(zfar_m, cpd, lat_deg, n=n), n)
    lanes = b * width * k
    cells = roofline.reached_cells(n, vi, vj, zfar_m, cpd, lat_deg,
                                   device=device)
    untextured = 4 * cells + b * width * 8 * 4 + b * 4 * 4 + 4 * lanes
    return untextured + 8 * cells + 4 * lanes, roofline.MARCH_FLOPS * lanes


def march_bound_s(n, vi, vj, **kw) -> float:
    """The least time of one textured window-march launch."""
    return roofline.bound_s(*march_work(n, vi, vj, **kw),
                            roofline.FP32_OPS_PER_S)


def resolve_work(n, b, *, width, height, zfar_m, cpd,
                 lat_deg) -> tuple[int, int]:
    """(bytes, int32 operations) of one textured resolve launch of b
    viewpoints."""
    k = N_NEAR + step_budget(k_cross_for(zfar_m, cpd, lat_deg, n=n), n)
    cols = b * width
    untextured = 4 * cols * k + 9 * cols * height
    return (untextured + 4 * cols * k + 4 * cols * height,
            cols * (4 * k + 12 * height))


def resolve_bound_s(n, b, **kw) -> float:
    """The least time of one textured resolve launch of b viewpoints."""
    return roofline.bound_s(*resolve_work(n, b, **kw),
                            roofline.INT32_OPS_PER_S)
