"""The yardstick of the kernels' roofline shares: peaks and the least work.

A launch's bound is the larger of its bytes over the memory rate and its
operations over their peak rate (NVIDIA H100 SXM data sheet, dense, at the
700 W limit). The work is counted from the cell's own shapes and geometry,
never from the program's internals, so it stays the same whatever
implements a kernel:

- the window march reads each DEM cell that its viewpoints reach (within
  zfar, and inside an azimuth window where one is given) once, four bytes
  a cell, the union over a batch; reads its per-column parameters (8
  float32) and per-viewpoint scalars (4 float32); writes (B, W, k) float32
  samples, k the far-field budget; 30 float32 operations a sample;
- the resolve reads (B * W, K) float32 rows (K = k + the near band) and
  writes (B * W, H) idx, alpha and ok, 9 bytes a pixel; its int32
  operations those of a merge of K keys against H thresholds, 4 a key and
  12 a row.
"""

from __future__ import annotations

import math

from .reference.render import (DEG, EARTH_RADIUS_M, N_NEAR, k_cross_for,
                               step_budget)

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# 132 SMs x 64 int32 lanes x 1.98 GHz
INT32_OPS_PER_S = 16.73e12
MARCH_FLOPS = 30


def bound_s(nbytes: float, ops: float, ops_per_s: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def reached_cells(n: int, vi, vj, zfar_m: float, cpd: int, lat_deg: float,
                  az0=None, az1=None, device="cpu") -> int:
    """Cells of an (n, n) grid within zfar of any viewpoint (vi, vj),
    inside its azimuth window [az0, az1] (degrees) where given, each cell
    counted once; counted on ``device``, many viewpoints at a time."""
    import torch
    cell_n = EARTH_RADIUS_M * DEG / cpd
    cell_e = cell_n * math.cos(math.radians(lat_deg))
    f64 = dict(dtype=torch.float64, device=device)
    x = torch.arange(n, **f64)
    vi, vj = torch.as_tensor(vi, **f64), torch.as_tensor(vj, **f64)
    if az0 is not None:
        az0 = torch.as_tensor(az0, **f64)
        span = torch.remainder(torch.as_tensor(az1, **f64) - az0, 360.0)
        span = torch.where(span == 0, 360.0, span)
    seen = torch.zeros((n, n), dtype=torch.bool, device=device)
    step = max(1, (1 << 25) // (n * n))
    for s in range(0, len(vi), step):
        de = ((x[None, None, :] - vi[s:s + step, None, None]) * cell_e)
        dn = ((x[None, :, None] - vj[s:s + step, None, None]) * cell_n)
        m = de * de + dn * dn <= zfar_m * zfar_m
        if az0 is not None:
            rel = torch.remainder(torch.rad2deg(torch.atan2(de, dn))
                                  - az0[s:s + step, None, None], 360.0)
            m &= rel <= span[s:s + step, None, None]
        seen |= m.any(dim=0)
    return int(seen.sum())


def march_bound_s(n, vi, vj, *, width, zfar_m, cpd, lat_deg, az0=None,
                  az1=None, device="cpu") -> float:
    """The least time of one window-march launch over viewpoints (vi, vj)
    of an (n, n) grid at ``width`` columns."""
    b = len(vi)
    k = step_budget(k_cross_for(zfar_m, cpd, lat_deg, n=n), n)
    lanes = b * width * k
    cells = reached_cells(n, vi, vj, zfar_m, cpd, lat_deg, az0, az1, device)
    nbytes = 4 * cells + b * width * 8 * 4 + b * 4 * 4 + 4 * lanes
    return bound_s(nbytes, MARCH_FLOPS * lanes, FP32_OPS_PER_S)


def batches_bound_s(n, pts, batch: int, **kw) -> float:
    """The least time of the march launches of viewpoints pts (B, 2) in
    batches of ``batch``, one launch a batch."""
    return sum(march_bound_s(n, pts[s:s + batch, 0], pts[s:s + batch, 1],
                             **kw) for s in range(0, len(pts), batch))


def resolve_bound_s(n, b, *, width, height, zfar_m, cpd, lat_deg) -> float:
    """The least time of one resolve launch of b viewpoints."""
    k = N_NEAR + step_budget(k_cross_for(zfar_m, cpd, lat_deg, n=n), n)
    cols = b * width
    nbytes = 4 * cols * k + 9 * cols * height
    return bound_s(nbytes, cols * (4 * k + 12 * height), INT32_OPS_PER_S)
