"""Plain reference of the viewshed operations (window sampler).

One observer at a time, in plain PyTorch, on the device of its inputs,
built on the reference renderer's march (``render.march``); it imports
nothing of the program. Observers stand ``height_m`` above the bilinear
terrain of the 0.5 m elevations and look around the full circle.

- ``horizons``: each column's highest elevation tangent (the sweep);
- ``count``: how many observers see each cell of a fixed frame. A cell is
  seen when its own bilinear elevation tangent reaches the highest tangent
  of its polar column strictly nearer than itself less half a crossing
  step (keyed by output row where |north| >= |east|, else by column),
  computed here as the direct masked maximum over the column's samples,
  with the coverage of the quarter arcs of the full-circle forms.

``dtype`` stores the DEM and each march's field in that precision (the
control: bfloat16).
"""

from __future__ import annotations

import math

import torch

from .render import (DEG, EARTH_RADIUS_M, NEG_BIG, View, az_window, column_az,
                     const, k_cross_for, make_view, march, recip)

DIRECT_BYTES = 1 << 30


def observer_heights(dem, pts, height_m: float):
    """(B,) viewer elevations: the bilinear terrain of the DEM rounded to
    0.5 m at float cell coords pts (B, 2) = (i, j), plus height_m."""
    n = dem.shape[0]
    zq = torch.clamp(torch.round(dem * 2.0), -32768, 32767) * 0.5
    i, j = pts[:, 0], pts[:, 1]
    i0 = torch.clamp(torch.floor(i), 0, n - 2).to(torch.int32)
    j0 = torch.clamp(torch.floor(j), 0, n - 2).to(torch.int32)
    fi = torch.clamp(i - i0, 0.0, 1.0)
    fj = torch.clamp(j - j0, 0.0, 1.0)
    i0, j0 = i0.long(), j0.long()
    z00, z10 = zq[j0, i0], zq[j0, i0 + 1]
    z01, z11 = zq[j0 + 1, i0], zq[j0 + 1, i0 + 1]
    top = z00 + (z10 - z00) * fi
    bot = z01 + (z11 - z01) * fi
    return top + (bot - top) * fj + height_m


def _observers(dem, pts, *, height_m, znear, zfar, lat_deg):
    vz = observer_heights(dem, pts, height_m)
    cos_lat = math.cos(math.radians(lat_deg))
    for b in range(pts.shape[0]):
        yield make_view(dem.device, vi=float(pts[b, 0]), vj=float(pts[b, 1]),
                        vz=float(vz[b]), cos_lat=cos_lat, az0=-math.pi,
                        az1=math.pi, znear=znear, zfar=zfar,
                        znear_color=znear, zfar_color=zfar)


def _kw(dem, *, zfar, cells_per_deg, lat_deg, znear):
    return dict(k_cross=k_cross_for(zfar, cells_per_deg, lat_deg,
                                    n=dem.shape[0]),
                cells_per_deg=cells_per_deg, lat_hint_deg=float(lat_deg),
                znear_hint_m=float(znear))


def horizons(dem, pts, *, width, cells_per_deg, lat_deg, height_m=2.0,
             znear=50.0, zfar=20000.0, dtype=torch.float32):
    """(B, width) horizon tangents of observers at pts (B, 2)."""
    dem = dem.to(torch.float32).to(dtype).to(torch.float32)
    kw = _kw(dem, zfar=zfar, cells_per_deg=cells_per_deg, lat_deg=lat_deg,
             znear=znear)
    out = []
    for v in _observers(dem, pts, height_m=height_m, znear=znear, zfar=zfar,
                        lat_deg=lat_deg):
        tanel, _, _ = march(dem, v, column_az(v, width), dtype=dtype, **kw)
        out.append(tanel.amax(dim=-1))
    return torch.stack(out)


def _frame(v: View, hw: int, center, cells_per_deg: int, width: int):
    vi, vj = v.vi[None], v.vj[None]
    off = torch.arange(2 * hw, dtype=torch.float32, device=vi.device) \
        - hw + 0.5
    di = (off + float(center[0])) - vi[:, None]
    dj = (off + float(center[1])) - vj[:, None]
    cell_n = const(EARTH_RADIUS_M * DEG / cells_per_deg, off)
    cell_e = cell_n * v.cos_lat[None]
    nn = dj * cell_n
    ee = di * cell_e[:, None]
    e, n = ee[:, None, :], nn[:, :, None]
    _, az_center, ndc = az_window(v.az0[None], v.az1[None])
    c3 = az_center[:, None, None]
    d = (torch.atan2(e, n) - c3) * recip(2.0 * math.pi)
    az = (d - torch.round(d)) * 2.0 * math.pi + c3
    x_ndc = (az - c3) * ndc[:, None, None]
    xcol = torch.round((x_ndc + 1.0) * 0.5 * width - 0.5)
    dist = torch.sqrt(e * e + n * n)
    return dict(di=di, dj=dj, nn=nn, ee=ee, dist=dist,
                xc=torch.clamp(xcol, 0, width - 1).to(torch.int64),
                in_az=(x_ndc >= -1.0) & (x_ndc <= 1.0),
                in_r=(dist >= v.znear) & (dist <= v.zfar),
                az_center=az_center)


def _cell_tangent(dem, v: View, f, hw: int):
    n0, n1 = dem.shape
    pj = v.vj[None][:, None] + f["dj"]
    pi = v.vi[None][:, None] + f["di"]
    pad, s = hw + 2, 2 * hw + 2
    j0, i0 = torch.floor(pj[:, 0]), torch.floor(pi[:, 0])
    fj = (pj[:, 0] - j0)[:, None, None]
    fi = (pi[:, 0] - i0)[:, None, None]
    js = torch.clamp(j0 + pad, 0, n0 + 2 * pad - s).to(torch.int64)
    is_ = torch.clamp(i0 + pad, 0, n1 + 2 * pad - s).to(torch.int64)
    u = torch.arange(s, device=dem.device)
    rows = torch.clamp(js[:, None] + u - pad, 0, n0 - 1)
    columns = torch.clamp(is_[:, None] + u - pad, 0, n1 - 1)
    win = dem[rows[:, :, None], columns[:, None, :]]
    w00, w01 = win[:, :-2, :-2], win[:, :-2, 1:-1]
    w10, w11 = win[:, 1:-1, :-2], win[:, 1:-1, 1:-1]
    z = ((1 - fj) * (1 - fi) * w00 + (1 - fj) * fi * w01
         + fj * (1 - fi) * w10 + fj * fi * w11)
    dist = f["dist"]
    t_cell = (z - v.vz) / dist - dist * v.curv
    ing = (((pj >= 0) & (pj <= n0 - 1))[:, :, None]
           & ((pi >= 0) & (pi <= n1 - 1))[:, None, :])
    return t_cell, ing


def _masked_max(tanel, d, r):
    """T[x, v] = max{tanel[x, k] : d[x, k] < r[x, v]}, NEG_BIG if none."""
    w, k = tanel.shape
    m = r.shape[-1]
    step = max(1, min(m, DIRECT_BYTES // (5 * w * k)))
    return torch.cat([torch.where(d[:, None, :] < r[:, s:s + step, None],
                                  tanel[:, None, :], NEG_BIG).amax(dim=-1)
                      for s in range(0, m, step)], dim=-1)


def _arc_covered(f, region_a, width: int):
    """Whether a cell's column lies on the quarter arc that its quadrant
    selects: min(W, W // 8 + 8) columns from floor(xf) - 2 mod W."""
    sq = min(width, width // 8 + 8)
    qa = math.pi / 4.0
    theta0 = torch.tensor([math.pi, math.pi - qa, -qa, 0.0,
                           -3.0 * qa, math.pi / 2.0, -math.pi / 2.0, qa],
                          dtype=torch.float32).to(f["az_center"].device)
    xf = (((theta0 - f["az_center"][:, None]) + math.pi) * width
          * recip(2.0 * math.pi) - 0.5)
    start = torch.remainder(torch.floor(xf) - 2.0, width).to(torch.int64)
    arc = ((~region_a).to(torch.int64) * 4
           + (f["nn"] >= 0.0).to(torch.int64)[:, :, None] * 2
           + (f["ee"] >= 0.0).to(torch.int64)[:, None, :])
    s = torch.gather(start, 1, arc.reshape(arc.shape[0], -1)).view_as(arc)
    return torch.remainder(f["xc"] - s, width) < sq


def visible(dem, v: View, *, width, hw, center, kw, dtype):
    """(2 hw, 2 hw) bool: the cells of the frame that observer v sees."""
    cpd = kw["cells_per_deg"]
    tanel, dists, geo = march(dem, v, column_az(v, width), dtype=dtype, **kw)
    idx = torch.arange(tanel.shape[-1], dtype=torch.int32,
                       device=tanel.device)
    d = dists.d_of(idx.expand(tanel.shape))
    f = _frame(v, hw, center, cpd, width)
    t_cell, ing = _cell_tangent(dem, v, f, hw)
    mask = f["in_az"] & f["in_r"] & ing
    nn, ee, xc = f["nn"], f["ee"], f["xc"]
    region_a = nn.abs()[:, :, None] >= ee.abs()[:, None, :]
    half = (0.5 * dists.scale)[:, None]
    r_a = nn / torch.cos(geo.az)[:, None] - half
    r_b = ee / torch.sin(geo.az)[:, None] - half
    t_a = _masked_max(tanel, d, r_a)[None]
    t_b = _masked_max(tanel, d, r_b)[None]
    th = torch.where(region_a, torch.gather(t_a.transpose(1, 2), 2, xc),
                     torch.gather(t_b, 1, xc))
    th = torch.where(_arc_covered(f, region_a, width), th, NEG_BIG)
    return ((t_cell >= th) & mask)[0]


def count(dem, pts, *, center, hw, width, cells_per_deg, lat_deg,
          height_m=2.0, znear=50.0, zfar=20000.0, dtype=torch.float32):
    """(2 hw, 2 hw) int32: observers at pts (B, 2) that see each cell of
    the frame centred on ``center`` (float cell coords (i, j))."""
    dem = dem.to(torch.float32).to(dtype).to(torch.float32)
    kw = _kw(dem, zfar=zfar, cells_per_deg=cells_per_deg, lat_deg=lat_deg,
             znear=znear)
    total = torch.zeros((2 * hw, 2 * hw), dtype=torch.int32,
                        device=dem.device)
    for v in _observers(dem, pts, height_m=height_m, znear=znear, zfar=zfar,
                        lat_deg=lat_deg):
        total += visible(dem, v, width=width, hw=hw, center=center, kw=kw,
                         dtype=dtype).to(torch.int32)
    return total
