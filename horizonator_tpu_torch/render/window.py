"""The window march: every image column's samples along its ray.

Counterpart of horizonator_tpu.render.window.march_window for a square,
unsharded, untextured grid. The output is the JAX package's
``scene=None`` lane layout, (W, N_NEAR + k_limit):

- lanes [0, N_NEAR): the near band, N_NEAR bilinear samples over
  [znear, first surviving crossing), read through the viewer-centered DEM
  patch at 0.5 m elevation resolution (window.py:1024-1095);
- lanes N_NEAR + m: grid crossing m, from the window-march kernel
  (kernels/window_march.py), which reads its two taps straight from the
  DEM: the TPU's crossing tables, aligned windows and per-tile origins
  exist for its DMA engine and have no counterpart here.

The guards keep their contract: ``dists.truncated`` counts columns whose
valid crossings run past the step budget, ``dists.dropped`` near-band
samples outside the static patch. A CUDA kernel reads the DEM directly,
so the TPU's window-overflow class of ``dropped`` cannot occur.
"""

from __future__ import annotations

import math

import torch

from .. import geometry
from ..geometry import const, recip
from ..kernels.window_march import fma32, march, march_plain
from .crossing import (CrossingDists, CrossingGeom, N_NEAR, NEG_BIG,
                       crossing_geometry)
from .raymarch import RenderParams

DEG = math.pi / 180.0
TILE_K = 128           # the JAX kernel's step tile: k budgets round to it
ALIGN_MIN_N = TILE_K + 8   # grids below this are zero-padded (window.py:738)
NEAR_PATCH_CAP = 64


def near_patch_size(znear_hint_m: float, cells_per_deg: int,
                    lat_hint_deg: float) -> int:
    """Static DEM-patch edge (cells) covering every near-band sample
    (window.py:78-97)."""
    cell_n = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    cell_e = cell_n * max(0.05, abs(math.cos(math.radians(lat_hint_deg))))
    reach = znear_hint_m + 1.5 * cell_n
    r = int(math.ceil(reach / min(cell_n, cell_e))) + 2
    return -(-(2 * r + 2) // 8) * 8


def step_budget(k_cross: int, n: int) -> int:
    """k_limit: the caller's step budget, capped by the grid (rounded UP to
    TILE_K, window.py:771-785, so far-edge crossings are never cut)."""
    n_ax = max(n, ALIGN_MIN_N)
    k_kernel = max(TILE_K, min(k_cross, -(-n_ax // TILE_K) * TILE_K))
    k_kernel = -(-k_kernel // TILE_K) * TILE_K
    return min(k_cross, k_kernel)


def _truncated(geo: CrossingGeom, p: RenderParams, n: int,
               k_limit: int) -> torch.Tensor:
    """Columns whose valid crossing interval [m_lo, m_hi] reaches past the
    step budget (window.py:850-877, square grid: all bounds [0, n-1])."""
    lo = const(0.0, geo.a)
    hi = const(n - 1.0, geo.a)
    ax0f = geo.axis0.to(torch.float32)
    sgnf = geo.sign.to(torch.float32)
    big = const(3e38, geo.a)
    abs_t = torch.maximum(geo.t.abs(), const(1e-30, geo.a))
    ax_hi_m = torch.where(sgnf > 0, hi - ax0f, ax0f - lo)
    ax_lo_m = torch.where(sgnf > 0, lo - ax0f, ax0f - hi)
    pos_hi_m = torch.where(
        geo.t == 0.0, big,
        torch.where(geo.t > 0, hi - geo.a, geo.a - lo) / abs_t)
    pos_lo_m = torch.where(
        geo.t == 0.0, -big,
        torch.where(geo.t > 0, lo - geo.a, geo.a - hi) / abs_t)
    m_hi = torch.minimum(torch.minimum(ax_hi_m, pos_hi_m),
                         p.zfar / geo.scale - geo.e)
    m_lo = torch.maximum(torch.maximum(ax_lo_m, pos_lo_m),
                         torch.clamp(p.znear / geo.scale - geo.e, min=0.0))
    reach = torch.maximum(torch.ceil(m_lo), const(float(k_limit), geo.a))
    return (torch.floor(m_hi) >= reach).sum().to(torch.int32)


def _near_band(dem: torch.Tensor, p: RenderParams, geo: CrossingGeom, *,
               n_near: int, near_hi: torch.Tensor, n_real: int,
               patch_n: int | None):
    """(tanel_q (W, n_near), dropped) -- window.py:1027-1114 for a square
    grid. ``dem`` is the (zero-padded) march grid, ``n_real`` the loaded
    grid's edge."""
    n = dem.shape[0]
    q = torch.arange(n_near, dtype=torch.float32, device=dem.device)[None, :]
    # 1 mm floor: znear == 0 would put the first sample at d = 0
    dq = torch.clamp(
        p.znear + q * ((near_hi[:, None] - p.znear) * recip(n_near)),
        min=1e-3)
    sin_az = torch.sin(geo.az)[:, None]
    cos_az = torch.cos(geo.az)[:, None]
    iq = p.viewer_cell_i + dq * sin_az / geo.cell_m_east
    # cell_m_north is a Python constant in the JAX package: XLA multiplies
    # by its float32 reciprocal
    jq = p.viewer_cell_j + dq * cos_az * (1.0 / geo.cell_m_north)
    edge = float(n_real - 1)
    vq = ((iq >= 0) & (iq <= edge) & (jq >= 0) & (jq <= edge)
          & (dq >= p.znear) & (dq <= p.zfar) & (dq < near_hi[:, None]))
    dropped = torch.zeros((), dtype=torch.int32, device=dem.device)
    if patch_n is not None:
        # the viewer-centered patch at 0.5 m elevation resolution; each
        # sample's bilinear value is the JAX package's hat contraction with
        # its exact-zero terms dropped: 4 corners, no matmul (so no TF32)
        oi = torch.clamp(torch.floor(p.viewer_cell_i).to(torch.int32)
                         - (patch_n // 2 - 1), 0, n - patch_n)
        oj = torch.clamp(torch.floor(p.viewer_cell_j).to(torch.int32)
                         - (patch_n // 2 - 1), 0, n - patch_n)
        ir = iq - oi.to(torch.float32)
        jr = jq - oj.to(torch.float32)
        u0 = torch.floor(ir)
        v0 = torch.floor(jr)

        def hat(x, r):
            return torch.clamp(1.0 - torch.abs(x - r), min=0.0)

        def corner(dv, du):
            # rows/cols past the patch carry zero weight; clamp the read
            row = (oj + (v0 + dv).clamp(0, patch_n - 1).to(torch.int32))
            col = (oi + (u0 + du).clamp(0, patch_n - 1).to(torch.int32))
            z = dem[row.long(), col.long()]
            return torch.round(z * 2.0) * 0.5

        acc0 = hat(ir, u0) * corner(0, 0) + hat(ir, u0 + 1.0) * corner(0, 1)
        acc1 = hat(ir, u0) * corner(1, 0) + hat(ir, u0 + 1.0) * corner(1, 1)
        zq = fma32(hat(jr, v0 + 1.0), acc1, hat(jr, v0) * acc0)
        last = float(patch_n - 1)
        in_patch = (ir >= 0.0) & (ir <= last) & (jr >= 0.0) & (jr <= last)
        dropped = (vq & ~in_patch).sum().to(torch.int32)
        vq = vq & in_patch
    else:
        # patch too large for its cap (or the grid): bilinear from four
        # gathered corners of the 0.5 m int16-class grid (window.py:1097-1111)
        i0 = torch.clamp(torch.floor(iq), 0, n_real - 2).to(torch.int32)
        j0 = torch.clamp(torch.floor(jq), 0, n_real - 2).to(torch.int32)
        fi = torch.clamp(iq - i0, 0.0, 1.0)
        fj = torch.clamp(jq - j0, 0.0, 1.0)
        zq16 = torch.clamp(torch.round(dem * 2.0), -32768, 32767) * 0.5
        i0, j0 = i0.long(), j0.long()
        z00, z01 = zq16[j0, i0], zq16[j0, i0 + 1]
        z10, z11 = zq16[j0 + 1, i0], zq16[j0 + 1, i0 + 1]
        ztop = z00 + (z01 - z00) * fi
        zbot = z10 + (z11 - z10) * fi
        zq = ztop + (zbot - ztop) * fj
    tanel_q = torch.where(vq, fma32(-dq, p.curv.expand_as(dq),
                                    (zq - p.viewer_z) / dq),
                          const(NEG_BIG, zq))
    return tanel_q, dropped


def _check_supported(dem, j_hi, j_offset, color_planes, scene,
                     exact_near_m):
    if dem.dim() != 2 or dem.shape[0] != dem.shape[1]:
        raise NotImplementedError("march_window: only square grids are "
                                  f"ported, got {tuple(dem.shape)}")
    for name, v in (("j_hi", j_hi), ("j_offset", j_offset),
                    ("color_planes", color_planes), ("scene", scene),
                    ("exact_near_m", exact_near_m)):
        if v is not None:
            raise NotImplementedError(f"march_window: {name}= (banded, "
                                      "textured or aligned marches) is not "
                                      "ported")


def march_from_geometry(dem: torch.Tensor, params: RenderParams,
                        geo: CrossingGeom, *, k_cross: int,
                        cells_per_deg: int, lat_hint_deg: float = 45.0,
                        n_near: int = N_NEAR, znear_hint_m=100.0,
                        plain: bool = False):
    """(tanel (W, n_near + k_limit), dists) for given crossing geometry.

    ``plain`` runs the march's plain PyTorch version on any device (for
    comparisons with the kernel); otherwise ``march`` picks by device."""
    p = params
    n = dem.shape[0]
    dem = dem.to(torch.float32).contiguous()
    k_limit = step_budget(k_cross, n)

    pcol = torch.stack([
        geo.a, geo.t, geo.e, geo.scale,
        geo.axis0.to(torch.float32), geo.sign.to(torch.float32),
        geo.j_dom.to(torch.float32), torch.zeros_like(geo.a)],
        dim=1).contiguous()
    fscal = torch.stack([p.viewer_z, p.znear, p.zfar, p.curv]).to(
        torch.float32)
    far = (march_plain if plain else march)(dem, pcol, fscal, k_limit)
    truncated = _truncated(geo, p, n, k_limit)

    m_star = torch.clamp(torch.ceil(p.znear / geo.scale - geo.e), min=0.0)
    near_hi = torch.maximum((m_star + geo.e) * geo.scale, p.znear)
    dropped = torch.zeros((), dtype=torch.int32, device=dem.device)
    if n_near > 0:
        n_pad = max(n, ALIGN_MIN_N)
        grid = (dem if n_pad == n else
                torch.nn.functional.pad(dem, (0, n_pad - n, 0, n_pad - n)))
        patch_n = (near_patch_size(znear_hint_m, cells_per_deg, lat_hint_deg)
                   if znear_hint_m is not None else None)
        if patch_n is not None and (patch_n > NEAR_PATCH_CAP
                                    or patch_n > n_pad):
            patch_n = None     # would not fit: the gather form, never a drop
        tanel_q, dropped = _near_band(grid, p, geo, n_near=n_near,
                                      near_hi=near_hi, n_real=n,
                                      patch_n=patch_n)
        far = torch.cat([tanel_q, far], dim=1)
    dists = CrossingDists(e=geo.e, scale=geo.scale, znear=p.znear,
                          near_hi=near_hi, n_near=n_near, dropped=dropped,
                          truncated=truncated)
    return far, dists


def march_window(dem: torch.Tensor, params: RenderParams, *, width: int,
                 k_cross: int, cells_per_deg: int,
                 lat_hint_deg: float = 45.0, n_near: int = N_NEAR,
                 znear_hint_m=100.0, j_hi=None, j_offset=None,
                 color_planes=None, scene=None, exact_near_m=None,
                 plain: bool = False):
    """The crossing march on a square (n, n) float32 DEM tensor: returns
    (tanel (W, n_near + k_limit), run_max, dists, az) like
    horizonator_tpu's march_window(scene=None). ``lat_hint_deg`` and
    ``znear_hint_m`` size the static near patch as there."""
    _check_supported(dem, j_hi, j_offset, color_planes, scene, exact_near_m)
    geo = crossing_geometry(params, width=width, cells_per_deg=cells_per_deg)
    tanel, dists = march_from_geometry(
        dem, params, geo, k_cross=k_cross, cells_per_deg=cells_per_deg,
        lat_hint_deg=lat_hint_deg, n_near=n_near, znear_hint_m=znear_hint_m,
        plain=plain)
    run_max = torch.cummax(tanel, dim=1).values
    return tanel, run_max, dists, geo.az
