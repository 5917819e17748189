"""Grid-crossing (supercover DDA) geometry: the per-column affine march.

Counterpart of horizonator_tpu.render.crossing for the window march. Each
image column is one azimuth; its ray is sampled where it crosses DEM grid
lines, row-dominant rays (|di/dj| <= 1) at integer rows, column-dominant
ones at integer columns. The crossing at step m has cross-axis position
``a + m*t`` (|t| <= 1) and horizontal distance ``(m + e) * scale``, so a
sample is a 2-tap lerp along one grid line: exact on the bilinear and the
reference's triangulated surface alike (horizonator-lib.c:496-507).

All arithmetic is float32 in the JAX package's operation order. With
(B,) RenderParams fields every per-column array is (B, W).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import geometry
from ..geometry import const, recip
from .raymarch import RenderParams, cols, samples

DEG = math.pi / 180.0
NEG_BIG = -3.0e38
N_NEAR = 4


class CrossingGeom(NamedTuple):
    """Per-column crossing parameterization, all (W,) float32 unless noted
    ((B, W) for a batch)."""
    az: torch.Tensor        # column azimuth, rad
    j_dom: torch.Tensor     # bool: row-dominant (sample at integer j)
    axis0: torch.Tensor     # int32 first integer row (j-dom) / column
    sign: torch.Tensor      # int32 +-1: direction of integer-axis stepping
    e: torch.Tensor         # fractional offset of the first crossing, (0, 1]
    scale: torch.Tensor     # meters of horizontal distance per step
    a: torch.Tensor         # cross-axis position at m=0
    t: torch.Tensor         # cross-axis position increment per step
    cell_m_north: torch.Tensor   # 0-d
    cell_m_east: torch.Tensor    # per viewpoint: 0-d, or (B,)


def crossing_geometry(params: RenderParams, *, width: int,
                      cells_per_deg: int) -> CrossingGeom:
    """Closed-form supercover DDA parameters for every image column."""
    p = params
    _, az_center, az_ndc_per_rad = geometry.az_window_rad(p.az_rad0, p.az_rad1)
    x = torch.arange(width, dtype=torch.float32, device=az_center.device)
    az_ndc = (x + 0.5) * recip(width) * 2.0 - 1.0
    az = cols(az_center) + az_ndc / cols(az_ndc_per_rad)
    return crossing_geometry_at(params, az, cells_per_deg)


def crossing_geometry_at(params: RenderParams, az: torch.Tensor,
                         cells_per_deg: int) -> CrossingGeom:
    """crossing_geometry for explicit azimuths: (W,) for 0-d params, (B,
    W) for (B,) params."""
    p = params
    cell_n = const(geometry.EARTH_RADIUS_M * DEG / cells_per_deg, az)
    cell_e_v = cell_n * p.cos_viewer_lat
    cell_e = cols(cell_e_v)
    sin_az = torch.sin(az)
    cos_az = torch.cos(az)

    # cells moved in i per unit j along the ray (and its inverse)
    eps = const(1e-30, az)
    g = sin_az * cell_n / (torch.where(cos_az.abs() < eps,
                                       torch.where(cos_az >= 0, eps, -eps),
                                       cos_az) * cell_e)
    gi = cos_az * cell_e / (torch.where(sin_az.abs() < eps,
                                        torch.where(sin_az >= 0, eps, -eps),
                                        sin_az) * cell_n)
    j_dom = g.abs() <= 1.0

    one = const(1.0, az)
    sign_j = torch.where(cos_az >= 0, one, -one)
    sign_i = torch.where(sin_az >= 0, one, -one)

    ci, cj = cols(p.viewer_cell_i), cols(p.viewer_cell_j)
    # first crossing strictly beyond the viewer (a viewer exactly on a grid
    # line skips its own line)
    r0 = torch.where(sign_j > 0, torch.floor(cj) + 1.0, torch.ceil(cj) - 1.0)
    c0 = torch.where(sign_i > 0, torch.floor(ci) + 1.0, torch.ceil(ci) - 1.0)
    e_j = (r0 - cj) * sign_j
    e_i = (c0 - ci) * sign_i

    scale_j = cell_n / torch.maximum(cos_az.abs(), eps)
    scale_i = cell_e / torch.maximum(sin_az.abs(), eps)

    a_j = ci + sign_j * e_j * g
    t_j = sign_j * g
    a_i = cj + sign_i * e_i * gi
    t_i = sign_i * gi

    return CrossingGeom(
        az=az, j_dom=j_dom,
        axis0=torch.where(j_dom, r0, c0).to(torch.int32),
        sign=torch.where(j_dom, sign_j, sign_i).to(torch.int32),
        e=torch.where(j_dom, e_j, e_i),
        scale=torch.where(j_dom, scale_j, scale_i),
        a=torch.where(j_dom, a_j, a_i),
        t=torch.where(j_dom, t_j, t_i),
        cell_m_north=cell_n, cell_m_east=cell_e_v)


def k_cross_for(zfar_m: float, cells_per_deg: int, lat_deg: float,
                n: int | None = None, multiple: int = 64) -> int:
    """Static step count covering zfar at this latitude: the worst case is
    column-dominant marching at cell_east spacing."""
    cell_n = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    cell_e = cell_n * abs(math.cos(math.radians(lat_deg)))
    k = int(math.ceil(zfar_m / max(cell_e, 1e-6))) + 2
    if n is not None:
        k = min(k, n)
    return max(multiple, -(-k // multiple) * multiple)


class CrossingDists(NamedTuple):
    """Distance-from-sample-index mapping of the window march: the first
    ``n_near`` samples are uniform over the near band [znear, near_hi), the
    rest are the crossings d = (m + e) * scale."""
    e: torch.Tensor         # (W,) fractional offset of the first crossing
    scale: torch.Tensor     # (W,) meters per crossing step
    znear: torch.Tensor     # 0-d
    near_hi: torch.Tensor   # (W,) top of the near band
    n_near: int
    # int32 0-d: valid near-band samples outside the static near patch
    # (znear above znear_hint_m); 0 == all samples covered
    dropped: torch.Tensor | None = None
    # int32 0-d: columns whose valid crossing interval extends past the
    # step budget (a manual nsteps below k_cross_for's); 0 == none
    truncated: torch.Tensor | None = None
    # (a batch: (B, W) columns, (B,) znear and guards)

    def d_of(self, idx: torch.Tensor) -> torch.Tensor:
        """Sample distance for (W, X) integer sample indices ((B, W, X) in
        a batch)."""
        q = self.n_near
        idxf = idx.to(torch.float32)
        znear = samples(self.znear)
        d_near = znear + idxf * (
            (self.near_hi[..., None] - znear) * recip(q))
        d_crossing = (idxf - q + self.e[..., None]) * self.scale[..., None]
        return torch.where(idxf < q, d_near, d_crossing)
