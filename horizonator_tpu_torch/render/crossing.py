"""Grid-crossing (supercover DDA) geometry and the crossing sampler.

Counterpart of horizonator_tpu.render.crossing. Each
image column is one azimuth; its ray is sampled where it crosses DEM grid
lines, row-dominant rays (|di/dj| <= 1) at integer rows, column-dominant
ones at integer columns. The crossing at step m has cross-axis position
``a + m*t`` (|t| <= 1) and horizontal distance ``(m + e) * scale``, so a
sample is a 2-tap lerp along one grid line: exact on the bilinear and the
reference's triangulated surface alike (horizonator-lib.c:496-507).

``crossing_geometry`` feeds the window march (window.py), whose kernel
reads its two taps from the float32 DEM. ``march_crossing`` is the JAX
package's crossing sampler, an oracle for it: the same crossings, each
one packed int32 pair of 0.5 m elevations from a ``CrossingScene``, after
a near band of bilinear samples from the same planes.

All arithmetic is float32 in the JAX package's operation order. With
(B,) RenderParams fields every per-column array is (B, W).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import geometry
from ..geometry import const, recip
from ..kernels.window_march import fma32
from .raymarch import (NEG_BIG, RenderParams, _unpack_pair,
                       broadcast_params_batch, cols, column_az, samples)

DEG = math.pi / 180.0
N_NEAR = 4


class CrossingScene(NamedTuple):
    """The crossing sampler's packed scene (crossing.py:51-75): ``hv`` is
    (2, NJ, NI) int32; plane 0 packs horizontal pairs (z[j, i], z[j,
    i+1]), read where a ray crosses row j, plane 1 vertical pairs (z[j,
    i], z[j+1, i]), read where it crosses column i. Elevations are
    quantized to 0.5 m int16 (exact for integer-metre SRTM data).
    Rectangular grids are allowed."""
    hv: torch.Tensor

    @property
    def n(self) -> int:
        return self.hv.shape[1]

    @property
    def nj(self) -> int:
        return self.hv.shape[1]

    @property
    def ni(self) -> int:
        return self.hv.shape[2]


def pack_scene(dem: torch.Tensor) -> CrossingScene:
    """The CrossingScene of a float32 (NJ, NI) grid (row 0 = south), on
    its device; the last row and column pair with themselves."""
    zq = torch.clamp(torch.round(dem.to(torch.float32) * 2.0), -32768,
                     32767).to(torch.int32)
    zlo = zq & 0xffff
    h = (zq << 16) | torch.cat([zlo[:, 1:], zlo[:, -1:]], dim=1)
    v = (zq << 16) | torch.cat([zlo[1:, :], zlo[-1:, :]], dim=0)
    return CrossingScene(hv=torch.stack([h, v]))


def crossing_scene_from_jax(scene, device) -> CrossingScene:
    """The port's CrossingScene of the JAX package's (``np.asarray`` of
    its ``hv``), on ``device``."""
    return CrossingScene(hv=torch.from_numpy(np.array(
        np.asarray(scene.hv), dtype=np.int32)).to(device))


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
    return crossing_geometry_at(params, column_az(params, width),
                                cells_per_deg)


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


def _near_samples(p: RenderParams, geo: CrossingGeom, n_near: int,
                  near_hi: torch.Tensor):
    """(dq, iq, jq) (W, n_near): the near band's uniform distances over
    [znear, near_hi) and their grid positions (window.py:1027-1038)."""
    q = torch.arange(n_near, dtype=torch.float32, device=near_hi.device)[
        None, :]
    znear = samples(p.znear)
    # 1 mm floor: znear == 0 would put the first sample at d = 0
    dq = torch.clamp(
        znear + q * ((near_hi[..., None] - znear) * recip(n_near)),
        min=1e-3)
    return (dq,) + _grid_pos(p, geo, dq)


def _grid_pos(p: RenderParams, geo: CrossingGeom, d: torch.Tensor):
    """Grid coordinates (i, j) at horizontal distance d along each column."""
    sin_az = torch.sin(geo.az)[..., None]
    cos_az = torch.cos(geo.az)[..., None]
    iq = samples(p.viewer_cell_i) + d * sin_az / samples(geo.cell_m_east)
    # cell_m_north is a Python constant in the JAX package: XLA multiplies
    # by its float32 reciprocal
    jq = samples(p.viewer_cell_j) + d * cos_az * (1.0 / geo.cell_m_north)
    return iq, jq


def march_crossing(scene: CrossingScene, params: RenderParams, *, width: int,
                   k_cross: int, cells_per_deg: int, n_near: int = N_NEAR,
                   j_hi=None, j_offset=None):
    """The (W, n_near + k_cross) crossing march (crossing.py:231-354):
    ``n_near`` bilinear samples over [znear, first surviving crossing),
    then crossing m at d = (m + e) * scale, a 1-D lerp of its packed pair.

    ``j_hi`` (default nj - 1) caps the valid fractional row range below the
    rows present; ``j_offset`` (int, default 0) is the scene's first row in
    global grid coordinates: the geometry stays global and rows shift only
    where they index and mask, which is exact, so a row band's samples are
    bitwise the global march's.

    Returns (tanel, run_max, dists, az) with ``dists.d_of`` mapping sample
    indices to distances; (B,) params give a leading B."""
    p = broadcast_params_batch(params)
    geo = crossing_geometry(p, width=width, cells_per_deg=cells_per_deg)
    tanel, dists = march_crossing_from_geometry(
        scene, p, geo, k_cross=k_cross, n_near=n_near, j_hi=j_hi,
        j_offset=j_offset)
    return tanel, torch.cummax(tanel, dim=-1).values, dists, geo.az


def march_crossing_from_geometry(scene: CrossingScene, params: RenderParams,
                                 geo: CrossingGeom, *, k_cross: int,
                                 n_near: int = N_NEAR, j_hi=None,
                                 j_offset=None):
    """(tanel, dists) of march_crossing for given crossing geometry."""
    p = params
    nj, ni = scene.nj, scene.ni
    dev = scene.hv.device
    j_hi_f = float(nj - 1 if j_hi is None else j_hi)
    hv = scene.hv.reshape(-1)
    m = torch.arange(k_cross, dtype=torch.float32, device=dev)
    mi = torch.arange(k_cross, dtype=torch.int32, device=dev)
    jd = geo.j_dom[..., None]
    axis_int = geo.axis0[..., None] + geo.sign[..., None] * mi
    # XLA contracts the position, the lerps and the curvature terms into
    # multiply-adds: so does the port (the crossings bitwise given equal
    # geometry)
    cross = fma32(m.expand(geo.t.shape + (k_cross,)), geo.t[..., None],
                  geo.a[..., None])
    d = (m + geo.e[..., None]) * geo.scale[..., None]
    offs = int(j_offset or 0)
    if offs:
        # row coordinates shift into the band: the axis of row-dominant
        # columns (integer), the cross position of column-dominant ones
        axis_int = axis_int - torch.where(jd, offs, 0).to(torch.int32)
        cross = torch.where(jd, cross, cross - float(offs))
    # validity against the rows a caller admits (j_hi), memory safety
    # against the rows present
    axis_hi = torch.where(jd, nj - 1, ni - 1)
    cross_hi_pair = torch.where(jd, ni - 2, nj - 2)
    axis_hi_v = torch.where(jd, j_hi_f, float(ni - 1))
    cross_hi_v = torch.where(jd, float(ni - 1), j_hi_f)
    cross0i = torch.minimum(torch.clamp(torch.floor(cross), min=0),
                            cross_hi_pair).to(torch.int32)
    # the fraction from the clipped base: a crossing exactly on the far
    # edge lerps to z[cross_hi] with frac 1
    frac = cross - cross0i.to(torch.float32)
    axis_c = torch.minimum(torch.clamp(axis_int, min=0), axis_hi)
    flat = torch.where(jd, axis_c * ni + cross0i,
                       nj * ni + cross0i * ni + axis_c)
    valid = ((axis_int >= 0) & (axis_int.to(torch.float32) <= axis_hi_v)
             & (cross >= 0.0) & (cross <= cross_hi_v)
             & (d >= samples(p.znear)) & (d <= samples(p.zfar)))
    z0, z1 = _unpack_pair(hv[flat.long()])
    tanel = torch.where(valid, _tangent(fma32(z1 - z0, frac, z0), d, p),
                        const(NEG_BIG, z0))

    m_star = torch.clamp(torch.ceil(cols(p.znear) / geo.scale - geo.e),
                         min=0.0)
    near_hi = torch.maximum((m_star + geo.e) * geo.scale, cols(p.znear))
    if n_near > 0:
        # left-endpoint samples from znear (floored at 1 mm), bilinear from
        # rows j0 and j0 + 1 of the horizontal pair plane
        dq, iq, jq = _near_samples(p, geo, n_near, near_hi)
        if offs:
            jq = jq - float(offs)
        i0 = torch.clamp(torch.floor(iq), 0, ni - 2).to(torch.int32)
        j0 = torch.clamp(torch.floor(jq), 0, nj - 2).to(torch.int32)
        fi = torch.clamp(iq - i0, 0.0, 1.0)
        fj = torch.clamp(jq - j0, 0.0, 1.0)
        za0, za1 = _unpack_pair(hv[(j0 * ni + i0).long()])
        zb0, zb1 = _unpack_pair(hv[((j0 + 1) * ni + i0).long()])
        ztop = fma32(za1 - za0, fi, za0)
        zbot = fma32(zb1 - zb0, fi, zb0)
        zq = fma32(zbot - ztop, fj, ztop)
        vq = ((iq >= 0) & (iq <= ni - 1) & (jq >= 0) & (jq <= j_hi_f)
              & (dq >= samples(p.znear)) & (dq <= samples(p.zfar))
              & (dq < near_hi[..., None]))
        tanel_q = torch.where(vq, _tangent(zq, dq, p), const(NEG_BIG, zq))
        tanel = torch.cat([tanel_q, tanel], dim=-1)
    dists = CrossingDists(e=geo.e, scale=geo.scale, znear=p.znear,
                          near_hi=near_hi, n_near=n_near)
    return tanel, dists


def _tangent(z: torch.Tensor, d: torch.Tensor,
             p: RenderParams) -> torch.Tensor:
    """(z - viewer_z) / d - d * curv, the subtraction fused as XLA does."""
    q = (z - samples(p.viewer_z)) / d
    return fma32(-d, samples(p.curv).expand_as(d), q)


def horizon_crossing(scene: CrossingScene, params: RenderParams, *,
                     width: int, k_cross: int, cells_per_deg: int):
    """Per-column horizon (az, tan_el) of the crossing march
    (crossing.py:357-363)."""
    tanel, _, _, az = march_crossing(scene, params, width=width,
                                     k_cross=k_cross,
                                     cells_per_deg=cells_per_deg)
    return az, tanel.amax(dim=-1)
