"""Plain reference of the panorama renderer's level-of-detail march: the
window sampler's swap for clip ranges that need more than 1536 crossing
steps (SRTM1 at 40 km).

One viewpoint at a time, in plain PyTorch, on whatever device its inputs
lie on. Like ``render.py`` it imports nothing of the program: a frozen
copy of the float32 arithmetic that the program's LOD render defines, so
sound runs agree with it to the last bit:

- the pyramid: 2 x 2 averages, each sum in the program's order, the odd
  last row and column repeated;
- the plan: distance bands that end where a level's cell stops resolving
  at the output (a pixel's azimuth over the full circle), each with its
  first kept crossing ``k_lo`` and its length ``k_len``;
- each level: the viewer cell scaled to the level, (c - (s - 1) / 2) / s,
  the clip narrowed to the band, a viewer-centred square crop of the
  level's grid (the crop moves the cross positions' rounding, so the
  reference crops as the program does), and ``render.py``'s crossing
  march over it, the near band on level 0 only;
- the field: the near band, then each level's crossings
  [k_lo, k_lo + k_len), padded with NEG_BIG where the grid caps them;
- the distance of a sample index across the segments, and
  ``render.py``'s resolve and image.

``dtype`` is the storage precision of the pyramid, its crops and the
field: float32 is the reference; bfloat16 is the control.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import render as ref
from .render import DEG, EARTH_RADIUS_M, N_NEAR, NEG_BIG, View

# the program swaps to the LOD march above this many crossing steps
SWAP_NSTEPS = 1536


class Level(NamedTuple):
    """One band of the plan: pyramid level, [d_lo, d_hi) in metres, and
    the crossings [k_lo, k_lo + k_len) kept from its march."""
    level: int
    d_lo: float
    d_hi: float
    k_lo: int
    k_len: int


def plan(zfar_m: float, width: int, cells_per_deg: float, lat_deg: float,
         n: int, max_levels: int = 8) -> tuple:
    """The bands covering (0, zfar] for a full-circle image ``width``
    columns wide over an (n, n) grid."""
    cell_n0 = EARTH_RADIUS_M * DEG / cells_per_deg
    cell_e0 = cell_n0 * max(1e-4, abs(math.cos(math.radians(lat_deg))))
    theta = 2.0 * math.pi / width
    out, d_lo, lvl = [], 0.0, 0
    while True:
        cell_e, cell_n = cell_e0 * 2 ** lvl, cell_n0 * 2 ** lvl
        n_l = -(-n // 2 ** lvl)
        d_hi = cell_e / max(theta, 1e-9)
        last = d_hi >= zfar_m or lvl == max_levels - 1 or n_l // 2 < 192
        if last:
            d_hi = zfar_m
        if d_hi > d_lo:
            k_lo = max(0, int(d_lo / math.hypot(cell_n, cell_e)) - 2)
            k_hi = min(int(math.ceil(d_hi / cell_e)) + 3, n_l + 2)
            out.append(Level(lvl, d_lo, d_hi, k_lo, max(1, k_hi - k_lo)))
            d_lo = d_hi
        if last or d_lo >= zfar_m:
            return tuple(out)
        lvl += 1


def pool2(a: torch.Tensor) -> torch.Tensor:
    """2 x 2 average, the last row and column repeated where odd."""
    if a.shape[0] % 2:
        a = torch.cat([a, a[-1:]], dim=0)
    if a.shape[1] % 2:
        a = torch.cat([a, a[:, -1:]], dim=1)
    return (a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2]
            + a[1::2, 1::2]) * 0.25


def pyramid(dem: torch.Tensor, levels: int) -> list:
    out = [dem.to(torch.float32)]
    for _ in range(levels - 1):
        out.append(pool2(out[-1]))
    return out


def crop_size(lv: Level, cells_per_deg_l: float, lat_hint_deg: float) -> int:
    """The crop's edge: the band's reach at the latitude hint + 5 degrees,
    or its steps, with slack, rounded up to 128 cells."""
    cell_n = EARTH_RADIUS_M * DEG / cells_per_deg_l
    cos_m = max(0.05, abs(math.cos(math.radians(
        min(abs(lat_hint_deg) + 5.0, 85.0)))))
    r = int(math.ceil(lv.d_hi / (cell_n * cos_m))) + 2
    half = max(lv.k_lo + lv.k_len, r) + 4
    return -(-(2 * half + 2) // 128) * 128


def level_view(v: View, lv: Level) -> View:
    """The viewer in the level's cells, the clip narrowed to its band."""
    s = float(2 ** lv.level)
    return v._replace(
        vi=(v.vi - 0.5 * (s - 1)) / s, vj=(v.vj - 0.5 * (s - 1)) / s,
        znear=torch.maximum(v.znear, ref.const(lv.d_lo, v.znear)),
        zfar=torch.minimum(v.zfar, ref.const(lv.d_hi, v.zfar)))


def crop(grid: torch.Tensor, v: View, c: int):
    """(grid, view) of the c x c crop around the viewer, origin floor(cell)
    - c // 2 clipped into the grid, the viewer rebased; the whole grid
    where c does not fit."""
    n = grid.shape[0]
    if c >= n:
        return grid, v
    oj, oi = (int(min(max(math.floor(float(x)) - c // 2, 0), n - c))
              for x in (v.vj, v.vi))
    return (grid[oj:oj + c, oi:oi + c],
            v._replace(vi=v.vi - float(oi), vj=v.vj - float(oj)))


def march_level(grid: torch.Tensor, v: View, az, lv: Level, *,
                cells_per_deg: float, near: bool, lat_hint_deg: float,
                znear_hint_m: float):
    """(segment (W, [N_NEAR +] k_len), geometry, near_hi) of one level's
    march on ``grid`` (the level's crop, or its whole grid) for the
    level's view ``v``."""
    k_cross = lv.k_lo + lv.k_len
    geo = ref.geometry(v, az, cells_per_deg)
    far = ref._far(grid, v, geo, ref.step_budget(k_cross, grid.shape[0]))
    seg = far[:, lv.k_lo:k_cross]
    if seg.shape[-1] < lv.k_len:
        seg = torch.nn.functional.pad(seg, (0, lv.k_len - seg.shape[-1]),
                                      value=NEG_BIG)
    m_star = torch.clamp(torch.ceil(v.znear / geo.scale - geo.e), min=0.0)
    near_hi = torch.maximum((m_star + geo.e) * geo.scale, v.znear[None])
    if near:
        patch_n = ref.near_patch_size(znear_hint_m, cells_per_deg,
                                      lat_hint_deg)
        if patch_n > ref.NEAR_PATCH_CAP or patch_n > max(grid.shape[0],
                                                         ref.ALIGN_MIN_N):
            raise ValueError(f"near patch {patch_n} outside this reference")
        seg = torch.cat([ref._near(grid, v, geo, near_hi, patch_n), seg],
                        dim=-1)
    return seg, geo, near_hi


class Dists(NamedTuple):
    """A sample index's distance: the near band's N_NEAR samples, then
    each level's segment."""
    e: list
    scale: list
    znear: torch.Tensor
    near_hi: torch.Tensor
    levels: tuple

    def d_of(self, idx):
        idxf = idx.to(torch.float32)
        d = self.znear + idxf * ((self.near_hi[:, None] - self.znear)
                                 * ref.recip(N_NEAR))
        off = N_NEAR
        for lv, e, scale in zip(self.levels, self.e, self.scale):
            d_l = (idxf - off + lv.k_lo + e[:, None]) * scale[:, None]
            d = torch.where((idx >= off) & (idx < off + lv.k_len), d_l, d)
            off += lv.k_len
        return d


def march(levels_grid, v: View, az, bands, *, cells_per_deg, lat_hint_deg,
          znear_hint_m):
    """(tanel (W, N_NEAR + sum k_len), Dists) over the pyramid's levels."""
    segs, es, scales, near_hi = [], [], [], None
    for i, lv in enumerate(bands):
        cpd_l = cells_per_deg / 2 ** lv.level
        v_l = level_view(v, lv)
        grid_c, v_c = crop(levels_grid[lv.level], v_l,
                           crop_size(lv, cpd_l, lat_hint_deg))
        seg, geo, hi = march_level(grid_c, v_c, az, lv, cells_per_deg=cpd_l,
                                   near=i == 0, lat_hint_deg=lat_hint_deg,
                                   znear_hint_m=znear_hint_m)
        segs.append(seg)
        es.append(geo.e)
        scales.append(geo.scale)
        if i == 0:
            near_hi = hi
    return (torch.cat(segs, dim=-1),
            Dists(es, scales, v.znear, near_hi, tuple(bands)))


def render(dem, v: View, *, width, height, cells_per_deg, lat_hint_deg,
           lat_plan_deg, znear_hint_m, dtype=torch.float32):
    """One LOD panorama of a square float32 DEM (row 0 south): (image
    (H, W, 3) uint8 BGR, ranges (H, W) float32) on dem's device. The
    plan's bands are sized at ``lat_plan_deg``, the crops and the near
    patch at ``lat_hint_deg``."""
    bands = plan(float(v.zfar), width, cells_per_deg, lat_plan_deg,
                 dem.shape[0])
    levels = [g.to(dtype).to(torch.float32) for g in pyramid(
        dem.to(dtype).to(torch.float32), 1 + max(b.level for b in bands))]
    tanel, dists = march(levels, v, ref.column_az(v, width), bands,
                         cells_per_deg=cells_per_deg,
                         lat_hint_deg=lat_hint_deg, znear_hint_m=znear_hint_m)
    tanel = tanel.to(dtype).to(torch.float32)
    return ref.image(tanel, dists, v, width=width, height=height)
