"""Level-of-detail march: a mip-chain of DEMs, each marching one distance
band.

Counterpart of horizonator_tpu.render.lod. Beyond the distance where a DEM
cell subtends less than about a pixel, the march switches to a 2x-coarser
average-pooled level, so the step count grows logarithmically with zfar
instead of linearly (SRTM1 to 300 km: ~10,400 flat crossing steps, 1,136
over five levels). Each level runs the window march (window-march kernel)
on a viewer-centred crop of its own grid, with its distance band as the
clip interval; the levels' tangent segments are concatenated in
ascending-distance order, so the resolve downstream is unchanged.

Both pyramids are built once per scene, in plain PyTorch, in the JAX
package's float32 operation order (its levels are bitwise the JAX
package's). The crop origin stays on the device: the crop is one gather
with index vectors built there, so a frame makes no host sync per level.

A batch ((B,) RenderParams fields) shares the plan, the crop sizes and
the pyramids; each level's crop is one gather at every viewpoint's own
origin, (B, c, c), and the level marches the batch in one launch over
those crops.

Where the JAX package is silent this module fails loudly:
- a 2D packed plane given to ``build_color_pyramid`` raises (the JAX
  package reads its rows as colour channels);
- samples that a crop sized from a too-small ``lat_hint_deg`` masks are
  masked here too (the image is the JAX package's). They lie past the
  level's step budget as well, which every crop exceeds, so
  ``dists.truncated`` counts their columns and the API warns.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import geometry, profiling
from ..geometry import const, recip
from .crossing import N_NEAR, NEG_BIG, crossing_geometry
from .raymarch import RenderParams, samples
from .texture import ColorPlanes2x, pack_cell_colors, unpack_color_planes
from .window import march_from_geometry

DEG = math.pi / 180.0


class LevelSpec(NamedTuple):
    """Static per-level plan entry."""
    level: int       # pyramid level (cell size = 2**level * base)
    d_lo: float      # band start, meters (half-open [d_lo, d_hi))
    d_hi: float
    k_lo: int        # first crossing index kept from this level's march
    k_len: int       # number of crossing indices kept


def _edge_pad_even(a: torch.Tensor) -> torch.Tensor:
    """Repeat the last row and column of the trailing two axes where their
    length is odd (jnp.pad mode="edge" to an even size)."""
    if a.shape[-2] % 2:
        a = torch.cat([a, a[..., -1:, :]], dim=-2)
    if a.shape[-1] % 2:
        a = torch.cat([a, a[..., -1:]], dim=-1)
    return a


def _pool2(a: torch.Tensor) -> torch.Tensor:
    """2x2 average over the trailing two axes, edge-padded to even sizes:
    level-L cell i covers level-(L-1) cells 2i, 2i+1. Summed in the JAX
    package's order (avg_pool2d's is another, and not bitwise)."""
    a = _edge_pad_even(a)
    return (a[..., 0::2, 0::2] + a[..., 0::2, 1::2]
            + a[..., 1::2, 0::2] + a[..., 1::2, 1::2]) * 0.25


def build_pyramid(dem: torch.Tensor, levels: int) -> tuple:
    """Average-pooled 2x mip chain: tuple of (n_L, n_L) float32 tensors on
    the DEM's device."""
    out = [dem.to(torch.float32)]
    for _ in range(levels - 1):
        out.append(_pool2(out[-1]))
    return tuple(out)


def _tent_half(a: torch.Tensor) -> torch.Tensor:
    """(3, 2m, 2m) half-cell planes -> (3, m, m) cell planes: a centred
    1/4-1/2-1/4 tent at the even texels (edge-clamped), separable. Texel 2J
    sits at grid J, so the tent stays on the DEM pyramid's cell centres.
    Unfused, as the JAX package's eager build runs it (integer colours,
    the planes a ColorPlanes2x unpacks to, round the same either way)."""
    e = F.pad(a[None], (1, 1, 1, 1), mode="replicate")[0]
    rows = (0.25 * e[:, 0:-2:2, :] + 0.5 * e[:, 1:-1:2, :]
            + 0.25 * e[:, 2::2, :])
    return (0.25 * rows[:, :, 0:-2:2] + 0.5 * rows[:, :, 1:-1:2]
            + 0.25 * rows[:, :, 2::2])


def build_color_pyramid(color_planes, levels: int, n0: int) -> tuple:
    """Mip chain of texture/hillshade colour planes for the LOD march.

    Level 0 is the input itself when it is a ColorPlanes2x or (3, 2*n0,
    2*n0) half-cell planes; every cell-resolution level (level 0 when the
    input is (3, n0, n0), and every level L >= 1) is a packed (n_L, n_L)
    int32 0x00RRGGBB plane (texture.pack_cell_colors) on build_pyramid's
    level-L grid, average-pooled in float first. Half-cell planes come to
    cell resolution through a centred tent (``_tent_half``)."""
    if isinstance(color_planes, ColorPlanes2x):
        base = unpack_color_planes(color_planes.full_packed)  # (3, 2n, 2n)
        s = 2
    else:
        if color_planes.dim() != 3 or color_planes.shape[0] != 3:
            raise ValueError(
                f"build_color_pyramid needs a ColorPlanes2x or (3, n, n) / "
                f"(3, 2n, 2n) B/G/R planes, got {tuple(color_planes.shape)}"
                f" {color_planes.dtype}: a packed 2D plane has no pyramid "
                f"of its own (pack after pooling)")
        base = color_planes.to(torch.float32)
        s = base.shape[1] // n0
    out = [color_planes if s == 2 else pack_cell_colors(base)]
    cur = _tent_half(base) if s == 2 else base                 # (3, n0, n0)
    for _ in range(1, levels):
        cur = _pool2(cur)               # pooled in float (exact averages)
        out.append(pack_cell_colors(cur))
    return tuple(out)


def lod_plan(zfar_m: float, width: int, cells_per_deg: float, lat_deg: float,
             n: int, *, theta_px: float = 1.0, span_hint_rad: float = None,
             max_levels: int = 8) -> tuple:
    """Static band plan covering (0, zfar]: a tuple of LevelSpec. A level's
    band ends where its cell stops resolving at the output, at distance
    cell_L / theta, theta = theta_px * (azimuth span / width); the default
    span hint is the full circle."""
    if span_hint_rad is None:
        span_hint_rad = 2.0 * math.pi
    cell_n0 = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    # the march steps at the true cell_e: a floored cos would under-budget
    # k_hi and truncate each band's far crossings near the poles
    cos_lat = max(1e-4, abs(math.cos(math.radians(lat_deg))))
    cell_e0 = cell_n0 * cos_lat
    theta = theta_px * span_hint_rad / width

    specs = []
    d_lo = 0.0
    lvl = 0
    while True:
        cell_e = cell_e0 * (2 ** lvl)
        cell_n = cell_n0 * (2 ** lvl)
        n_l = -(-n // (2 ** lvl))
        d_hi = cell_e / max(theta, 1e-9)
        last = (d_hi >= zfar_m or lvl == max_levels - 1
                or n_l // 2 < 192)     # next level too coarse/tiny
        if last:
            d_hi = zfar_m
        if d_hi > d_lo:
            diag = math.hypot(cell_n, cell_e)
            k_lo = max(0, int(d_lo / diag) - 2)
            k_hi = int(math.ceil(d_hi / cell_e)) + 3
            k_hi = min(k_hi, n_l + 2)
            specs.append(LevelSpec(lvl, d_lo, d_hi, k_lo,
                                   max(1, k_hi - k_lo)))
            d_lo = d_hi
        if last or d_lo >= zfar_m:
            break
        lvl += 1
    return tuple(specs)


def level_crop_size(spec: LevelSpec, cells_per_deg_l: float,
                    lat_hint_deg: float) -> int:
    """Static viewer-centred crop edge (cells) for one LOD level: every
    sample of the band (d <= d_hi) lies within d_hi / min(cell_n, cell_e)
    cells of the viewer, with the latitude margin of window_size (+5 deg
    over the hint) and bilinear slack; a multiple of 128."""
    cell_n = geometry.EARTH_RADIUS_M * DEG / cells_per_deg_l
    cos_m = max(0.05, abs(math.cos(math.radians(
        min(abs(lat_hint_deg) + 5.0, 85.0)))))
    r = int(math.ceil(spec.d_hi / (cell_n * cos_m))) + 2
    half = max(spec.k_lo + spec.k_len, r) + 4
    return -(-(2 * half + 2) // 128) * 128


def _crop_level(dem_l: torch.Tensor, p_l: RenderParams, colors_l,
                spec: LevelSpec, cells_per_deg_l: float,
                lat_hint_deg: float):
    """(dem, params, colors, origin): the viewer-centred square crop of one
    level's grid and colours, the viewer cell rebased into crop
    coordinates, and the crop's (oj, oi) int32 origin on the device (None
    when not cropped: a rectangular grid, or one within about one crop).

    The origin is floor(viewer cell) - c//2, clipped into the grid; the
    crop is one gather. Rebasing by an integer is exact in float32, so
    every crossing distance is bitwise the uncropped march's. The samples
    are not: a column's cross position ``a`` rounds at the crop's
    magnitude, so a cropped level's tangents differ from the whole
    grid's in their last bits. A batch
    crops each viewpoint at its own origin in the same gather: (B, c, c)
    grids, packed (B, c, c) and ColorPlanes2x (B, 2c, 2c) colours, (3, B,
    c, c) float planes, (B,) origins."""
    nj, ni = dem_l.shape
    c = level_crop_size(spec, cells_per_deg_l, lat_hint_deg)
    if nj != ni or c >= ni:
        return dem_l, p_l, colors_l, None
    oj, oi = (torch.clamp(torch.floor(v).to(torch.int32) - c // 2, 0, n - c)
              for v, n in ((p_l.viewer_cell_j, nj),
                           (p_l.viewer_cell_i, ni)))

    def crop(a, o_j, o_i, size):
        r = torch.arange(size, device=a.device)
        rows = (o_j[..., None] + r)[..., :, None]
        cols = (o_i[..., None] + r)[..., None, :]
        return a[..., rows, cols]

    dem_c = crop(dem_l, oj, oi, c)
    if colors_l is None:
        colors_c = None
    elif isinstance(colors_l, ColorPlanes2x):
        colors_c = ColorPlanes2x(crop(colors_l.full_packed, 2 * oj, 2 * oi,
                                      2 * c))
    else:        # packed (n, n) int32 or (3, n, n) float cell planes
        colors_c = crop(colors_l, oj, oi, c)
    p_c = p_l._replace(viewer_cell_j=p_l.viewer_cell_j - oj.to(torch.float32),
                       viewer_cell_i=p_l.viewer_cell_i - oi.to(torch.float32))
    return dem_c, p_c, colors_c, (oj, oi)


class LodDists(NamedTuple):
    """Distance-from-index mapping across the near band + level segments."""
    e: torch.Tensor          # (L, W) per-level first-crossing offsets
    scale: torch.Tensor      # (L, W) per-level meters per step
    znear: torch.Tensor
    near_hi: torch.Tensor    # (W,)
    # (a batch: (L, B, W), (B,) znear and guards, (B, W) near_hi)
    n_near: int
    k_lo: tuple              # static per-level
    seg_len: tuple
    # int32 0-d, summed over the levels: near-band samples outside the
    # static patch
    dropped: torch.Tensor | None = None
    # int32 0-d, summed over the levels: columns cut short of their band
    # (0 when the plan and crops were sized for the viewer's latitude; a
    # too-small lat_hint_deg under-budgets both)
    truncated: torch.Tensor | None = None

    def d_of(self, idx: torch.Tensor) -> torch.Tensor:
        """Sample distance for (W, X) integer sample indices ((B, W, X) in
        a batch)."""
        q = self.n_near
        idxf = idx.to(torch.float32)
        znear = samples(self.znear)
        d = znear + idxf * ((self.near_hi[..., None] - znear)
                            * recip(max(q, 1)))
        off = q
        for li, (klo, slen) in enumerate(zip(self.k_lo, self.seg_len)):
            m = idxf - off + klo
            d_l = (m + self.e[li][..., None]) * self.scale[li][..., None]
            d = torch.where((idx >= off) & (idx < off + slen), d_l, d)
            off += slen
        return d


def _scaled_params(p: RenderParams, level: int) -> RenderParams:
    s = float(2 ** level)
    return p._replace(viewer_cell_i=(p.viewer_cell_i - 0.5 * (s - 1)) / s,
                      viewer_cell_j=(p.viewer_cell_j - 0.5 * (s - 1)) / s)


def level_inputs(pyramid, params: RenderParams, spec: LevelSpec, *,
                 width: int, cells_per_deg: float, lat_hint_deg: float,
                 color_pyramid=None):
    """One level's march inputs, as march_lod takes them: (dem, params,
    colours, geometry) of the level's viewer-centred crop
    (_crop_level), the params' clip interval narrowed to the band."""
    p = params
    cpd_l = cells_per_deg / (2 ** spec.level)
    p_l = _scaled_params(p, spec.level)._replace(
        znear=torch.maximum(p.znear, const(spec.d_lo, p.znear)),
        zfar=torch.minimum(p.zfar, const(spec.d_hi, p.zfar)))
    with profiling.phase("hz.lod.crop"):
        dem_c, p_c, colors_c, _ = _crop_level(
            pyramid[spec.level], p_l,
            None if color_pyramid is None else color_pyramid[spec.level],
            spec, cpd_l, lat_hint_deg)
    geo = crossing_geometry(p_c, width=width, cells_per_deg=cpd_l)
    return dem_c, p_c, colors_c, geo


def march_lod(pyramid, params: RenderParams, *, width: int, plan,
              cells_per_deg: float, lat_hint_deg: float = 45.0,
              n_near: int = N_NEAR, znear_hint_m=100.0, color_pyramid=None,
              plain: bool = False):
    """Multi-level crossing march: (tanel (W, n_near + sum(seg_len)),
    dists (LodDists), az), plus tex (W, same) int32 packed sample colours
    when ``color_pyramid`` is given. That is horizonator_tpu's march_lod
    without its run_max: the resolve takes the raw tangents
    (``torch.cummax(tanel, -1)`` gives it). A batch of (B,) params gives
    (B, W, ...), one launch a level.

    ``pyramid``: build_pyramid's tuple (at least max level + 1 entries);
    ``plan``: lod_plan's tuple; ``color_pyramid``: build_color_pyramid's
    tuple, each level's march sampling its own planes. ``plain`` runs the
    march's plain PyTorch version on any device."""
    p = params
    textured = color_pyramid is not None
    segs, tex_segs, es, scales = [], [], [], []
    near_hi = az = None
    with profiling.phase("hz.lod.march"):
        profiling.count("hz.lod.renders", p.znear.numel())
        dropped = torch.zeros(p.znear.shape, dtype=torch.int32,
                              device=p.znear.device)
        truncated = torch.zeros_like(dropped)
        for si, spec in enumerate(plan):
            with profiling.phase("hz.lod.level"):
                first = si == 0
                nn = n_near if first else 0
                dem_c, p_c, colors_c, geo = level_inputs(
                    pyramid, p, spec, width=width,
                    cells_per_deg=cells_per_deg, lat_hint_deg=lat_hint_deg,
                    color_pyramid=color_pyramid)
                k_cross = spec.k_lo + spec.k_len
                out = march_from_geometry(
                    dem_c, p_c, geo, k_cross=k_cross,
                    cells_per_deg=cells_per_deg / (2 ** spec.level),
                    lat_hint_deg=lat_hint_deg, n_near=nn,
                    znear_hint_m=znear_hint_m if first else None,
                    color_planes=colors_c, plain=plain)
                tanel_l, dists_l = out[0], out[1]
                k_avail = tanel_l.shape[-1] - nn
                hi = min(k_cross, k_avail)
                # the grid capped K (tiny DEM)
                pad_k = spec.k_len - (hi - spec.k_lo)
                seg = tanel_l[..., nn + spec.k_lo: nn + hi]
                if pad_k > 0:
                    seg = F.pad(seg, (0, pad_k), value=NEG_BIG)
                if first:
                    segs.append(tanel_l[..., :nn])
                    near_hi, az = dists_l.near_hi, geo.az
                segs.append(seg)
                if textured:
                    tex_l = out[2]
                    tseg = tex_l[..., nn + spec.k_lo: nn + hi]
                    if pad_k > 0:   # padded lanes are NEG_BIG: never a pixel's
                        tseg = F.pad(tseg, (0, pad_k))
                    if first:
                        tex_segs.append(tex_l[..., :nn])
                    tex_segs.append(tseg)
                es.append(dists_l.e)
                scales.append(dists_l.scale)
                dropped = dropped + dists_l.dropped
                truncated = truncated + dists_l.truncated

        dists = LodDists(e=torch.stack(es), scale=torch.stack(scales),
                         znear=p.znear, near_hi=near_hi, n_near=n_near,
                         k_lo=tuple(s.k_lo for s in plan),
                         seg_len=tuple(s.k_len for s in plan),
                         dropped=dropped, truncated=truncated)
        tanel = torch.cat(segs, dim=-1)
        if textured:
            return tanel, dists, az, torch.cat(tex_segs, dim=-1)
        return tanel, dists, az
