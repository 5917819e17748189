"""Texture atlas sampling and color planes for ``--texture`` and hillshade.

Counterpart of horizonator_tpu.render.texture. The reference packs
slippy-map tiles into one GL texture and samples it in the fragment shader
(vertex.glsl:51-61, fragment.glsl:21); here, as in the JAX package, the
atlas is resampled once per scene onto the DEM grid (cell or half-cell
resolution) and the window march samples those planes per crossing.

Atlas layout: (NtilesY*256, NtilesX*256, 3) uint8 BGR, row 0 = the NORTH
edge, or its packed (Hat, Wat) int32 0x00RRGGBB form (B in the low byte).

What the port does not copy: the JAX ``ColorPlanes2x`` carries four
prestrided, transposed and reversed views of the half-cell plane for the
TPU's DMA engine (its ns/ns_rev/ew/ew_rev). The CUDA march reads its taps
straight from the packed (2n, 2n) plane, so the port keeps only that.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import geometry
from ..geometry import const, recip
from ..kernels.window_march import fma32

OSM_RENDER_ZOOM = 12     # horizonator-lib.c:25
OSM_TILE_PX = 256        # horizonator-lib.c:26-27
DEG = math.pi / 180.0


class AtlasParams(NamedTuple):
    """Static geometry of the packed tile atlas."""
    origin_cell_lon_deg: float   # lon of DEM grid cell i=0
    origin_cell_lat_deg: float   # lat of DEM grid cell j=0
    osmtile_lowest_x: int
    osmtile_lowest_y: int
    ntiles_x: int
    ntiles_y: int
    zoom: int = OSM_RENDER_ZOOM


class ColorPlanes2x(NamedTuple):
    """Half-cell color planes, packed once per scene: ``full_packed`` is
    the (2n, 2n) int32 0x00RRGGBB plane, [J2, I2] = the texel at grid
    coordinate (I2/2, J2/2), row 0 = SOUTH."""
    full_packed: torch.Tensor

    @property
    def n(self) -> int:
        return self.full_packed.shape[0] // 2


def tile_xy_from_latlon(lat_deg: float, lon_deg: float,
                        zoom: int) -> tuple[int, int]:
    """Integer slippy-tile indices containing a lat/lon
    (horizonator-lib.c:225-245)."""
    n = float(1 << zoom)
    lon = lon_deg * DEG
    lat = lat_deg * DEG
    x = int(min(n, max(0.0, lon * n / (2 * math.pi) + n / 2)))
    y = int(n / 2 * (1.0 - math.log((math.sin(lat) + 1.0) / math.cos(lat))
                     / math.pi))
    return x, y


def atlas_px_from_grid(i_pos: torch.Tensor, j_pos: torch.Tensor,
                       ap: AtlasParams, cells_per_deg: int):
    """DEM grid coords -> fractional atlas pixel coords (exact spherical
    mercator, float32 in the JAX package's operation order as XLA compiles
    it: it folds the longitude's chain of constant factors, DEG * n /
    (2 pi), into one float32 constant and n/2 - lowest_x into another,
    and contracts three multiply-adds into FMAs)."""
    n = float(1 << ap.zoom)
    lon_scale = float(np.float32(np.float32(DEG) * np.float32(n))
                      * np.float32(recip(2.0 * math.pi)))

    def c(x):
        return const(x, i_pos)

    inv_cpd = c(recip(cells_per_deg))
    lon = fma32(i_pos, inv_cpd, c(ap.origin_cell_lon_deg))
    px = fma32(lon, c(lon_scale),
               c(n / 2.0 - ap.osmtile_lowest_x)) * OSM_TILE_PX
    lat = fma32(j_pos, inv_cpd, c(ap.origin_cell_lat_deg)) * DEG
    mer = torch.log((torch.sin(lat) + 1.0) / torch.cos(lat))
    ytile = n / 2.0 * fma32(-mer, c(recip(math.pi)), c(1.0))
    py = (ytile - ap.osmtile_lowest_y) * OSM_TILE_PX
    return px, py


def _pack_bgr_planes(planes: torch.Tensor) -> torch.Tensor:
    """(3, ...) B/G/R values -> int32 0x00RRGGBB, each rounded (half to
    even) and clipped to u8 first."""
    ci = torch.clamp(torch.round(planes.to(torch.float32)), 0.0, 255.0).to(
        torch.int32)
    return (ci[2] << 16) | (ci[1] << 8) | ci[0]


def pack_cell_colors(planes: torch.Tensor) -> torch.Tensor:
    """(3, nj, ni) B/G/R cell-resolution planes -> (nj, ni) packed int32
    0x00RRGGBB. Run once per scene."""
    return _pack_bgr_planes(planes)


def prepare_color_planes(color2x: torch.Tensor) -> ColorPlanes2x:
    """(3, 2n, 2n) half-cell planes (atlas_to_grid_colors(scale=2)) ->
    ColorPlanes2x, packed once per scene on the planes' device."""
    return ColorPlanes2x(full_packed=_pack_bgr_planes(color2x))


def unpack_color_planes(full_packed: torch.Tensor) -> torch.Tensor:
    """Packed 0x00RRGGBB -> (3, ...) float32 B/G/R planes."""
    return _unpack_bgr(full_packed).movedim(-1, 0)


def pack_atlas(atlas: torch.Tensor) -> torch.Tensor:
    """(Hat, Wat, 3) uint8 BGR atlas -> (Hat, Wat) int32 0x00RRGGBB."""
    a = atlas.to(torch.int32)
    return (a[..., 2] << 16) | (a[..., 1] << 8) | a[..., 0]


def _unpack_bgr(v: torch.Tensor) -> torch.Tensor:
    """Packed 0x00RRGGBB -> (..., 3) float32 B, G, R: the int32's low
    three bytes, B first in memory (little-endian, as CPUs and CUDA
    devices are), converted in one pass."""
    b = v.to(torch.int32).contiguous().view(torch.uint8)
    return b.reshape(*v.shape, 4)[..., :3].to(torch.float32)


def sample_atlas_bgr(atlas: torch.Tensor, ap: AtlasParams,
                     i_pos: torch.Tensor, j_pos: torch.Tensor,
                     cells_per_deg: int) -> torch.Tensor:
    """Bilinear atlas sample at DEM grid coords: (..., 3) float32 BGR in
    [0, 255]. ``atlas``: packed int32 (pack_atlas) or (Hat, Wat, 3) uint8."""
    if atlas.dim() == 3:
        atlas = pack_atlas(atlas)
    px, py = atlas_px_from_grid(i_pos, j_pos, ap, cells_per_deg)
    h, w = atlas.shape
    x0 = torch.clamp(torch.floor(px - 0.5), 0, w - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(py - 0.5), 0, h - 2).to(torch.int64)
    fx = torch.clamp(px - 0.5 - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(py - 0.5 - y0, 0.0, 1.0)[..., None]
    flat = atlas.reshape(-1)
    base = y0 * w + x0
    c00 = _unpack_bgr(flat[base])
    c10 = _unpack_bgr(flat[base + 1])
    c01 = _unpack_bgr(flat[base + w])
    c11 = _unpack_bgr(flat[base + w + 1])
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def atlas_to_grid_colors(atlas: torch.Tensor, ap: AtlasParams, n: int,
                         cells_per_deg: int, scale: int = 1) -> torch.Tensor:
    """Resample the atlas onto the (supersampled) DEM grid once per scene:
    (3, scale*n, scale*n) float32 B/G/R planes, [c][J, I], row 0 = SOUTH;
    plane index J is grid coordinate J/scale. Runs on the atlas' device."""
    m = scale * n
    ii = torch.arange(m, dtype=torch.float32, device=atlas.device) \
        * recip(scale)
    bgr = sample_atlas_bgr(atlas, ap, ii[None, :].expand(m, m),
                           ii[:, None].expand(m, m), cells_per_deg)
    return bgr.movedim(-1, 0)


def hillshade_planes(dem: torch.Tensor, cells_per_deg: int, lat_deg: float,
                     *, sun_az_deg: float = 315.0, sun_alt_deg: float = 45.0,
                     ambient: float = 0.25, scale: int = 2,
                     cast_shadows: bool = False,
                     shadow_soft_m: float = 2.0) -> torch.Tensor:
    """Lambertian hillshade planes from the DEM itself: (3, scale*nj,
    scale*ni) float32 gray BGR in [0, 255], the contract of
    atlas_to_grid_colors, so they feed the textured march unchanged.

    Normals from central differences (one-sided at the edges); the sun at
    ``sun_az_deg`` clockwise from north, ``sun_alt_deg`` up; shade =
    ambient + (1 - ambient) * max(n.s, 0). ``scale=2`` interpolates at the
    half-cell coordinates. ``cast_shadows`` multiplies the direct term by
    ops.shadows.shadow_light (terrain occluding the sun ray, ramped over
    ``shadow_soft_m``); ambient light is unaffected."""
    if scale not in (1, 2):
        raise ValueError(f"scale must be 1 or 2, got {scale}")
    z = dem.to(torch.float32)
    cell_n = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    cell_e = cell_n * max(0.05, abs(math.cos(math.radians(lat_deg))))
    dzdn = torch.cat([z[1:2] - z[0:1], (z[2:] - z[:-2]) * 0.5,
                      z[-1:] - z[-2:-1]], dim=0) * recip(cell_n)
    dzde = torch.cat([z[:, 1:2] - z[:, 0:1], (z[:, 2:] - z[:, :-2]) * 0.5,
                      z[:, -1:] - z[:, -2:-1]], dim=1) * recip(cell_e)
    az = math.radians(sun_az_deg)
    alt = math.radians(sun_alt_deg)
    # unnormalized normal (-dz/de, -dz/dn, 1); row 0 = SOUTH, so +j is north
    ndot = (-dzde * math.sin(az) * math.cos(alt)
            - dzdn * math.cos(az) * math.cos(alt)
            + math.sin(alt))
    ndot = ndot / torch.sqrt(dzde * dzde + dzdn * dzdn + 1.0)
    direct = torch.clamp(ndot, min=0.0)
    if cast_shadows:
        from ..ops.shadows import shadow_light
        direct = direct * shadow_light(
            z, cells_per_deg=cells_per_deg, lat_deg=lat_deg,
            sun_az_deg=float(sun_az_deg), sun_alt_deg=float(sun_alt_deg),
            soft_m=shadow_soft_m)
    shade = ambient + (1.0 - ambient) * direct
    gray = torch.clamp(shade * 255.0, 0.0, 255.0)
    if scale == 2:
        def up2(a):
            mid = torch.cat([0.5 * (a[:-1] + a[1:]), a[-1:]], dim=0)
            a = torch.stack([a, mid], dim=1).reshape(2 * a.shape[0],
                                                     a.shape[1])
            midc = torch.cat([0.5 * (a[:, :-1] + a[:, 1:]), a[:, -1:]],
                             dim=1)
            return torch.stack([a, midc], dim=2).reshape(a.shape[0],
                                                         2 * a.shape[1])
        gray = up2(gray)
    return gray[None].expand(3, *gray.shape)


def scene_from_jax(color_planes=None, atlas=None, atlas_params=None, *,
                   device):
    """The port's (color_planes, atlas, atlas_params) from the JAX
    package's textured scene state, every array taken across as numpy
    (``np.asarray`` of a JAX array works): a JAX ColorPlanes2x becomes the
    port's (its ``full_packed``), packed or float cell planes and the
    packed atlas become tensors on ``device``, AtlasParams is copied field
    by field."""
    def tensor(x):
        return torch.from_numpy(np.array(np.asarray(x))).to(device)

    if color_planes is not None:
        full = getattr(color_planes, "full_packed", None)
        color_planes = (ColorPlanes2x(tensor(full)) if full is not None
                        else tensor(color_planes))
    if atlas is not None:
        atlas = tensor(atlas)
    if atlas_params is not None:
        atlas_params = AtlasParams(*atlas_params)
    return color_planes, atlas, atlas_params
