"""Plain reference of the textured panorama (window sampler, hybrid quality).

One viewpoint at a time, in plain PyTorch, on whatever device its inputs
lie on; it imports nothing of the program. It adds to ``render.py``'s
untextured arithmetic (the ranges are that file's, unchanged) the colour
that the program's textured render defines, frozen here so that a later
change to the program cannot move it:

- the atlas: the z12 tiles' pixels packed into one (Hat, Wat) int32
  0x00RRGGBB texture, row 0 the northern edge of tile row ``y_lo``;
- half-cell colour planes, resampled once a scene from the atlas: the
  texel at grid coordinate (I / 2, J / 2) is the atlas's bilinear sample
  at its exact spherical-Mercator pixel, rounded to 8 bits a channel;
- each far sample's colour from the two half-cell texels on the crossed
  grid line either side of its position, ``fma(h_hi, c_hi, h_lo * c_lo)``
  a channel, rounded; the near band's from the planes' bilinear patch
  around the viewer;
- the hybrid near field: every sample within ``exact_near_m`` (the near
  band and the first ``k_x`` crossings) takes the atlas's own bilinear
  texel in place of the planes', through one viewer-centred atlas patch
  of ``p_at`` px;
- each pixel the colour of its first-crossing sample, blended
  ``0.7 * texture + 0.3 * shading`` with the shading the distance-red
  ramp, sky blue.

Departures from the upstream shaders (fragment.glsl, vertex.glsl), the
program's: beyond ``exact_near_m`` a pixel's colour comes from the
half-cell planes, sampled at the crossing the march reached, not from the
z12 texel under each fragment (a plane texel is ~46 x 38 m at 34 deg, a z12
texel ~32 m); colours are rounded to 8 bits when the planes are made and
again per sample; the blend is rounded once, to the nearest 8-bit value
(the GL framebuffer's rounding); the upstream's shading term is its own
distance colour, the program's red ramp.

``dtype``: the storage precision of the DEM, the march's tangent field and
the colour planes; float32 is the reference, bfloat16 the control.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import render as ref
from .render import (ALIGN_MIN_N, DEG, EARTH_RADIUS_M, N_NEAR, TILE_K, View,
                     const, fma32, recip)

TILE_PX = 256
EXACT_PATCH_CAP = 256


class Atlas(NamedTuple):
    """The packed atlas and where it lies."""
    packed: torch.Tensor        # (Hat, Wat) int32 0x00RRGGBB, row 0 north
    origin_lon: float           # lon of grid cell i = 0
    origin_lat: float           # lat of grid cell j = 0
    x_lo: int                   # the tile of the atlas's first column
    y_lo: int                   # ... and first row
    zoom: int


def pack_atlas(pixels: dict, x_lo: int, y_lo: int, x_hi: int, y_hi: int,
               device) -> torch.Tensor:
    """(Hat, Wat) int32 0x00RRGGBB from each tile's (256, 256, 3) RGB
    ``pixels[(x, y)]``, tile (x, y) at rows (y - y_lo) * 256 and columns
    (x - x_lo) * 256."""
    rgb = np.zeros(((y_hi - y_lo + 1) * TILE_PX, (x_hi - x_lo + 1) * TILE_PX,
                    3), np.uint8)
    for (x, y), px in pixels.items():
        r0, c0 = (y - y_lo) * TILE_PX, (x - x_lo) * TILE_PX
        rgb[r0:r0 + TILE_PX, c0:c0 + TILE_PX] = px
    a = torch.from_numpy(rgb).to(device).to(torch.int32)
    return (a[..., 0] << 16) | (a[..., 1] << 8) | a[..., 2]


def unpack(v: torch.Tensor) -> torch.Tensor:
    """Packed 0x00RRGGBB -> (3, ...) float32 B, G, R."""
    return torch.stack([((v >> s) & 0xff).to(torch.float32)
                        for s in (0, 8, 16)])


def pack(bgr: torch.Tensor) -> torch.Tensor:
    """(3, ...) float B, G, R -> 0x00RRGGBB, each rounded half to even and
    clipped to [0, 255]."""
    c = torch.clamp(torch.round(bgr), 0.0, 255.0).to(torch.int32)
    return (c[2] << 16) | (c[1] << 8) | c[0]


def atlas_px(i_pos, j_pos, at: Atlas, cells_per_deg: int):
    """Fractional atlas pixel (x, y) of DEM grid coordinates: the
    spherical-Mercator tile coordinates less the atlas's first tile, times
    256, in float32 with the longitude's constant factors folded into one
    and three multiply-adds fused."""
    n = float(1 << at.zoom)
    lon_scale = float(np.float32(np.float32(DEG) * np.float32(n))
                      * np.float32(recip(2.0 * math.pi)))

    def c(x):
        return const(x, i_pos)

    inv_cpd = c(recip(cells_per_deg))
    lon = fma32(i_pos, inv_cpd, c(at.origin_lon))
    px = fma32(lon, c(lon_scale), c(n / 2.0 - at.x_lo)) * TILE_PX
    lat = fma32(j_pos, inv_cpd, c(at.origin_lat)) * DEG
    mer = torch.log((torch.sin(lat) + 1.0) / torch.cos(lat))
    ytile = n / 2.0 * fma32(-mer, c(recip(math.pi)), c(1.0))
    return px, (ytile - at.y_lo) * TILE_PX


def sample_atlas(at: Atlas, i_pos, j_pos, cells_per_deg: int):
    """(..., 3) float32 B, G, R: the atlas's bilinear sample at grid
    coordinates, texel centres at half-integer pixels, clamped at its
    edges."""
    px, py = atlas_px(i_pos, j_pos, at, cells_per_deg)
    h, w = at.packed.shape
    x0 = torch.clamp(torch.floor(px - 0.5), 0, w - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(py - 0.5), 0, h - 2).to(torch.int64)
    fx = torch.clamp(px - 0.5 - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(py - 0.5 - y0, 0.0, 1.0)[..., None]
    flat = at.packed.reshape(-1)
    base = y0 * w + x0
    c00, c10, c01, c11 = (unpack(flat[base + o]).movedim(0, -1)
                          for o in (0, 1, w, w + 1))
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def color_planes(at: Atlas, n: int, cells_per_deg: int,
                 dtype=torch.float32) -> torch.Tensor:
    """(2n, 2n) packed half-cell plane, [J, I] the colour at grid
    coordinate (I / 2, J / 2), row 0 south; the float planes stored in
    ``dtype`` before they are rounded to 8 bits."""
    m = 2 * n
    ii = torch.arange(m, dtype=torch.float32, device=at.packed.device) \
        * recip(2)
    bgr = sample_atlas(at, ii[None, :].expand(m, m), ii[:, None].expand(m, m),
                       cells_per_deg).movedim(-1, 0)
    return pack(bgr.to(dtype).to(torch.float32))


def _bilerp(c, x, y, u0, v0):
    """sum_v hat(y - v) sum_u hat(x - u) c[v][u] over the four corners,
    the v sum fused into one multiply-add; corners (3, ...)."""
    hx0, hx1 = ref._hat(x, u0), ref._hat(x, u0 + 1.0)
    acc0 = hx0 * c[0][0] + hx1 * c[0][1]
    acc1 = hx0 * c[1][0] + hx1 * c[1][1]
    return fma32(ref._hat(y, v0 + 1.0), acc1, ref._hat(y, v0) * acc0)


def _corners(x, y, size: int):
    u0, v0 = torch.floor(x), torch.floor(y)
    rows = [(v0 + d).clamp(0, size - 1).to(torch.int64) for d in (0, 1)]
    cls = [(u0 + d).clamp(0, size - 1).to(torch.int64) for d in (0, 1)]
    return u0, v0, rows, cls


def _far_colors(plane, v: View, geo: ref.Geom, k: int, n: int):
    """(W, k) packed colours of the far field's crossings: the two
    half-cell texels on the crossed line, 0 at invalid samples."""
    a, t, e, dscale, axis0, sgn = (x[:, None] for x in (
        geo.a, geo.t, geo.e, geo.scale, geo.axis0.to(torch.float32),
        geo.sign.to(torch.float32)))
    jd = geo.j_dom[:, None]
    mf = torch.arange(k, dtype=torch.float32, device=plane.device)[None, :]
    pos = fma32(mf, t, a)
    axis_m = axis0 + mf * sgn
    dm = (mf + e) * dscale
    hi = float(n - 1)
    valid = ((axis_m >= 0.0) & (axis_m <= hi) & (pos >= 0.0) & (pos <= hi)
             & (dm >= v.znear) & (dm <= v.zfar))
    fl, h_lo, h_hi = ref._hats(pos * 2.0)
    m = 2 * n
    ax = axis_m.clamp(-1, n).to(torch.int64) * 2
    r = fl.clamp(-1, m).to(torch.int64)
    row = torch.where(jd, ax, r).clamp(0, m - 1)
    cl = torch.where(jd, r, ax).clamp(0, m - 1)
    i_lo = row * m + cl
    has_hi = torch.where(jd, cl + 1 < m, row + 1 < m)
    i_hi = torch.where(has_hi, i_lo + torch.where(jd, 1, m), i_lo)
    flat = plane.reshape(-1)
    c_lo, c_hi = flat[i_lo], torch.where(has_hi, flat[i_hi], 0)
    packed = torch.zeros_like(c_lo)
    for sh in (0, 8, 16):
        x = fma32(h_hi, ((c_hi >> sh) & 0xff).to(torch.float32),
                  h_lo * ((c_lo >> sh) & 0xff).to(torch.float32))
        packed |= torch.clamp(torch.round(x), 0.0, 255.0).to(
            torch.int32) << sh
    return torch.where(valid, packed, 0)


def _near_samples(v: View, geo: ref.Geom, near_hi):
    """(dq, iq, jq) (W, N_NEAR): the near band's distances over [znear,
    near_hi) and their grid positions."""
    q = torch.arange(N_NEAR, dtype=torch.float32,
                     device=near_hi.device)[None, :]
    dq = torch.clamp(v.znear + q * ((near_hi[:, None] - v.znear)
                                    * recip(N_NEAR)), min=1e-3)
    return (dq,) + _grid_pos(v, geo, dq)


def _grid_pos(v: View, geo: ref.Geom, d):
    iq = v.vi + d * torch.sin(geo.az)[:, None] / geo.cell_e
    jq = v.vj + d * torch.cos(geo.az)[:, None] * (1.0 / geo.cell_n)
    return iq, jq


def _near_colors(plane, v: View, iq, jq, patch_n: int, n: int):
    """(W, N_NEAR) packed colours of the near band: bilinear in the
    planes' half-cell patch over the elevation patch around the viewer."""
    ng = max(n, ALIGN_MIN_N)
    if ng > n:                                  # small grids: zero-padded
        plane = torch.nn.functional.pad(plane, (0, 2 * (ng - n),
                                                0, 2 * (ng - n)))
    oi, oj = (torch.clamp(torch.floor(c).to(torch.int32)
                          - (patch_n // 2 - 1), 0, ng - patch_n)
              for c in (v.vi, v.vj))
    x = iq * 2 - (2 * oi).to(torch.float32)
    y = jq * 2 - (2 * oj).to(torch.float32)
    u0, v0, rows, cls = _corners(x, y, 2 * patch_n)
    c = [[unpack(plane[2 * oj + r, 2 * oi + cc]) for cc in cls]
         for r in rows]
    return pack(_bilerp(c, x, y, u0, v0))


def exact_near_sizes(exact_near_m: float, cells_per_deg: int,
                     lat_hint_deg: float, zoom: int):
    """(k_x, p_at): the crossings that reach exact_near_m and the atlas
    patch's edge in px, worst case over the latitude bucket."""
    cos_l = max(0.05, math.cos(math.radians(min(abs(lat_hint_deg) + 5.0,
                                                85.0))))
    cell_e_min = EARTH_RADIUS_M * DEG / cells_per_deg * cos_l
    k_x = int(math.ceil(exact_near_m / cell_e_min)) + 2
    texel_m = 40075016.686 / (256.0 * (1 << zoom)) * cos_l
    p_at = int(math.ceil(2.0 * exact_near_m / texel_m)) + 8
    return k_x, -(-p_at // 8) * 8


def _hybrid(tex, at: Atlas, v: View, geo: ref.Geom, near, *, k_x: int,
            p_at: int, cells_per_deg: int, exact_near_m: float):
    """tex with the near band's and the first k_x crossings' colours
    within exact_near_m replaced by the atlas's own bilinear texels,
    through the p_at-px atlas patch centred on the viewer's texel."""
    mm = torch.arange(k_x, dtype=torch.float32, device=tex.device)[None, :]
    d = (mm + geo.e[:, None]) * geo.scale[:, None]
    iq, jq = _grid_pos(v, geo, d)
    d, iq, jq = (torch.cat(pair, dim=-1) for pair in zip(near, (d, iq, jq)))
    # the viewer's own atlas position rides along as one more element
    px, py = atlas_px(torch.cat([iq.reshape(-1), v.vi.reshape(-1)]),
                      torch.cat([jq.reshape(-1), v.vj.reshape(-1)]), at,
                      cells_per_deg)
    pxv, pyv = px[-1], py[-1]
    px, py = px[:-1].view_as(iq), py[:-1].view_as(jq)
    h, w = at.packed.shape
    if min(h, w) < p_at:
        raise ValueError(f"atlas {(h, w)} below the {p_at}-px patch")
    ox = torch.clamp(torch.round(pxv).to(torch.int32) - p_at // 2, 0,
                     w - p_at)
    oy = torch.clamp(torch.round(pyv).to(torch.int32) - p_at // 2, 0,
                     h - p_at)
    x = px - 0.5 - ox.to(torch.float32)
    y = py - 0.5 - oy.to(torch.float32)
    u0, v0, rows, cls = _corners(x, y, p_at)
    c = [[unpack(at.packed[oy + r, ox + cc]) for cc in cls] for r in rows]
    exact = pack(_bilerp(c, x, y, u0, v0))
    swap = ((x >= 0.0) & (x <= p_at - 1.0) & (y >= 0.0) & (y <= p_at - 1.0)
            & (d <= exact_near_m))
    lanes = min(N_NEAR + k_x, tex.shape[-1])
    return torch.cat([torch.where(swap[:, :lanes], exact[:, :lanes],
                                  tex[:, :lanes]), tex[:, lanes:]], dim=-1)


def image(tanel, tex, dists: ref.Dists, v: View, *, width: int,
          height: int):
    """(image (H, W, 3) uint8 BGR, ranges (H, W) float32, -1 for sky):
    render.image's ranges; each pixel the colour of its first-crossing
    sample, 0.7 of it plus 0.3 of the red ramp, sky blue."""
    ktotal = tanel.shape[-1]
    _, _, ndc = ref.az_window(v.az0, v.az1)
    aspect = width / height
    yy = torch.arange(height, dtype=torch.float32, device=tanel.device)
    el_ndc = 1.0 - (2.0 * yy + 1.0) * recip(height)
    el = el_ndc / ndc[None] * recip(aspect)
    el_k = torch.atan(tanel)
    y_k = (1.0 - el_k * (ndc * (width / height))) * (height * 0.5) - 0.5
    idx, alpha, ok = ref.resolve(y_k.contiguous(), height)
    sky = idx >= ktotal
    idxc = torch.clamp(idx, max=ktotal - 1)
    tex_hw = torch.where(sky, 0, torch.gather(tex, 1, idxc.long()))
    d_hit = dists.d_of(idxc)
    okr = ok & (idxc > 0) & ~sky
    d_prev = dists.d_of(torch.clamp(idxc - 1, min=0))
    d_hit = torch.where(okr, d_prev + alpha * (d_hit - d_prev), d_hit)
    d_hit = torch.clamp(d_hit, v.znear, v.zfar)
    ranges = d_hit / torch.cos(el)[None, :]
    ranges = torch.where(sky, const(-1.0, ranges), ranges)
    red = torch.clamp((d_hit - v.znear_color)
                      / (v.zfar_color - v.znear_color), 0.0, 1.0)
    mixed = 0.7 * unpack(tex_hw).movedim(0, -1)
    mixed[..., 2] += 0.3 * red * 255.0
    img = torch.round(torch.clamp(mixed, 0.0, 255.0)).to(torch.uint8)
    img[..., 0].masked_fill_(sky, 255)
    img[..., 1:].masked_fill_(sky[..., None], 0)
    return img.transpose(0, 1).contiguous(), ranges.t().contiguous()


def render(dem, at: Atlas, plane, v: View, *, width, height, k_cross,
           cells_per_deg, lat_hint_deg, znear_hint_m, exact_near_m,
           dtype=torch.float32):
    """One textured panorama: (image, ranges) on dem's device. ``plane``:
    ``color_planes(at, n, cells_per_deg, dtype)``."""
    n = dem.shape[0]
    az = ref.column_az(v, width)
    tanel, dists, geo = ref.march(
        dem, v, az, k_cross=k_cross, cells_per_deg=cells_per_deg,
        lat_hint_deg=lat_hint_deg, znear_hint_m=znear_hint_m, dtype=dtype)
    far = _far_colors(plane, v, geo, tanel.shape[-1] - N_NEAR, n)
    near = _near_samples(v, geo, dists.near_hi)
    patch_n = ref.near_patch_size(znear_hint_m, cells_per_deg, lat_hint_deg)
    tex = torch.cat([_near_colors(plane, v, *near[1:], patch_n, n), far],
                    dim=-1)
    k_x, p_at = exact_near_sizes(exact_near_m, cells_per_deg, lat_hint_deg,
                                 at.zoom)
    if p_at > EXACT_PATCH_CAP or k_x > TILE_K:
        raise ValueError(f"hybrid near field of {p_at} px over {k_x} "
                         f"crossings outside this reference")
    tex = _hybrid(tex, at, v, geo, near, k_x=k_x, p_at=p_at,
                  cells_per_deg=cells_per_deg, exact_near_m=exact_near_m)
    return image(tanel, tex, dists, v, width=width, height=height)
