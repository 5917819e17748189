"""Column ray-march panorama renderer on torch tensors.

Counterpart of horizonator_tpu.render.raymarch for the window sampler. In
an equirectangular panorama every image column is one azimuth, so
visibility is a 1D horizon scan per column: march the ray, and fill pixel
row y with the FIRST sample whose running-max elevation reaches row y.
The output is the reference's contract (horizonator.h:155-169): an
(H, W, 3) uint8 BGR image, top row first, shaded by the distance-red ramp
(vertex.glsl:159-162), and an (H, W) float32 slant-range image with -1 for
sky. Textured renders blend each pixel's color into the ramp as the
reference's fragment shader does, 0.7 * texture + 0.3 * shading
(fragment.glsl:21).

One code path renders one viewpoint or a batch. RenderParams fields are
0-d (one viewpoint) or (B,) (a batch); every array of the render carries
the same leading shape, (W,) per column or (B, W), and a batch returns
(B, H, W, 3) images and (B, H, W) ranges. ``cols`` and ``samples`` lift
a per-viewpoint value against per-column and per-sample arrays.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import geometry, profiling
from ..geometry import const, recip
from ..kernels.window_march import fma32

DEG = math.pi / 180.0
NEG_BIG = -3.0e38     # an invalid sample's tangent
_ROWQ = 256.0         # pixel-row quantization of the resolve keys (1/256 px)
_ROWQ_BITS = 8        # log2(_ROWQ)


class RenderParams(NamedTuple):
    """Per-render scene/camera state: float32 tensors on the render device
    (horizonator.h:23-35), 0-d for one viewpoint or (B,) for a batch."""
    viewer_cell_i: torch.Tensor   # fractional grid coords of the viewer
    viewer_cell_j: torch.Tensor
    viewer_z: torch.Tensor        # viewer elevation, meters
    cos_viewer_lat: torch.Tensor
    az_rad0: torch.Tensor         # azimuth of the LEFT viewport edge
    az_rad1: torch.Tensor         # azimuth of the RIGHT viewport edge
    znear: torch.Tensor           # clip distances, meters
    zfar: torch.Tensor
    znear_color: torch.Tensor     # shading ramp extents, meters
    zfar_color: torch.Tensor
    curv: torch.Tensor            # earth curvature 1/(2 R_eff), 0 = flat


def cols(x: torch.Tensor) -> torch.Tensor:
    """A per-viewpoint value (0-d or (B,)) against per-column arrays."""
    return x[..., None]


def samples(x: torch.Tensor) -> torch.Tensor:
    """A per-viewpoint value against per-sample (per-pixel) arrays, (W, K)
    or (B, W, K)."""
    return x[..., None, None]


def _params_on(values, device) -> RenderParams:
    """One host-to-device copy of all fields, each rounded to float32 once
    and broadcast to their common shape, then views of it."""
    host = np.stack(np.broadcast_arrays(*[np.asarray(v, dtype=np.float32)
                                          for v in values]))
    with profiling.sync():
        fields = torch.from_numpy(host).to(device)
    return RenderParams(*fields.unbind())


def make_params(*, device, curv=0.0, **fields) -> RenderParams:
    """RenderParams from Python numbers, each rounded to float32 once (as
    ``jnp.float32(x)`` does); sequences of numbers make a batch."""
    fields["curv"] = curv
    with profiling.phase("hz.render.make_params"):
        return _params_on([fields[k] for k in RenderParams._fields], device)


def params_from_jax(p, device) -> RenderParams:
    """The port's RenderParams from the JAX package's: every field taken as
    numpy float32 (``np.asarray`` of a JAX array works) and moved to
    ``device``; a stacked JAX batch gives (B,) fields, its 0-d leaves
    broadcast."""
    return _params_on([np.asarray(getattr(p, k), dtype=np.float32)
                       for k in RenderParams._fields], device)


def stack_params(params_list) -> RenderParams:
    """Stack RenderParams of one viewpoint each into a batch (leading axis
    B)."""
    return RenderParams(*(torch.stack(xs) for xs in zip(*params_list)))


def broadcast_params_batch(params: RenderParams) -> RenderParams:
    """Broadcast 0-d fields to the batch shape of ``viewer_cell_i``, each
    keeping its dtype: a hand-built batch commonly leaves defaulted fields
    (e.g. ``curv``) 0-d."""
    b = params.viewer_cell_i.shape
    return RenderParams(*(x.expand(b) if x.dim() == 0 and len(b) else x
                          for x in params))


def pack_dem_pairs(dem: torch.Tensor) -> torch.Tensor:
    """Horizontally adjacent elevation pairs (z[j, i], z[j, i+1]) as one
    (N, N-1) int32 plane, each elevation quantized to 0.5 m (rounded half
    to even) in 16 bits (raymarch.py:69-81). Exact for integer-metre SRTM
    data."""
    zq = torch.clamp(torch.round(dem.to(torch.float32) * 2.0), -32768,
                     32767).to(torch.int32)
    return (zq[:, :-1] << 16) | (zq[:, 1:] & 0xffff)


def _unpack_pair(v: torch.Tensor):
    hi = (v >> 16).to(torch.float32) * 0.5
    lo = v & 0xffff
    lo = torch.where(lo >= 32768, lo - 65536, lo).to(torch.float32) * 0.5
    return hi, lo


def _as_packed(dem: torch.Tensor):
    """(packed plane, N) of an (N, N) elevation grid, or of an (N, N-1)
    int32 plane that pack_dem_pairs already made (raymarch.py:756)."""
    if dem.dtype == torch.int32:
        return dem, dem.shape[0]
    return pack_dem_pairs(dem), dem.shape[0]


def _sample_surface(dem_packed: torch.Tensor, n: int, i_pos: torch.Tensor,
                    j_pos: torch.Tensor, surface: str,
                    fused: bool = False) -> torch.Tensor:
    """The terrain at fractional grid coords from a pack_dem_pairs plane
    (row 0 = south): two pair lookups give the four corners of the
    bilinear or the reference's triangulated surface (raymarch.py:91-117).
    Indices are clipped into the grid; masking out-of-grid positions is the
    caller's. ``fused``: each lerp a + (b - a) * f one multiply-add, as XLA
    contracts it inside the uniform-step march."""
    i0 = torch.clamp(torch.floor(i_pos), 0, n - 2).to(torch.int32)
    j0 = torch.clamp(torch.floor(j_pos), 0, n - 2).to(torch.int32)
    fi = torch.clamp(i_pos - i0, 0.0, 1.0)
    fj = torch.clamp(j_pos - j0, 0.0, 1.0)
    flat = dem_packed.reshape(-1)
    base = (j0 * (n - 1) + i0).long()
    z00, z10 = _unpack_pair(flat[base])
    z01, z11 = _unpack_pair(flat[base + (n - 1)])

    def lerp(a, b, f):
        return fma32(b, f, a) if fused else a + b * f
    if surface == "bilinear":
        top = lerp(z00, z10 - z00, fi)
        bot = lerp(z01, z11 - z01, fi)
        return lerp(top, bot - top, fj)
    if surface == "triangulated":
        # two triangles a cell, split along the (i, j) -> (i+1, j+1)
        # diagonal (horizonator-lib.c:496-507)
        z_lower = lerp(lerp(z00, z10 - z00, fi), z11 - z10, fj)
        z_upper = lerp(lerp(z00, z11 - z01, fi), z01 - z00, fj)
        return torch.where(fj <= fi, z_lower, z_upper)
    raise ValueError(f"unknown surface mode {surface!r}")


def column_az(params: RenderParams, width: int) -> torch.Tensor:
    """(W,) pixel-centre azimuths of the image columns ((B, W) in a
    batch)."""
    _, az_center, az_ndc_per_rad = geometry.az_window_rad(params.az_rad0,
                                                          params.az_rad1)
    x = torch.arange(width, dtype=torch.float32, device=az_center.device)
    az_ndc = (x + 0.5) * recip(width) * 2.0 - 1.0
    return cols(az_center) + az_ndc / cols(az_ndc_per_rad)


def march_tanel(dem: torch.Tensor, params: RenderParams, *, width: int,
                nsteps: int, cells_per_deg: int, surface: str = "bilinear"):
    """The uniform-step march (raymarch.py:764-800): ``nsteps`` samples a
    column at d = znear + (k + 0.5) * (zfar - znear) / nsteps, each the
    bilinear or the reference's triangulated surface at its grid
    position. ``dem``: an (n, n) float32 grid or its pack_dem_pairs plane.

    Returns (tanel (W, K), run_max (W, K), d (K,), az (W,)); (B,) params
    give (B, W, K), (B, K) and (B, W)."""
    p = broadcast_params_batch(params)
    dem_packed, n = _as_packed(dem)
    az = column_az(p, width)
    k = torch.arange(nsteps, dtype=torch.float32, device=az.device)
    d = step_d_of(p, nsteps, lift=cols)(k.expand(p.znear.shape + (nsteps,)))
    cell_m_north = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    cell_m_east = cell_m_north * p.cos_viewer_lat
    # XLA contracts the distances, the row position, the lerps and the
    # curvature term into multiply-adds: so does the port (bitwise given
    # equal sin/cos)
    dk = d[..., None, :]
    i_pos = (samples(p.viewer_cell_i)
             + dk * torch.sin(az)[..., None] / samples(cell_m_east))
    dcos = dk * torch.cos(az)[..., None]
    j_pos = fma32(dcos, const(recip(cell_m_north), dcos).expand_as(dcos),
                  samples(p.viewer_cell_j).expand_as(dcos))
    in_grid = (i_pos >= 0) & (i_pos <= n - 1) & (j_pos >= 0) & (j_pos <= n - 1)
    z = _sample_surface(dem_packed, n, i_pos, j_pos, surface, fused=True)
    q = (z - samples(p.viewer_z)) / dk
    tanel = torch.where(in_grid, fma32(-dk.expand_as(q),
                                       samples(p.curv).expand_as(q), q),
                        const(NEG_BIG, z))
    return tanel, torch.cummax(tanel, dim=-1).values, d, az


def horizon_profile(dem: torch.Tensor, params: RenderParams, *, width: int,
                    nsteps: int, cells_per_deg: int,
                    surface: str = "bilinear"):
    """Per-column horizon (az (W,), tan_el (W,)) of the uniform-step march
    (raymarch.py:1066-1074); (B, W) each in a batch."""
    tanel, _, _, az = march_tanel(dem, params, width=width, nsteps=nsteps,
                                  cells_per_deg=cells_per_deg,
                                  surface=surface)
    return az, tanel.amax(dim=-1)


def render_panorama(dem: torch.Tensor, params: RenderParams, *, width: int,
                    height: int, nsteps: int, cells_per_deg: int,
                    surface: str = "bilinear", refine: bool = True,
                    textured: bool = False, atlas=None, atlas_params=None,
                    sampler: str = "window", lat_hint_deg: float = 45.0,
                    color_planes=None, znear_hint_m=100.0,
                    with_dropped: bool = False, exact_near_m=None,
                    lod_plan=None, plain: bool = False):
    """Render one panorama on the device of its scene.

    ``sampler`` picks the march and what ``dem`` holds:

    - "window" (the crossing march through the window-march kernel): a
      square (n, n) float32 DEM tensor (dem[j, i], row 0 = SOUTH edge);
      ``nsteps`` is the crossing budget (crossing.k_cross_for);
    - "crossing" (the grid-crossing oracle, crossing.march_crossing): a
      crossing.CrossingScene, or a float32 grid packed here;
    - "step" (the uniform-step oracle, march_tanel): a float32 grid or
      its pack_dem_pairs plane; ``nsteps`` uniform steps over [znear,
      zfar], sampling ``surface`` ("bilinear" or the reference's
      "triangulated" mesh surface);
    - "lod" marches the bands of ``lod_plan`` (lod.lod_plan) on a mip
      chain: ``dem`` is lod.build_pyramid's tuple or a grid (pooled here),
      ``color_planes`` lod.build_color_pyramid's tuple or planes (pooled
      here); ``nsteps`` and ``exact_near_m`` are not read.

    Crossings sample grid lines, where the bilinear and triangulated
    surfaces agree, so ``surface`` matters to the step sampler alone.
    ``textured``: blend colors into the image; with the window and LOD
    samplers they come from ``color_planes`` in the march (see
    window.march_from_geometry; ``atlas``, ``atlas_params`` and
    ``exact_near_m`` add the hybrid near field), otherwise (no planes, or
    an oracle sampler) from a per-pixel gather of the packed ``atlas``.
    Every sampler ends in the resolve kernel; ``plain`` runs the kernels'
    plain PyTorch versions on any device.

    Returns (image (H, W, 3) uint8 BGR, ranges (H, W) float32), plus the
    (2,) int32 guard [dropped, truncated] under ``with_dropped`` (zeros
    for the oracle samplers, which mask nothing). With (B,) params fields
    the batch renders in one pass, each kernel launched once for it: (B,
    H, W, 3), (B, H, W) and a (B, 2) guard, each viewpoint bitwise its
    own render's (parallel.sharding runs large batches in chunks)."""
    if sampler not in ("window", "lod", "crossing", "step"):
        raise ValueError(f"unknown sampler {sampler!r}")
    if surface not in ("bilinear", "triangulated"):
        raise ValueError(f"unknown surface mode {surface!r}")
    params = broadcast_params_batch(params)
    tex_samples = None
    if sampler == "lod":
        from . import lod
        from .texture import ColorPlanes2x
        pyramid = (tuple(dem) if isinstance(dem, (tuple, list)) else
                   lod.build_pyramid(dem, 1 + max(s.level for s in lod_plan)))
        cpyr = None
        if textured and color_planes is not None:
            # a ColorPlanes2x is a (named) tuple too, but one level
            cpyr = (tuple(color_planes)
                    if isinstance(color_planes, (tuple, list))
                    and not isinstance(color_planes, ColorPlanes2x) else
                    lod.build_color_pyramid(color_planes, len(pyramid),
                                            pyramid[0].shape[0]))
        with profiling.phase("hz.render.march"):
            out = lod.march_lod(pyramid, params, width=width, plan=lod_plan,
                                cells_per_deg=cells_per_deg,
                                lat_hint_deg=lat_hint_deg,
                                znear_hint_m=znear_hint_m, color_pyramid=cpyr,
                                plain=plain)
        tanel, dists, az = out[:3]
        d_of = dists.d_of
        if cpyr is not None:
            tex_samples = out[3]
    elif sampler == "window":
        from .window import march_from_geometry
        from .crossing import crossing_geometry
        with profiling.phase("hz.render.geometry"):
            geo = crossing_geometry(params, width=width,
                                    cells_per_deg=cells_per_deg)
        az = geo.az
        mkw = dict(k_cross=nsteps, cells_per_deg=cells_per_deg,
                   lat_hint_deg=lat_hint_deg, znear_hint_m=znear_hint_m,
                   plain=plain)
        with profiling.phase("hz.render.march"):
            if textured and color_planes is not None:
                tanel, dists, tex_samples = march_from_geometry(
                    dem, params, geo, color_planes=color_planes, atlas=atlas,
                    atlas_params=atlas_params, exact_near_m=exact_near_m,
                    **mkw)
            else:
                tanel, dists = march_from_geometry(dem, params, geo, **mkw)
        d_of = dists.d_of
    elif sampler == "crossing":
        from .crossing import CrossingScene, march_crossing, pack_scene
        scene = dem if isinstance(dem, CrossingScene) else pack_scene(dem)
        tanel, _, dists, az = march_crossing(
            scene, params, width=width, k_cross=nsteps,
            cells_per_deg=cells_per_deg)
        d_of = dists.d_of
    else:
        tanel, _, _, az = march_tanel(dem, params, width=width,
                                      nsteps=nsteps,
                                      cells_per_deg=cells_per_deg,
                                      surface=surface)
        d_of = step_d_of(params, nsteps)
    with profiling.phase("hz.render.resolve"):
        out = resolve_to_image(tanel, d_of, az, params, width=width,
                               height=height, cells_per_deg=cells_per_deg,
                               refine=refine, textured=textured, atlas=atlas,
                               atlas_params=atlas_params,
                               tex_samples=tex_samples, plain=plain)
    if not with_dropped:
        return out
    if sampler in ("window", "lod"):
        guard = torch.stack([dists.dropped, dists.truncated], dim=-1)
    else:                        # the oracle samplers mask nothing
        guard = torch.zeros(params.znear.shape + (2,), dtype=torch.int32,
                            device=tanel.device)
    return out + (guard,)


def step_d_of(params: RenderParams, nsteps: int, lift=samples):
    """The uniform-step march's sample distances, znear + (idx + 0.5) *
    step as one multiply-add, for (W, X) sample indices ((B, W, X) in a
    batch); ``lift=cols`` takes (K,) ((B, K)) indices instead."""
    step = (params.zfar - params.znear) * recip(nsteps)

    def d_of(idx: torch.Tensor) -> torch.Tensor:
        x = idx.to(torch.float32) + 0.5
        return fma32(x, lift(step).expand_as(x),
                     lift(params.znear).expand_as(x))
    return d_of


def horizon_rows(tanel: torch.Tensor, params: RenderParams, *, width: int,
                 height: int) -> torch.Tensor:
    """(W, K) continuous pixel rows of the march tangents (top = 0): the
    exact inverse of the pixel-row elevation grid (raymarch.py:964-984);
    (B, W, K) in a batch."""
    _, _, az_ndc_per_rad = geometry.az_window_rad(params.az_rad0,
                                                  params.az_rad1)
    el_k = torch.atan(tanel)
    return ((1.0 - el_k * samples(az_ndc_per_rad * (width / height)))
            * (height * 0.5) - 0.5)


def resolve_to_image(tanel: torch.Tensor, d_of, az: torch.Tensor,
                     params: RenderParams, *, width: int, height: int,
                     cells_per_deg: int | None = None, refine: bool = True,
                     textured: bool = False, atlas=None, atlas_params=None,
                     tex_samples: torch.Tensor | None = None,
                     plain: bool = False):
    """The render tail (raymarch.py:944-1061): first-crossing resolve in
    pixel-row space, refined ranges, image assembly.

    Takes the RAW march tangents ``tanel`` (W, K): the resolve takes the
    running max itself (in row space, where it commutes with the monotone
    row map bit for bit), so no run_max is needed. Textured: with
    ``tex_samples`` (W, K) the resolve routes each pixel's sample color;
    without, each hit is gathered from the packed ``atlas``
    (``atlas_params``, ``cells_per_deg``). A batch's (B, W, K) tangents
    give (B, H, W, 3) and (B, H, W), one resolve launch for all B*W
    columns."""
    from .resolve_window import resolve_window
    p = params
    ktotal = tanel.shape[-1]
    with profiling.phase("hz.render.row_map"):
        y_k = horizon_rows(tanel, p, width=width, height=height)
    tex_hw = None
    with profiling.phase("hz.kernels.resolve"):
        if tex_samples is not None:
            idx, alpha, ok, tex_hw = resolve_window(
                y_k, height, tex=tex_samples, plain=plain)       # (W, H)
        else:
            idx, alpha, ok = resolve_window(y_k, height, plain=plain)
    with profiling.phase("hz.render.tail"):
        return _tail(idx, alpha, ok, tex_hw, ktotal, d_of, az, p,
                     width=width, height=height, cells_per_deg=cells_per_deg,
                     refine=refine, textured=textured, atlas=atlas,
                     atlas_params=atlas_params)


def _tail(idx, alpha, ok, tex_hw, ktotal: int, d_of, az, p: RenderParams, *,
          width: int, height: int, cells_per_deg, refine: bool,
          textured: bool, atlas, atlas_params):
    """resolve_to_image after the resolve: refined distances, ranges and
    the image."""
    _, _, az_ndc_per_rad = geometry.az_window_rad(p.az_rad0, p.az_rad1)
    aspect = width / height
    y = torch.arange(height, dtype=torch.float32, device=idx.device)
    el_ndc = 1.0 - (2.0 * y + 1.0) * recip(height)
    el = el_ndc / cols(az_ndc_per_rad) * recip(aspect)           # (H,)
    sky = idx >= ktotal
    idxc = torch.clamp(idx, max=ktotal - 1)

    d_hit = d_of(idxc)
    if refine:
        okr = ok & (idxc > 0) & ~sky
        d_prev = d_of(torch.clamp(idxc - 1, min=0))
        d_hit = torch.where(okr, d_prev + alpha * (d_hit - d_prev), d_hit)
    d_hit = torch.clamp(d_hit, samples(p.znear), samples(p.zfar))

    ranges_wh = d_hit / torch.cos(el)[..., None, :]
    ranges_wh = torch.where(sky, const(-1.0, ranges_wh), ranges_wh)

    red = torch.clamp((d_hit - samples(p.znear_color))
                      / samples(p.zfar_color - p.znear_color), 0.0, 1.0)
    if not textured:
        r8 = torch.round(red * 255.0).to(torch.uint8)
        zero = torch.zeros_like(r8)
        b = sky.to(torch.uint8) * 255
        r = torch.where(sky, zero, r8)
        image = torch.stack([b, zero, r], dim=-1)                # (W, H, 3)
    else:
        from .texture import _unpack_bgr, sample_atlas_bgr
        if tex_hw is not None:
            tex_bgr = _unpack_bgr(tex_hw)
        else:
            # per-pixel atlas gather at each hit's grid position
            # (raymarch.py:1039-1050, texture_quality="exact")
            cell_m_north = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
            cell_m_east = cell_m_north * p.cos_viewer_lat
            i_hit = (samples(p.viewer_cell_i) + d_hit
                     * torch.sin(az)[..., None] / samples(cell_m_east))
            j_hit = (samples(p.viewer_cell_j) + d_hit
                     * torch.cos(az)[..., None] * recip(cell_m_north))
            tex_bgr = sample_atlas_bgr(atlas, atlas_params, i_hit, j_hit,
                                       cells_per_deg)
        # fragment.glsl:21: 0.7 * texture + 0.3 * shading; shading is the
        # red ramp (B = G = 0)
        mixed = 0.7 * tex_bgr
        mixed[..., 2] += 0.3 * red * 255.0
        image = torch.round(torch.clamp(mixed, 0.0, 255.0)).to(torch.uint8)
        image[..., 0].masked_fill_(sky, 255)                     # sky: BGR
        image[..., 1:].masked_fill_(sky[..., None], 0)           # blue
    return (image.transpose(-3, -2).contiguous(),
            ranges_wh.transpose(-2, -1).contiguous())
