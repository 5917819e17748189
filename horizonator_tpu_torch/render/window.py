"""The window march: every image column's samples along its ray.

Counterpart of horizonator_tpu.render.window.march_window, untextured or
textured, on a square grid or a rectangular row band (``j_hi``,
``j_offset``: region sharding). The output is the JAX package's
``scene=None`` lane layout, (W, N_NEAR + k_limit):

- lanes [0, N_NEAR): the near band, N_NEAR bilinear samples over
  [znear, first surviving crossing), read through the viewer-centered DEM
  patch at 0.5 m elevation resolution (window.py:1024-1095), from
  kernels/near_band.py;
- lanes N_NEAR + m: grid crossing m, from the window-march kernel
  (kernels/window_march.py), which reads its two taps straight from the
  DEM: the TPU's crossing tables, aligned windows and per-tile origins
  exist for its DMA engine and have no counterpart here.

Both write their lanes of one field: on a card the two kernels in
place, on the CPU and under ``plain=True`` the plain versions' results
copied in.

The guards keep their contract: ``dists.truncated`` counts columns whose
valid crossings run past the step budget, ``dists.dropped`` near-band
samples outside the static patch. A CUDA kernel reads the DEM directly,
so the TPU's window-overflow class of ``dropped`` cannot occur.

Textured marches (``color_planes``) return a fifth value, tex (W, N_NEAR +
k_limit) int32 packed 0x00RRGGBB per sample: the far field from the
kernel's textured entry, the near band bilinear at the planes' own
resolution, and, with an atlas and ``exact_near_m`` (the API's "hybrid"
quality), atlas-true z12 colors for the samples nearer than exact_near_m.

Bands: a rectangular (nj, ni) grid whose row 0 is global row ``j_offset``
(default 0), its rows valid up to global j_offset + ``j_hi`` (default nj -
1). The geometry stays global, so every sample is bitwise the whole grid's
march; the row coordinate shifts only where it indexes the band and its
color planes (cell (3, nj, ni), packed (nj, ni), or a band-local half-cell
ColorPlanes2x of (2 nj, 2 ni)), which are checked on both dims. The far
field takes the kernel's banded entries; a square grid with neither
argument keeps the square entries.

Batch: with (B,) RenderParams fields every array gains a leading B, (B, W)
per column and (B, W, N_NEAR + k_limit) per sample, the guards come back
per viewpoint as (B,) counts, and the kernel marches the whole batch in
one launch. The DEM is one (n, n) grid that every viewpoint marches, or
one (B, n, n) grid per viewpoint (the LOD levels' crops), and color planes
likewise: packed (B, s*n, s*n) int32, a ColorPlanes2x of (B, 2n, 2n), or
(3, B, n, n) float planes. The near patches and the hybrid near field's
atlas patch take each viewpoint's own origin.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import torch

from .. import geometry, profiling
from ..geometry import const
from ..kernels.near_band import (ALIGN_MIN_N, _bilerp, _corners, _grid_pos,
                                 _patch_origin, _take, near_band, near_top)
from ..kernels.window_march import (march, march_band, march_band_textured,
                                    march_plain, march_textured)
from .crossing import CrossingDists, CrossingGeom, N_NEAR, crossing_geometry
from .raymarch import RenderParams, cols, samples
from .texture import (AtlasParams, ColorPlanes2x, atlas_px_from_grid,
                      pack_cell_colors, unpack_color_planes)

DEG = math.pi / 180.0
TILE_K = 128           # the JAX kernel's step tile: k budgets round to it
NEAR_PATCH_CAP = 64
EXACT_PATCH_CAP = 256  # atlas-patch edge cap for the hybrid near field


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


class Band(NamedTuple):
    """A march grid's rows in global coordinates: row 0 is global row
    ``offset``; rows are valid in [offset, offset + j_hi] (float32 values,
    ``j_hi`` possibly below 0: no valid row)."""
    offset: int
    j_hi: float
    ni: int

    def bounds(self, geo: CrossingGeom):
        """(axis_lo, axis_hi, cross_lo, cross_hi) per column, global
        (window.py:822-834): the row coordinate is the axis of row-dominant
        columns and the cross position of the others."""
        jlo = const(float(self.offset), geo.a)
        jhi = jlo + const(self.j_hi, geo.a)
        zero, hi = const(0.0, geo.a), const(self.ni - 1.0, geo.a)
        jd = geo.j_dom
        return (torch.where(jd, jlo, zero), torch.where(jd, jhi, hi),
                torch.where(jd, zero, jlo), torch.where(jd, hi, jhi))


def _truncated(geo: CrossingGeom, p: RenderParams, band: Band,
               k_limit: int) -> torch.Tensor:
    """Columns whose valid crossing interval [m_lo, m_hi] reaches past the
    step budget (window.py:850-877), against the band's bounds (on a square
    grid all of them [0, n-1])."""
    axis_lo, axis_hi, cross_lo, cross_hi = band.bounds(geo)
    ax0f = geo.axis0.to(torch.float32)
    sgnf = geo.sign.to(torch.float32)
    big = const(3e38, geo.a)
    abs_t = torch.maximum(geo.t.abs(), const(1e-30, geo.a))
    ax_hi_m = torch.where(sgnf > 0, axis_hi - ax0f, ax0f - axis_lo)
    ax_lo_m = torch.where(sgnf > 0, axis_lo - ax0f, ax0f - axis_hi)
    pos_hi_m = torch.where(
        geo.t == 0.0, big,
        torch.where(geo.t > 0, cross_hi - geo.a, geo.a - cross_lo) / abs_t)
    pos_lo_m = torch.where(
        geo.t == 0.0, -big,
        torch.where(geo.t > 0, cross_lo - geo.a, geo.a - cross_hi) / abs_t)
    m_hi = torch.minimum(torch.minimum(ax_hi_m, pos_hi_m),
                         cols(p.zfar) / geo.scale - geo.e)
    m_lo = torch.maximum(torch.maximum(ax_lo_m, pos_lo_m),
                         torch.clamp(cols(p.znear) / geo.scale - geo.e,
                                     min=0.0))
    reach = torch.maximum(torch.ceil(m_lo), const(float(k_limit), geo.a))
    return (torch.floor(m_hi) >= reach).sum(dim=-1).to(torch.int32)


def _pack_u8(bgr: torch.Tensor) -> torch.Tensor:
    """(3, ...) float B, G, R -> 0x00RRGGBB, each rounded (half to even)
    and clipped to u8."""
    c = torch.clamp(torch.round(bgr), 0.0, 255.0).to(torch.int32)
    return (c[2] << 16) | (c[1] << 8) | c[0]


def _bgr_of(src: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(3, ...) float32 B, G, R of values gathered from a color source: the
    bytes of a packed int32 plane, or (3, ...) float planes as they are
    (the JAX near band contracts float planes unrounded)."""
    return unpack_color_planes(v) if src.dtype == torch.int32 else v


def _gather(src: torch.Tensor, rows, columns, per_view: bool = False):
    """Values of a packed plane, or (3, ...) B/G/R of float planes, at
    (rows, columns); ``per_view``: src holds one plane per viewpoint."""
    if src.dtype == torch.int32:
        return _take(src, rows, columns, per_view)
    return torch.stack([_take(c, rows, columns, per_view) for c in src])


def _near_colors(src: torch.Tensor, s: int, iq, jq, *, ni_real: int,
                 nj_real: int, patch_n: int | None, origin=None,
                 per_view: bool = False) -> torch.Tensor:
    """(W, n_near) packed near-band colors at the planes' own resolution s
    (window.py:1115-1201). ``src``: the zero-padded packed (s*nj, s*ni)
    plane, or (3, nj, ni) float planes at s = 1; with ``per_view`` one per
    viewpoint, (B, s*nj, s*ni) or (3, B, nj, ni). ``jq``: band-local rows;
    ``origin``: the elevation patch's corner."""
    if patch_n is not None:
        # the same viewer patch as the elevation, s times finer
        oi, oj = (samples(o) for o in origin)
        irc = iq * s - (s * oi).to(torch.float32)
        jrc = jq * s - (s * oj).to(torch.float32)
        u0, v0, rows, columns = _corners(irc, jrc, s * patch_n)
        c = [[_bgr_of(src, _gather(src, s * oj + r, s * oi + cc, per_view))
              for cc in columns] for r in rows]
        return _pack_u8(_bilerp(c, irc, jrc, u0, v0))
    # gather form: bilinear from four corners, clamped to the real planes
    iqs, jqs = iq * s, jq * s
    i0 = torch.clamp(torch.floor(iqs), 0, s * ni_real - 2).to(torch.int32)
    j0 = torch.clamp(torch.floor(jqs), 0, s * nj_real - 2).to(torch.int32)
    fi = torch.clamp(iqs - i0, 0.0, 1.0)
    fj = torch.clamp(jqs - j0, 0.0, 1.0)
    i0, j0 = i0.long(), j0.long()
    g00, g01, g10, g11 = (_bgr_of(src, _gather(src, j, i, per_view))
                          for j, i in (
        (j0, i0), (j0, i0 + 1), (j0 + 1, i0), (j0 + 1, i0 + 1)))
    top = g00 + (g01 - g00) * fi
    bot = g10 + (g11 - g10) * fi
    return _pack_u8(top + (bot - top) * fj)


def exact_near_sizes(exact_near_m: float, cells_per_deg: int,
                     lat_hint_deg: float, zoom: int):
    """Static (k_x, patch_px) of the hybrid near field: the crossing steps
    reaching ``exact_near_m`` and the atlas-patch edge covering them, worst
    case over the latitude bucket (window.py:353-365)."""
    cos_l = max(0.05, math.cos(math.radians(min(abs(lat_hint_deg) + 5.0,
                                                85.0))))
    cell_e_min = geometry.EARTH_RADIUS_M * DEG / cells_per_deg * cos_l
    k_x = int(math.ceil(exact_near_m / cell_e_min)) + 2
    texel_m = 40075016.686 / (256.0 * (1 << zoom)) * cos_l
    p_at = int(math.ceil(2.0 * exact_near_m / texel_m)) + 8
    return k_x, -(-p_at // 8) * 8


def _exact_near_colors(atlas: torch.Tensor, ap: AtlasParams,
                       geo: CrossingGeom, p: RenderParams, near, *,
                       k_x: int, p_at: int, cells_per_deg: int,
                       exact_near_m: float):
    """Hybrid near field (window.py:368-435): packed colors bilinearly
    sampled from the z12 atlas itself for the near band (``near``: its
    (dq, iq, jq), or None) and the first ``k_x`` crossing steps, through
    one viewer-centered atlas patch. Returns (packed (W, n_near + k_x)
    int32, replace mask): samples outside the patch or beyond exact_near_m
    keep their plane colors."""
    mm = torch.arange(k_x, dtype=torch.float32, device=atlas.device)[None, :]
    d = (mm + geo.e[..., None]) * geo.scale[..., None]
    iq, jq = _grid_pos(p, geo, d)
    if near is not None:
        d, iq, jq = (torch.cat(pair, dim=-1)
                     for pair in zip(near, (d, iq, jq)))
    # the viewers' own atlas positions ride along as nv more elements
    nv = p.viewer_cell_i.numel()
    px, py = atlas_px_from_grid(
        torch.cat([iq.reshape(-1), p.viewer_cell_i.reshape(-1)]),
        torch.cat([jq.reshape(-1), p.viewer_cell_j.reshape(-1)]), ap,
        cells_per_deg)
    pxv, pyv = (v[-nv:].view_as(p.viewer_cell_i) for v in (px, py))
    px, py = px[:-nv].view_as(iq), py[:-nv].view_as(jq)
    h_at, w_at = atlas.shape
    if min(h_at, w_at) < p_at:
        raise ValueError(f"atlas {tuple(atlas.shape)} is smaller than the "
                         f"hybrid near field's {p_at}-px patch")
    ox = torch.clamp(torch.round(pxv).to(torch.int32) - p_at // 2,
                     0, w_at - p_at)
    oy = torch.clamp(torch.round(pyv).to(torch.int32) - p_at // 2,
                     0, h_at - p_at)
    ox, oy = samples(ox), samples(oy)
    xr = px - 0.5 - ox.to(torch.float32)
    yr = py - 0.5 - oy.to(torch.float32)
    u0, v0, rows, columns = _corners(xr, yr, p_at)
    c = [[unpack_color_planes(atlas[oy + r, ox + cc]) for cc in columns]
         for r in rows]
    packed = _pack_u8(_bilerp(c, xr, yr, u0, v0))
    replace = ((xr >= 0.0) & (xr <= p_at - 1.0) & (yr >= 0.0)
               & (yr <= p_at - 1.0) & (d <= exact_near_m))
    return packed, replace


def _color_source(color_planes, nj: int, ni: int, batch: tuple = ()):
    """(far plane, scale, near source) of a march's color planes: the
    packed (s*nj, s*ni) int32 plane the kernel reads, s, and what the near
    band samples (the JAX package contracts (3, nj, ni) float planes
    unpacked there). Checks the whole shape of every form (window.py:
    680-736 checks a band's packed and float planes on their rows alone).
    ``batch``: (B,) when the planes hold one grid per viewpoint, packed
    (B, s*nj, s*ni) or (3, B, nj, ni) float."""
    lead = tuple(batch)
    grid = f"({nj}, {ni}) grid"
    if isinstance(color_planes, ColorPlanes2x):
        fp = color_planes.full_packed
        if (tuple(fp.shape) != lead + (2 * nj, 2 * ni)
                or fp.dtype != torch.int32):
            raise ValueError(f"ColorPlanes2x plane {fp.dtype} "
                             f"{tuple(fp.shape)} does not match the {grid}")
        return fp.contiguous(), 2, fp
    if color_planes.dim() == 2 + len(lead) and (
            color_planes.dtype == torch.int32 or not lead):
        if color_planes.dtype != torch.int32:
            raise ValueError(
                f"2D color_planes must be packed int32 0x00RRGGBB "
                f"(texture.pack_cell_colors), got {color_planes.dtype}")
        if tuple(color_planes.shape) != lead + (nj, ni):
            raise ValueError(f"packed color plane shape "
                             f"{tuple(color_planes.shape)} does not match "
                             f"the {grid}")
        return color_planes.contiguous(), 1, color_planes
    s = color_planes.shape[-2] // nj
    if (color_planes.dim() != 3 + len(lead) or color_planes.shape[0] != 3
            or s not in (1, 2) or tuple(color_planes.shape[1:])
            != lead + (s * nj, s * ni)):
        raise ValueError(f"color_planes shape {tuple(color_planes.shape)} "
                         f"is neither (3, nj, ni) nor (3, 2nj, 2ni) for the "
                         f"{grid}")
    packed = pack_cell_colors(color_planes)
    return packed, s, (packed if s == 2 else color_planes.to(torch.float32))


def _check_supported(dem, scene):
    if dem.dim() != 2:
        raise ValueError(f"march_window takes one (nj, ni) grid, got "
                         f"{tuple(dem.shape)}")
    if scene is not None:
        raise NotImplementedError("march_window: scene= (the TPU's aligned "
                                  "crossing tables) is not ported")


def march_from_geometry(dem: torch.Tensor, params: RenderParams,
                        geo: CrossingGeom, *, k_cross: int,
                        cells_per_deg: int, lat_hint_deg: float = 45.0,
                        n_near: int = N_NEAR, znear_hint_m=100.0,
                        color_planes=None, atlas=None, atlas_params=None,
                        exact_near_m=None, j_hi=None, j_offset=None,
                        plain: bool = False):
    """(tanel (W, n_near + k_limit), dists) for given crossing geometry,
    plus tex (W, n_near + k_limit) int32 when ``color_planes`` is given:
    a ColorPlanes2x (half-cell), (nj, ni) packed int32 cell planes, or
    (3, nj, ni) / (3, 2nj, 2ni) float B/G/R planes. ``atlas`` (packed
    int32), ``atlas_params`` and ``exact_near_m`` add the hybrid near
    field. ``j_hi`` / ``j_offset``: a row band (the module docstring).

    ``plain`` runs the march's and the near band's plain PyTorch versions
    on any device (for comparisons with the kernels); otherwise the
    wrappers pick by device. Either way the two write their lanes of one
    field.

    Batched (B,) params give (B, W, ...) arrays, one kernel launch for the
    batch, and (B,) guards; ``dem`` is then a shared (nj, ni) grid or one
    (B, nj, ni) grid per viewpoint (color planes alike, see the module
    docstring)."""
    p = params
    nj, ni = dem.shape[-2:]
    per_view = dem.dim() == 3
    dem = dem.to(torch.float32).contiguous()
    banded = j_hi is not None or j_offset is not None or nj != ni
    band = Band(offset=int(j_offset or 0),
                j_hi=float(nj - 1 if j_hi is None else j_hi), ni=ni)
    k_limit = step_budget(k_cross, max(nj, ni))

    pcol = torch.stack([
        geo.a, geo.t, geo.e, geo.scale,
        geo.axis0.to(torch.float32), geo.sign.to(torch.float32),
        geo.j_dom.to(torch.float32), torch.zeros_like(geo.a)],
        dim=-1).contiguous()
    fscal = torch.stack([p.viewer_z, p.znear, p.zfar, p.curv], dim=-1).to(
        torch.float32)
    textured = color_planes is not None
    bkw = dict(j_offset=band.offset, j_hi=band.j_hi)
    if textured:
        plane, s, near_src = _color_source(color_planes, nj, ni,
                                           dem.shape[:1] if per_view else ())
    # one field: the march writes lanes [n_near, n_near + k_limit), the
    # near band lanes [0, n_near) (on a card both kernels in place)
    shape = tuple(geo.a.shape) + (n_near + k_limit,)
    tanel = torch.empty(shape, dtype=torch.float32, device=dem.device)
    okw = dict(out=tanel[..., n_near:])
    tex = None
    if textured:
        tex = torch.empty(shape, dtype=torch.int32, device=dem.device)
        okw["tex_out"] = tex[..., n_near:]
    with profiling.phase("hz.kernels.march"):
        if plain:
            far = march_plain(dem, pcol, fscal, k_limit,
                              *((plane, s) if textured else ()), **bkw)
            tanel[..., n_near:] = far[0] if textured else far
            if textured:
                tex[..., n_near:] = far[1]
        elif textured and banded:
            march_band_textured(dem, pcol, fscal, k_limit, plane, s, **bkw,
                                **okw)
        elif textured:
            march_textured(dem, pcol, fscal, k_limit, plane, s, **okw)
        elif banded:
            march_band(dem, pcol, fscal, k_limit, **bkw, **okw)
        else:
            march(dem, pcol, fscal, k_limit, **okw)
    truncated = _truncated(geo, p, band, k_limit)

    near = None
    if n_near > 0:
        with profiling.phase("hz.render.near_band"):
            # tiny grids: read as zero-padded (zeros = ocean)
            pad_i = max(ni, ALIGN_MIN_N) - ni
            pad_j = max(nj, ALIGN_MIN_N) - nj
            patch_n = (near_patch_size(znear_hint_m, cells_per_deg,
                                       lat_hint_deg)
                       if znear_hint_m is not None else None)
            if patch_n is not None and (patch_n > NEAR_PATCH_CAP or
                                        patch_n > min(ni + pad_i, nj + pad_j)):
                patch_n = None  # would not fit: the gather form, never a drop
            launches = near_band.launches
            nb = near_band(dem, p, geo, n_near=n_near, patch_n=patch_n, **bkw,
                           out=tanel[..., :n_near], want_samples=textured,
                           plain=plain)
            if near_band.launches != launches:
                profiling.count("hz.kernels.near_band",
                                near_band.launches - launches)
            near_hi, dropped = nb.near_hi, nb.dropped
            if textured:
                near = dq, iq, jq = nb.samples
                # band-local rows: in-band float32 x - k with integer k is
                # exact (window.py:1039-1043)
                jq_l = jq - float(band.offset) if band.offset else jq
                origin = (_patch_origin(p, patch_n, nj + pad_j, ni + pad_i,
                                        band.offset)
                          if patch_n is not None else None)
                with profiling.phase("hz.render.near_colors"):
                    if pad_i or pad_j:
                        near_src = torch.nn.functional.pad(
                            near_src, (0, s * pad_i, 0, s * pad_j))
                    tex[..., :n_near] = _near_colors(
                        near_src, s, iq, jq_l, ni_real=ni, nj_real=nj,
                        patch_n=patch_n, origin=origin, per_view=per_view)
    else:
        near_hi = near_top(p, geo)
        dropped = torch.zeros(p.znear.shape, dtype=torch.int32,
                              device=dem.device)
    if (textured and exact_near_m is not None and atlas is not None
            and atlas_params is not None):
        # global positions: each band computes the same exact colors for
        # its valid lanes, so the region combine stays exact
        with profiling.phase("hz.render.hybrid"):
            tex = _hybrid_near_field(tex, atlas, atlas_params, geo, p, near,
                                     n_near=n_near,
                                     cells_per_deg=cells_per_deg,
                                     lat_hint_deg=lat_hint_deg,
                                     exact_near_m=exact_near_m)
    dists = CrossingDists(e=geo.e, scale=geo.scale, znear=p.znear,
                          near_hi=near_hi, n_near=n_near, dropped=dropped,
                          truncated=truncated)
    if textured:
        return tanel, dists, tex
    return tanel, dists


def _hybrid_near_field(tex, atlas, ap, geo, p, near, *, n_near,
                       cells_per_deg, lat_hint_deg, exact_near_m):
    """Swap the plane colors of the samples within exact_near_m for
    atlas-true z12 texels (window.py:1203-1267, unaligned lanes); sample
    validity, and so every range, is untouched. Falls back loudly to the
    plane colors when the static caps are exceeded. Counts its viewpoints
    in ``hz.texture.hybrid``, or in ``hz.texture.hybrid_fallback`` when
    it falls back."""
    k_x, p_at = exact_near_sizes(exact_near_m, cells_per_deg, lat_hint_deg,
                                 ap.zoom)
    views = p.viewer_cell_i.numel()
    if p_at > EXACT_PATCH_CAP or k_x > TILE_K:
        profiling.count("hz.texture.hybrid_fallback", views)
        warnings.warn(
            f"hybrid near-field texture disabled for this render: "
            f"exact_near_m={exact_near_m:g} at lat_hint={lat_hint_deg:g} "
            f"needs an atlas patch of {p_at} px (cap {EXACT_PATCH_CAP}) "
            f"over {k_x} crossing steps (cap {TILE_K}); falling back to "
            f"half-cell grid2x colors. Reduce exact_near_m to restore "
            f"atlas-true near texels.", RuntimeWarning, stacklevel=3)
        return tex
    profiling.count("hz.texture.hybrid", views)
    ex, rep = _exact_near_colors(atlas, ap, geo, p, near, k_x=k_x,
                                 p_at=p_at,
                                 cells_per_deg=cells_per_deg,
                                 exact_near_m=exact_near_m)
    lanes = min(n_near + k_x, tex.shape[-1])
    return torch.cat([torch.where(rep[..., :lanes], ex[..., :lanes],
                                  tex[..., :lanes]), tex[..., lanes:]],
                     dim=-1)


def march_window(dem: torch.Tensor, params: RenderParams, *, width: int,
                 k_cross: int, cells_per_deg: int,
                 lat_hint_deg: float = 45.0, n_near: int = N_NEAR,
                 znear_hint_m=100.0, j_hi=None, j_offset=None,
                 color_planes=None, scene=None, atlas=None,
                 atlas_params=None, exact_near_m=None, plain: bool = False):
    """The crossing march on an (nj, ni) float32 DEM tensor, square or a
    row band (``j_hi``, ``j_offset``: the module docstring): returns
    (tanel (W, n_near + k_limit), run_max, dists, az[, tex]) like
    horizonator_tpu's march_window(scene=None); tex when ``color_planes``
    is given (see march_from_geometry). ``lat_hint_deg`` and
    ``znear_hint_m`` size the static near patch as there."""
    _check_supported(dem, scene)
    geo = crossing_geometry(params, width=width, cells_per_deg=cells_per_deg)
    out = march_from_geometry(
        dem, params, geo, k_cross=k_cross, cells_per_deg=cells_per_deg,
        lat_hint_deg=lat_hint_deg, n_near=n_near, znear_hint_m=znear_hint_m,
        color_planes=color_planes, atlas=atlas, atlas_params=atlas_params,
        exact_near_m=exact_near_m, j_hi=j_hi, j_offset=j_offset, plain=plain)
    tanel = out[0]
    run_max = torch.cummax(tanel, dim=-1).values
    return (tanel, run_max, out[1], geo.az) + tuple(out[2:])
