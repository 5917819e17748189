"""Mesh rasterizer: the reference's triangle pipeline, the parity oracle.

Counterpart of horizonator_tpu.render.mesh. The reference renders a dense
regular-grid triangulation, two triangles a DEM cell split along the
(i, j) -> (i+1, j+1) diagonal (horizonator-lib.c:496-507), through an
equirectangular vertex shader (vertex.glsl:112-156), a geometry-shader
seam cull that drops triangles spanning more than a quarter of the
viewport (geometry.glsl:21-27), and a z-buffered fill with depth = slant
range (vertex.glsl:155). This module keeps those semantics: every DEM
vertex projected once, the same diagonal split and seam cull, barycentric
coverage with linear depth, and a scatter-min z-buffer.

The z-buffer is ``Tensor.scatter_reduce_(..., "amin")`` into a (W*H + 1,)
float32 buffer whose last slot takes the rejected fragments. A minimum is
exact and does not depend on the order of the fragments, so the result is
deterministic on any device and whatever the chunking. Two passes, as in
the JAX package: pass 1 takes the exact float32 minimum depth, pass 2 the
minimum horizontal distance d_ne among the fragments whose depth equals
the stored one exactly, so depth ties resolve the same way everywhere.

Each triangle is rasterized over a fixed pixel box (``max_bbox``); a
triangle projecting larger is counted in the returned overflow and
dropped. ``render_mesh_tiled`` buckets triangles by box size on the host
(two (T,) copies) and gives the few large near-field triangles larger
boxes, so a full SRTM3 tile renders exactly at the reference's default
100 m znear. That host step is the JAX package's design for an oracle; the
fragments and the scatters run on the tensors' device. Fragments are
processed in chunks of about ``FRAGMENT_BUDGET`` (render_mesh) or
``fragment_budget`` (render_mesh_tiled), which bounds the working memory
and changes no result.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import geometry
from ..geometry import const
from .raymarch import RenderParams

DEG = math.pi / 180.0
# fragments (triangle x box pixel) a chunk of render_mesh computes at once
FRAGMENT_BUDGET = 1 << 22


def _hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """jnp.hypot's formula: max * sqrt(1 + (min / max)^2), 0 where both
    are 0."""
    x, y = x.abs(), y.abs()
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    zero = hi == 0
    r = hi * torch.sqrt(1.0 + torch.square(
        lo / torch.where(zero, torch.ones_like(hi), hi)))
    return torch.where(zero, hi, r)


def _project_vertices(dem: torch.Tensor, params: RenderParams, *, width: int,
                      height: int, cells_per_deg: int):
    """Every DEM vertex projected (mesh.py:42-75): (x, y) fractional pixel
    coordinates, the slant range, the horizontal distance d_ne and the
    azimuth in ndc, each (n, n)."""
    p = params
    n = dem.shape[0]
    cell_n = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    cell_e = cell_n * p.cos_viewer_lat
    ar = torch.arange(n, dtype=torch.float32, device=dem.device)
    east = (ar[None, :] - p.viewer_cell_i) * cell_e
    north = (ar[:, None] - p.viewer_cell_j) * cell_n
    h = dem.to(torch.float32) - p.viewer_z
    d_ne = _hypot(east, north)
    rng = _hypot(d_ne, h)
    az = torch.atan2(east, north)
    _, az_center, az_ndc_per_rad = geometry.az_window_rad(p.az_rad0,
                                                          p.az_rad1)
    azu = geometry.unwrap_near_rad(az, az_center)
    az_ndc = (azu - az_center) * az_ndc_per_rad
    el = torch.atan2(h - d_ne * d_ne * p.curv, d_ne)
    el_ndc = el * az_ndc_per_rad * (width / height)
    x = (az_ndc + 1.0) * 0.5 * width - 0.5       # pixel-centre coordinates
    y = (1.0 - el_ndc) * 0.5 * height - 0.5
    return x, y, rng, d_ne, az_ndc


def _mesh_triangles(dem: torch.Tensor, params: RenderParams, *, width: int,
                    height: int, cells_per_deg: int):
    """The reference mesh's triangles (mesh.py:78-107): (tx, ty, trng,
    tdne), each (T, 3), and keep (T,), the seam and clip culls applied
    (the box culls are the rasterizer's)."""
    p = params
    verts = _project_vertices(dem, params, width=width, height=height,
                              cells_per_deg=cells_per_deg)
    tris = []
    for arr in verts:
        a00 = arr[:-1, :-1].reshape(-1)
        a10 = arr[:-1, 1:].reshape(-1)
        a01 = arr[1:, :-1].reshape(-1)
        a11 = arr[1:, 1:].reshape(-1)
        lower = torch.stack([a00, a10, a11], dim=1)
        upper = torch.stack([a00, a11, a01], dim=1)
        tris.append(torch.cat([lower, upper]))
    tx, ty, trng, tdne, tazn = tris
    span = tazn.amax(dim=1) - tazn.amin(dim=1)
    keep = ((span <= 0.5) & (tdne.amin(dim=1) <= p.zfar)
            & (tdne.amax(dim=1) > p.znear))
    return tx, ty, trng, tdne, keep


def _tri_bbox(tx: torch.Tensor, ty: torch.Tensor):
    """Integer projected box (x0, x1, y0, y1) of each triangle: the one
    rule shared by the raster pass, the overflow count and
    render_mesh_tiled's buckets."""
    return (torch.floor(tx.amin(dim=1)).to(torch.int32),
            torch.ceil(tx.amax(dim=1)).to(torch.int32),
            torch.floor(ty.amin(dim=1)).to(torch.int32),
            torch.ceil(ty.amax(dim=1)).to(torch.int32))


def _raster_pass(tx, ty, trng, tdne, keep, zbuf, *, max_bbox: int,
                 width: int, height: int, znear, zfar, dbuf=None):
    """Scatter one subset of triangles (mesh.py:121-181): into the
    z-buffer ``zbuf`` (pass 1, ``dbuf`` None), or, given the final zbuf,
    their d_ne into ``dbuf`` where a fragment's depth equals the stored
    minimum (pass 2). Updates the buffer in place and returns it."""
    dev = tx.device
    x0, x1, y0, y1 = _tri_bbox(tx, ty)
    keep = (keep & (x1 - x0 < max_bbox) & (y1 - y0 < max_bbox)
            & (x1 >= 0) & (x0 < width) & (y1 >= 0) & (y0 < height))
    x0c = torch.clamp(x0, 0, width - 1)
    y0c = torch.clamp(y0, 0, height - 1)
    bb = torch.arange(max_bbox, dtype=torch.int32, device=dev)
    gx = (x0c[:, None] + bb)[:, None, :]                     # (T, 1, B)
    gy = (y0c[:, None] + bb)[:, :, None]                     # (T, B, 1)
    pxg, pyg = gx.to(torch.float32), gy.to(torch.float32)

    ax, bx, cx = (tx[:, c, None, None] for c in range(3))
    ay, by, cy = (ty[:, c, None, None] for c in range(3))
    det = (bx - ax) * (cy - ay) - (cx - ax) * (by - ay)
    det = torch.where(det.abs() < 1e-12, const(1e-12, det), det)
    w0 = ((bx - ax) * (pyg - ay) - (by - ay) * (pxg - ax)) / det
    w1 = ((cx - bx) * (pyg - by) - (cy - by) * (pxg - bx)) / det
    w2 = 1.0 - w0 - w1
    inside = (w0 >= -1e-6) & (w1 >= -1e-6) & (w2 >= -1e-6)

    def interp(t):
        return (w1 * t[:, 0, None, None] + w2 * t[:, 1, None, None]
                + w0 * t[:, 2, None, None])
    depth = interp(trng)
    dne_i = interp(tdne)
    valid = (inside & keep[:, None, None] & (gx < width) & (gy < height)
             & (dne_i >= znear) & (dne_i <= zfar))
    flat = torch.where(valid, gy * width + gx, width * height).reshape(-1)
    flat = flat.long()
    inf = const(math.inf, depth)
    if dbuf is None:
        return zbuf.scatter_reduce_(
            0, flat, torch.where(valid, depth, inf).reshape(-1), "amin")
    won = valid.reshape(-1) & (depth.reshape(-1) == zbuf[flat])
    return dbuf.scatter_reduce_(
        0, flat, torch.where(won, dne_i.reshape(-1), inf), "amin")


def _raster_chunks(tris, keep, zbuf, dbuf, idx, *, max_bbox, chunk, width,
                   height, znear, zfar, pass2):
    """_raster_pass over the triangles ``idx`` (int64 indices, or None for
    all of them) in chunks of ``chunk`` triangles."""
    total = keep.shape[0] if idx is None else idx.shape[0]
    for s in range(0, total, chunk):
        sel = (slice(s, s + chunk) if idx is None else idx[s:s + chunk])
        sub = [t[sel] for t in tris]
        _raster_pass(*sub, keep[sel], zbuf, max_bbox=max_bbox, width=width,
                     height=height, znear=znear, zfar=zfar,
                     dbuf=dbuf if pass2 else None)


def _buffers(width: int, height: int, device):
    return (torch.full((width * height + 1,), math.inf, dtype=torch.float32,
                       device=device),
            torch.full((width * height + 1,), math.inf, dtype=torch.float32,
                       device=device))


def _assemble_image(zbuf, dbuf, p: RenderParams, width: int, height: int):
    """(image (H, W, 3) uint8 BGR, ranges (H, W) float32) of the two
    buffers (mesh.py:216-229): sky where no fragment landed."""
    zb = zbuf[:width * height].view(height, width)
    db = dbuf[:width * height].view(height, width)
    sky = ~torch.isfinite(zb)
    ranges = torch.where(sky, const(-1.0, zb), zb)
    red = torch.clamp((db - p.znear_color) / (p.zfar_color - p.znear_color),
                      0.0, 1.0)
    r8 = torch.round(red * 255.0).to(torch.uint8)
    zero = torch.zeros_like(r8)
    image = torch.stack([sky.to(torch.uint8) * 255, zero,
                         torch.where(sky, zero, r8)], dim=-1)
    return image, ranges


def render_mesh(dem: torch.Tensor, params: RenderParams, *, width: int,
                height: int, cells_per_deg: int, max_bbox: int = 12):
    """Rasterize the reference's terrain mesh of a square float32 DEM
    (mesh.py:184-213) for one viewpoint (0-d params). Returns (image,
    ranges, overflow_count): render_panorama's conventions (BGR uint8 with
    blue sky, float32 slant metres with -1 for sky), and the int 0-d count
    of on-screen kept triangles whose box exceeds ``max_bbox`` (assert 0
    for exact runs)."""
    p = params
    tx, ty, trng, tdne, keep = _mesh_triangles(
        dem, p, width=width, height=height, cells_per_deg=cells_per_deg)
    x0, x1, y0, y1 = _tri_bbox(tx, ty)
    on_screen = (x1 >= 0) & (x0 < width) & (y1 >= 0) & (y0 < height)
    overflow = (keep & on_screen & ((x1 - x0 >= max_bbox)
                                    | (y1 - y0 >= max_bbox))).sum()
    zbuf, dbuf = _buffers(width, height, dem.device)
    chunk = max(8, FRAGMENT_BUDGET // (max_bbox * max_bbox))
    kw = dict(max_bbox=max_bbox, chunk=chunk, width=width, height=height,
              znear=p.znear, zfar=p.zfar)
    tris = (tx, ty, trng, tdne)
    for pass2 in (False, True):
        _raster_chunks(tris, keep, zbuf, dbuf, None, pass2=pass2, **kw)
    image, ranges = _assemble_image(zbuf, dbuf, p, width, height)
    return image, ranges, overflow


def _tri_class_inputs(dem, params, *, width, height, cells_per_deg):
    """The triangles, each one's box size (the larger side) and whether it
    is kept and on screen (mesh.py:232-243)."""
    tx, ty, trng, tdne, keep = _mesh_triangles(
        dem, params, width=width, height=height, cells_per_deg=cells_per_deg)
    x0, x1, y0, y1 = _tri_bbox(tx, ty)
    keep_v = keep & (x1 >= 0) & (x0 < width) & (y1 >= 0) & (y0 < height)
    return (tx, ty, trng, tdne, keep, torch.maximum(x1 - x0, y1 - y0),
            keep_v)


def render_mesh_tiled(dem: torch.Tensor, params: RenderParams, *, width: int,
                      height: int, cells_per_deg: int,
                      bbox_classes=(12, 64, 256, 1024),
                      fragment_budget: int = 8 << 20):
    """render_mesh at reference scale (mesh.py:264-319): triangles go to
    the smallest box class of ``bbox_classes`` that holds them (one beyond
    the last counts in the returned overflow, which a full run asserts 0),
    and each class rasterizes in chunks of about ``fragment_budget``
    fragments. Same two passes and results as render_mesh. The classes
    are chosen on the host from two (T,) copies.

    Returns (image, ranges, overflow_count int)."""
    p = params
    tx, ty, trng, tdne, keep, size, keep_v = _tri_class_inputs(
        dem, p, width=width, height=height, cells_per_deg=cells_per_deg)
    size_np = size.cpu().numpy()
    kept_np = keep_v.cpu().numpy()
    overflow = int((kept_np & (size_np >= bbox_classes[-1])).sum())
    plan = []
    lo = 0
    for bclass in bbox_classes:
        idx = np.nonzero(kept_np & (size_np >= lo) & (size_np < bclass))[0]
        lo = bclass
        if len(idx):
            plan.append((bclass, torch.from_numpy(idx).to(dem.device)))
    zbuf, dbuf = _buffers(width, height, dem.device)
    tris = (tx, ty, trng, tdne)
    for pass2 in (False, True):
        for bclass, idx in plan:
            _raster_chunks(tris, keep, zbuf, dbuf, idx, max_bbox=bclass,
                           chunk=max(8, fragment_budget // (bclass * bclass)),
                           width=width, height=height, znear=p.znear,
                           zfar=p.zfar, pass2=pass2)
    image, ranges = _assemble_image(zbuf, dbuf, p, width, height)
    return image, ranges, overflow
