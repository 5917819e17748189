"""Near band: each column's n_near bilinear samples between znear and its
first surviving crossing, CUDA kernel + plain version.

``near_band`` runs its argument checks for every device, then launches
``csrc/near_band.cu`` for CUDA tensors, once for a render or a batch, and
takes ``near_band_plain`` for CPU tensors or under ``plain=True``; any
other device raises. ``near_band_plain`` is the window march's torch near
band (the JAX package's window.py:1024-1114), op for op: the CPU's route,
and the card's checks' reference.

For each (viewpoint, column) of a crossing geometry:

- ``near_hi``, the top of the band: the first crossing at or beyond znear
  (the march's m*), never below znear;
- n_near distances ``dq`` uniform over [znear, near_hi) (floored at 1 mm)
  and their grid positions ``iq``, ``jq``;
- validity: the grid's (or row band's) bounds, [znear, zfar], dq <
  near_hi;
- the elevation: bilinear through the viewer-centred ``patch_n`` x
  ``patch_n`` patch of 0.5 m-rounded elevations (a valid sample outside
  the patch is counted in ``dropped`` and made invalid), or, with
  ``patch_n`` None, from the four gathered 0.5 m cells around it;
- the tangent fma(-dq, curv, (z - viewer_z) / dq), NEG_BIG where invalid.

Forms, from the arguments: one (nj, ni) grid for every viewpoint or one
(B, nj, ni) per viewpoint (the LOD crops); a row band (``j_offset``,
``j_hi``: global rows j_offset .. j_offset + j_hi, as the march's banded
entries take them) with band-local rows where they index; a grid below
``ALIGN_MIN_N`` rows or columns read as zero-padded to it, as the march
pads its grids (the plain version pads, the kernel reads zeros past the
edge).

``out``: a (…, W, n_near) view, its rows evenly apart, that receives the
tangents: lanes [0, n_near) of the march's whole (…, W, n_near + k) field
(render/window.py::march_from_geometry), whose other lanes the window
march writes. ``want_samples`` also returns (dq, iq, jq) with global rows,
for the near band's colours and the hybrid near field.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import build
from .window_march import NEG_BIG, fma32
from ..geometry import const, recip

# grids below this are zero-padded: the march's step tile TILE_K (128)
# plus 8 (window.py:738)
ALIGN_MIN_N = 128 + 8

# the per-viewpoint scalars the kernel reads, in csrc/near_band.cu's order
_SCALARS = (("p", "viewer_cell_i"), ("p", "viewer_cell_j"),
            ("p", "viewer_z"), ("p", "znear"), ("p", "zfar"), ("p", "curv"),
            ("geo", "cell_m_east"), ("geo", "cell_m_north"))


class NearBand(NamedTuple):
    tanel: torch.Tensor          # (…, W, n_near) float32
    near_hi: torch.Tensor        # (…, W) float32, the band's top
    dropped: torch.Tensor        # (…,) int32: valid samples off the patch
    samples: tuple | None        # (dq, iq, jq) (…, W, n_near), global rows


def _samples(x: torch.Tensor) -> torch.Tensor:
    """A per-viewpoint value against per-sample (…, W, Q) arrays."""
    return x[..., None, None]


def _hat(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(x - r), min=0.0)


def _corners(ir: torch.Tensor, jr: torch.Tensor, size: int):
    """(u0, v0, rows, cols): the floors of patch-relative positions and the
    two row and column indices of their bilinear stencil, clamped into a
    size x size patch (a clamped tap always carries zero weight)."""
    u0 = torch.floor(ir)
    v0 = torch.floor(jr)
    rows = [(v0 + dv).clamp(0, size - 1).to(torch.int64) for dv in (0, 1)]
    cols = [(u0 + du).clamp(0, size - 1).to(torch.int64) for du in (0, 1)]
    return u0, v0, rows, cols


def _bilerp(c, ir, jr, u0, v0) -> torch.Tensor:
    """The JAX package's patch contraction sum_v hat(jr - v) * sum_u
    hat(ir - u) * P[v, u] with its exact-zero terms dropped: four corners
    c[dv][du], no matmul (so no TF32), in the order XLA evaluates it.
    Corners may carry a leading channel axis over the (W, Q) positions."""
    hx0, hx1 = _hat(ir, u0), _hat(ir, u0 + 1.0)
    acc0 = hx0 * c[0][0] + hx1 * c[0][1]
    acc1 = hx0 * c[1][0] + hx1 * c[1][1]
    return fma32(_hat(jr, v0 + 1.0), acc1, _hat(jr, v0) * acc0)


def _take(plane: torch.Tensor, rows, columns, per_view: bool):
    """plane[rows, columns] of a shared 2-D plane, or with ``per_view``
    each viewpoint's own plane of a (B, m, m) stack at (B, ...) indices."""
    if not per_view:
        return plane[rows, columns]
    b = torch.arange(plane.shape[0], device=plane.device)
    return plane[b.view(-1, *([1] * (rows.dim() - 1))), rows, columns]


def _patch_origin(p, patch_n: int, nj: int, ni: int, offset: int = 0):
    """(oi, oj) int32: the viewer-centered near patch's corner in the
    (nj, ni) march grid, per viewpoint; a band's patch row is band-local,
    clipped into the band (window.py:1061-1065)."""
    vj = p.viewer_cell_j - float(offset) if offset else p.viewer_cell_j
    return tuple(
        torch.clamp(torch.floor(v).to(torch.int32) - (patch_n // 2 - 1),
                    0, edge - patch_n)
        for v, edge in ((p.viewer_cell_i, ni), (vj, nj)))


def _grid_pos(p, geo, d: torch.Tensor):
    """Grid coordinates (i, j) at horizontal distance d along each column."""
    sin_az = torch.sin(geo.az)[..., None]
    cos_az = torch.cos(geo.az)[..., None]
    iq = _samples(p.viewer_cell_i) + d * sin_az / _samples(geo.cell_m_east)
    # cell_m_north is a Python constant in the JAX package: XLA multiplies
    # by its float32 reciprocal
    jq = _samples(p.viewer_cell_j) + d * cos_az * (1.0 / geo.cell_m_north)
    return iq, jq


def _near_samples(p, geo, n_near: int, near_hi: torch.Tensor):
    """(dq, iq, jq) (W, n_near): the near band's uniform distances over
    [znear, near_hi) and their grid positions (window.py:1027-1038)."""
    q = torch.arange(n_near, dtype=torch.float32, device=near_hi.device)[
        None, :]
    znear = _samples(p.znear)
    # 1 mm floor: znear == 0 would put the first sample at d = 0
    dq = torch.clamp(
        znear + q * ((near_hi[..., None] - znear) * recip(n_near)),
        min=1e-3)
    return (dq,) + _grid_pos(p, geo, dq)


def near_top(p, geo) -> torch.Tensor:
    """(…, W) near_hi: the first crossing m* at or beyond znear, at its
    distance, and never below znear (window.py:1029-1031)."""
    znear = p.znear[..., None]
    m_star = torch.clamp(torch.ceil(znear / geo.scale - geo.e), min=0.0)
    return torch.maximum((m_star + geo.e) * geo.scale, znear)


def near_band_plain(dem: torch.Tensor, p, geo, *, n_near: int,
                    patch_n: int | None, j_offset: int = 0,
                    j_hi: float | None = None):
    """(tanel (…, W, n_near), near_hi, dropped, (dq, iq, jq)): the near
    band in torch passes (the module docstring), on any device."""
    nj, ni = dem.shape[-2:]
    j_hi = float(nj - 1 if j_hi is None else j_hi)
    per_view = dem.dim() == 3
    near_hi = near_top(p, geo)
    # tiny grids: zeros = ocean
    pad_i, pad_j = max(ni, ALIGN_MIN_N) - ni, max(nj, ALIGN_MIN_N) - nj
    grid = (torch.nn.functional.pad(dem, (0, pad_i, 0, pad_j))
            if pad_i or pad_j else dem)
    dq, iq, jq_g = _near_samples(p, geo, n_near, near_hi)
    # band-local rows: in-band float32 x - k with integer k is exact
    # (window.py:1039-1043)
    jq = jq_g - float(j_offset) if j_offset else jq_g
    vq = ((iq >= 0) & (iq <= float(ni - 1)) & (jq >= 0)
          & (jq <= const(j_hi, jq)) & (dq >= _samples(p.znear))
          & (dq <= _samples(p.zfar)) & (dq < near_hi[..., None]))
    dropped = torch.zeros(p.znear.shape, dtype=torch.int32,
                          device=dem.device)
    if patch_n is not None:
        # the viewer-centered patch at 0.5 m elevation resolution
        oi, oj = (_samples(o) for o in _patch_origin(
            p, patch_n, nj + pad_j, ni + pad_i, j_offset))
        ir = iq - oi.to(torch.float32)
        jr = jq - oj.to(torch.float32)
        u0, v0, rows, columns = _corners(ir, jr, patch_n)
        c = [[torch.round(_take(grid, oj + r, oi + cc, per_view) * 2.0) * 0.5
              for cc in columns] for r in rows]
        zq = _bilerp(c, ir, jr, u0, v0)
        last = float(patch_n - 1)
        in_patch = (ir >= 0.0) & (ir <= last) & (jr >= 0.0) & (jr <= last)
        dropped = (vq & ~in_patch).sum(dim=(-2, -1)).to(torch.int32)
        vq = vq & in_patch
    else:
        # patch too large for its cap (or the grid): bilinear from four
        # gathered corners of the 0.5 m int16-class grid (window.py:1097-1111)
        i0 = torch.clamp(torch.floor(iq), 0, ni - 2).to(torch.int32)
        j0 = torch.clamp(torch.floor(jq), 0, nj - 2).to(torch.int32)
        fi = torch.clamp(iq - i0, 0.0, 1.0)
        fj = torch.clamp(jq - j0, 0.0, 1.0)
        zq16 = torch.clamp(torch.round(grid * 2.0), -32768, 32767) * 0.5
        i0, j0 = i0.long(), j0.long()
        z00, z01, z10, z11 = (_take(zq16, j, i, per_view) for j, i in (
            (j0, i0), (j0, i0 + 1), (j0 + 1, i0), (j0 + 1, i0 + 1)))
        ztop = z00 + (z01 - z00) * fi
        zbot = z10 + (z11 - z10) * fi
        zq = ztop + (zbot - ztop) * fj
    tanel_q = torch.where(vq, fma32(-dq, _samples(p.curv).expand_as(dq),
                                    (zq - _samples(p.viewer_z)) / dq),
                          const(NEG_BIG, zq))
    return tanel_q, near_hi, dropped, (dq, iq, jq_g)


def _fail(what: str):
    raise ValueError(f"near_band: {what}")


def _check(dem, p, geo, n_near, patch_n, j_offset, out):
    """(lead, W) of a call: () or (B,), and the columns; raises on what
    neither route takes."""
    if dem.dim() not in (2, 3) or dem.dtype != torch.float32 \
            or not dem.is_contiguous():
        _fail(f"dem must be a contiguous float32 (nj, ni) or (B, nj, ni) "
              f"tensor, got {dem.dtype} {tuple(dem.shape)}")
    dev = dem.device
    lead, w = tuple(geo.az.shape[:-1]), geo.az.shape[-1]
    if len(lead) > 1 or (dem.dim() == 3 and lead != dem.shape[:1]):
        _fail(f"columns {tuple(geo.az.shape)} are not (W,) or (B, W) for "
              f"the grid {tuple(dem.shape)}")
    for name in ("az", "e", "scale"):
        x = getattr(geo, name)
        if tuple(x.shape) != lead + (w,) or x.dtype != torch.float32 \
                or x.device != dev:
            _fail(f"geo.{name} must be float32 {lead + (w,)} on {dev}, got "
                  f"{x.dtype} {tuple(x.shape)} on {x.device}")
    for src, name in _SCALARS:
        x = getattr(p if src == "p" else geo, name)
        if x.dtype != torch.float32 or x.device != dev \
                or tuple(x.shape) not in ((), lead):
            _fail(f"{src}.{name} must be float32, 0-d or {lead}, on {dev}, "
                  f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if geo.cell_m_north.dim():
        _fail("geo.cell_m_north must be 0-d")
    nj, ni = dem.shape[-2:]
    if not 1 <= n_near < 1 << 16:
        _fail(f"n_near {n_near} out of range")
    if patch_n is not None and not 2 <= patch_n <= max(min(nj, ni),
                                                       ALIGN_MIN_N):
        _fail(f"patch_n {patch_n} does not fit the grid {tuple(dem.shape)}")
    if not 0 <= int(j_offset) < 1 << 30:
        _fail(f"j_offset {j_offset} out of range")
    if w >= 1 << 31 or nj * ni >= 1 << 31:
        _fail(f"W {w} or the grid {tuple(dem.shape)} beyond the launch's "
              f"int32 limits")
    if out is not None:
        ld = out.stride(-2) if out.dim() >= 2 else 0
        if (tuple(out.shape) != lead + (w, n_near)
                or out.dtype != torch.float32 or out.device != dev
                or out.stride(-1) != 1 or ld < n_near
                or (lead and out.stride(0) != w * ld)):
            _fail(f"out must be a float32 {lead + (w, n_near)} view on {dev} "
                  f"with contiguous rows evenly apart, got {out.dtype} "
                  f"{tuple(out.shape)} strides {out.stride()} on "
                  f"{out.device}")
    return lead, w


def near_band(dem: torch.Tensor, p, geo, *, n_near: int,
              patch_n: int | None, j_offset: int = 0,
              j_hi: float | None = None, out: torch.Tensor | None = None,
              want_samples: bool = False, plain: bool = False) -> NearBand:
    """The near band of crossing geometry ``geo`` for RenderParams ``p`` on
    ``dem`` (the module docstring): one launch on a card, the torch passes
    of ``near_band_plain`` for CPU tensors or under ``plain``. ``out``
    receives the tangents where given; ``want_samples`` adds (dq, iq,
    jq)."""
    lead, w = _check(dem, p, geo, n_near, patch_n, j_offset, out)
    nj, ni = dem.shape[-2:]
    j_hi = float(nj - 1 if j_hi is None else j_hi)
    dev = dem.device
    if plain or dev.type == "cpu":
        tanel, near_hi, dropped, smp = near_band_plain(
            dem, p, geo, n_near=n_near, patch_n=patch_n, j_offset=j_offset,
            j_hi=j_hi)
        if out is not None:
            tanel = out.copy_(tanel)
        return NearBand(tanel, near_hi, dropped,
                        smp if want_samples else None)
    if dev.type != "cuda":
        _fail(f"unsupported device {dev}")
    if out is None:
        out = torch.empty(lead + (w, n_near), dtype=torch.float32, device=dev)
    near_hi = torch.empty(lead + (w,), dtype=torch.float32, device=dev)
    dropped = torch.empty(lead, dtype=torch.int32, device=dev)
    smp = (tuple(torch.empty(lead + (w, n_near), dtype=torch.float32,
                             device=dev) for _ in range(3))
           if want_samples else None)
    scalars = build.Scalars()
    for k, (src, name) in enumerate(_SCALARS):
        x = getattr(p if src == "p" else geo, name)
        scalars.ptr[k] = x.data_ptr()
        scalars.stride[k] = x.stride(0) if x.dim() else 0
    az, e, scale = (getattr(geo, n).contiguous() for n in ("az", "e",
                                                          "scale"))
    smp_ptrs = [x.data_ptr() for x in smp] if smp else [None] * 3
    rc = build.library().hz_near_band(
        dem.data_ptr(), nj, ni, nj * ni if dem.dim() == 3 else 0,
        max(nj, ALIGN_MIN_N), max(ni, ALIGN_MIN_N), int(j_offset), j_hi,
        patch_n or 0, az.data_ptr(), e.data_ptr(), scale.data_ptr(), scalars,
        lead[0] if lead else 1, w, n_near, recip(n_near), out.data_ptr(),
        out.stride(-2), near_hi.data_ptr(), dropped.data_ptr(),
        *smp_ptrs,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"near band launch failed: CUDA error {rc}")
    near_band.launches += 1
    return NearBand(out, near_hi, dropped, smp)


near_band.launches = 0
