"""Window march: far-field crossing samples, CUDA kernel + plain version.

``march`` launches ``csrc/window_march.cu`` for CUDA tensors and takes
``march_plain`` only for CPU tensors. The kernel gives a thread one column
and a warp 32 adjacent columns at one step, so a warp's taps lie on one
grid line; a block computes a tile of 32 columns x 64 steps into shared
memory and writes it out transposed, 128 contiguous bytes per warp store.
It is held by instruction throughput and the length of a sample's dependent
chain (bounds tests, hats, an IEEE division), not by the bytes it moves;
its source's header and PERF.md say how that was found. Both versions
compute, per (column w, step m) of a square (n, n) DEM:

    pos = fma(m, t, a), axis = axis0 + m*sign, d = (m + e)*scale
    z   = fma(h_hi, dem[floor(pos)+1], h_lo*dem[floor(pos)])  (2 taps along
          the crossed grid line: row ``axis`` if j_dom, else column ``axis``)
    out = fma(-d, curv, (z - vz)/d), or NEG_BIG outside [0, n-1]^2 or
          [znear, zfar]

with every float32 operation in the order of the JAX package's kernel
(horizonator_tpu/render/window.py::_window_kernel) as XLA evaluates it:
XLA contracts its ``a + mf*t``, its hat accumulation ``acc + hat*w`` and
its curvature term ``q - dm*curv`` into fused multiply-adds (measured on
the CPU: separate roundings match 74% of its samples, these three FMAs
100%). So both versions equal it bit
for bit wherever that kernel reports no dropped samples.

``march_textured`` (``csrc/window_march.cu``'s textured entry) adds each
sample's packed 0x00RRGGBB color from an (s*n, s*n) int32 plane, s = 1
(cell) or 2 (half-cell): the two texels at ``s*axis`` on the crossed line,
``floor(s*pos) + {0, 1}`` across it, weighted ``relu(1 - |s*pos - r|)``,
per channel ``fma(h_hi, c_hi, h_lo*c_lo)`` (the same accumulation XLA
fuses), then round half to even and clip to u8. Invalid samples get 0.

``march_band`` and ``march_band_textured`` (the source's banded entries)
march a rectangular (nj, ni) grid whose rows are a band of a larger one:
local row = global row - ``j_offset``, with the row coordinate valid in
[j_offset, j_offset + j_hi] (global, float32) and the column coordinate in
[0, ni - 1]. Positions, hats and distances stay global, so each sample is
bitwise the whole grid's march (window.py:822-834); the band's color
plane is (s*nj, s*ni), its rows from global 2x row s*j_offset. With
j_offset 0, j_hi n - 1 and a square grid every bound is the square one.
Their kernel first decides which of its 32 x 64 tiles hold a valid sample
(each thread tests its 16 samples as the march does, one block-wide OR):
a tile without one stores NEG_BIG and 0 colors straight from registers
and skips the loads, the arithmetic and the transpose, so a band beyond
zfar costs about a write-only pass over its outputs while a band beside
the viewer pays the march in its live tiles alone. The function, and so
``march_plain``, is the same.

Every entry takes ``out=`` (and the textured ones ``tex_out=``): a (W, k)
view, or (B, W, k) for a batch, of a wider buffer whose rows hold the
samples contiguously and evenly apart, as lanes [n_near, n_near + k) of
the render's whole field (render/window.py::march_from_geometry), which
the kernel then writes in place at that row stride. CPU tensors copy the
plain version's result into it.
"""

from __future__ import annotations

import torch

from . import build

NEG_BIG = -3.0e38
PCOL_WIDTH = 8   # a, t, e, scale, axis0, sign, j_dom, 0


def fma32(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """float32 x*y + z rounded once, like C ``fmaf``: the float64 product of
    two float32 values is exact, the float64 sum is rounded to odd, and
    rounding that to float32 is then the correctly rounded result (Boldo &
    Melquiond, "Emulation of FMA and correctly rounded sums", 2008)."""
    p = x.double() * y.double()
    zd = z.double()
    s = p + zd
    bb = s - zd
    err = (zd - (s - bb)) + (p - bb)          # TwoSum: s + err == p + zd
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.to(torch.float32)


def _hats(x: torch.Tensor):
    """(floor(x), relu(1 - |x - floor(x)|), relu(1 - |x - floor(x) - 1|))."""
    fl = torch.floor(x)
    h_lo = torch.clamp(1.0 - torch.abs(x - fl), min=0.0)
    h_hi = torch.clamp(1.0 - torch.abs(x - (fl + 1.0)), min=0.0)
    return fl, h_lo, h_hi


def _taps(plane: torch.Tensor, r: torch.Tensor, ax: torch.Tensor,
          jd: torch.Tensor, off: int = 0):
    """The two values of a (rows, cols) plane at global cross positions r
    and r + 1 on global line ``ax`` (a row for j-dominant rays, else a
    column); the plane's row 0 is global row ``off``. The upper value is 0
    where r + 1 lies outside (its weight is 0 there); indices of invalid
    samples are clamped into the plane. A plane of shape (B, rows, cols)
    holds one plane per viewpoint of (B, W, k) positions; a 2-D plane is
    shared by all."""
    rows, ncols = plane.shape[-2:]
    row = torch.where(jd, ax, r) - off
    col = torch.where(jd, r, ax)
    row, col = row.clamp(0, rows - 1), col.clamp(0, ncols - 1)
    i_lo = row * ncols + col
    if plane.dim() == 3:
        b = torch.arange(plane.shape[0], device=plane.device)[:, None, None]
        i_lo = i_lo + b * (rows * ncols)
    has_hi = torch.where(jd, col + 1 < ncols, row + 1 < rows)
    i_hi = torch.where(has_hi, i_lo + torch.where(jd, 1, ncols), i_lo)
    flat = plane.reshape(-1)
    return flat[i_lo], torch.where(has_hi, flat[i_hi], 0)


def march_plain(dem: torch.Tensor, pcol: torch.Tensor, fscal: torch.Tensor,
                k: int, colors: torch.Tensor | None = None, scale: int = 1,
                j_offset: int = 0, j_hi: float | None = None):
    """(W, k) float32 samples, plus their (W, k) int32 packed colors when
    ``colors`` is given; the gather form of the kernel's math. Batched as
    the kernel's wrappers are: pcol (B, W, 8) and fscal (B, 4) give (B, W,
    k), from a shared DEM or one (B, nj, ni) per viewpoint (colors
    likewise). A band (``j_offset``, ``j_hi``, the banded entries' module
    docstring) may be rectangular; j_hi defaults to nj - 1."""
    nj, ni = dem.shape[-2:]
    a, t, e, dscale, axis0, sgn, jdom = (pcol[..., c:c + 1] for c in range(7))
    vz, znear, zfar, curv = (fscal[..., c, None, None] for c in range(4))
    mf = torch.arange(k, dtype=torch.float32, device=dem.device)[None, :]
    pos = fma32(mf, t, a)
    axis_m = axis0 + mf * sgn
    dm = (mf + e) * dscale
    jd = jdom != 0.0
    # global bounds: the row coordinate in [jlo, jhi], columns [0, ni - 1]
    jlo = torch.tensor(float(j_offset), dtype=torch.float32,
                       device=dem.device)
    jhi = jlo + torch.tensor(float(nj - 1 if j_hi is None else j_hi),
                             dtype=torch.float32, device=dem.device)
    hi = float(ni - 1)
    ax_lo, ax_hi = torch.where(jd, jlo, 0.0), torch.where(jd, jhi, hi)
    cr_lo, cr_hi = torch.where(jd, 0.0, jlo), torch.where(jd, hi, jhi)
    valid = ((axis_m >= ax_lo) & (axis_m <= ax_hi) & (pos >= cr_lo)
             & (pos <= cr_hi) & (dm >= znear) & (dm <= zfar))
    fl, h_lo, h_hi = _hats(pos)
    big = j_offset + max(nj, ni)       # clamped, so the int64 casts hold
    ax = axis_m.clamp(-1, big).to(torch.int64)
    z_lo, z_hi = _taps(dem, fl.clamp(-1, big).to(torch.int64), ax, jd,
                       j_offset)
    z = fma32(h_hi, z_hi, h_lo * z_lo)
    tanel = torch.where(valid, fma32(-dm, curv, (z - vz) / dm), NEG_BIG)
    if colors is None:
        return tanel
    flc, hc_lo, hc_hi = _hats(pos * float(scale))
    c_lo, c_hi = _taps(colors, flc.clamp(-1, scale * big).to(torch.int64),
                       ax * scale, jd, scale * j_offset)
    packed = torch.zeros_like(c_lo)
    for sh in (0, 8, 16):                                     # B, G, R
        v = fma32(hc_hi, ((c_hi >> sh) & 0xff).to(torch.float32),
                  hc_lo * ((c_lo >> sh) & 0xff).to(torch.float32))
        packed |= torch.clamp(torch.round(v), 0.0, 255.0).to(
            torch.int32) << sh
    return tanel, torch.where(valid, packed, 0)


def _check(fn: str, name: str, x: torch.Tensor, shape, dtype, device):
    if (x.device != device or x.dtype != dtype or tuple(x.shape) != shape
            or not x.is_contiguous()):
        raise ValueError(f"{fn}: {name} must be a contiguous {dtype} {shape} "
                         f"tensor on {device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _plane_stride(fn: str, name: str, x: torch.Tensor, shape, b: int,
                  batched: bool, dtype, device) -> int:
    """Checks a shared plane of ``shape`` (rows, cols) or, in a batch, one
    (b, rows, cols) plane per viewpoint; returns its batch stride in
    elements (0: shared)."""
    per_view = batched and x.dim() == 3
    _check(fn, name, x, (b, *shape) if per_view else tuple(shape), dtype,
           device)
    return shape[0] * shape[1] if per_view else 0


def _outputs(fn: str, shape, device, out, tex_out, textured: bool):
    """(out, tex, row stride) of a launch: fresh (…, W, k) arrays, or the
    caller's views of wider buffers, checked: float32 samples (int32
    colors) on ``device``, each row's k lanes contiguous and the rows
    evenly apart (a batch's viewpoints too), the colors at the samples'
    stride."""
    if out is None:
        if tex_out is not None:
            raise ValueError(f"{fn}: tex_out without out")
        out = torch.empty(shape, dtype=torch.float32, device=device)
        tex = (torch.empty(shape, dtype=torch.int32, device=device)
               if textured else None)
        return out, tex, shape[-1]
    views = [("out", out, torch.float32)]
    if textured:
        views.append(("tex_out", tex_out, torch.int32))
    elif tex_out is not None:
        raise ValueError(f"{fn}: tex_out on an untextured march")
    ld = out.stride(-2) if out.dim() >= 2 else 0
    for name, x, dtype in views:
        if x is None:
            raise ValueError(f"{fn}: out without tex_out")
        strided = (x.dim() == len(shape) and x.stride(-1) == 1
                   and x.stride(-2) == ld >= shape[-1]
                   and (len(shape) == 2 or x.stride(0) == shape[1] * ld))
        if (tuple(x.shape) != tuple(shape) or x.dtype != dtype
                or x.device != device or not strided):
            raise ValueError(
                f"{fn}: {name} must be a {dtype} {tuple(shape)} view on "
                f"{device} with contiguous rows evenly apart, got {x.dtype} "
                f"{tuple(x.shape)} strides {x.stride()} on {x.device}")
    return out, tex_out, ld


def _check_march(fn: str, dem, pcol, fscal, band: bool = False):
    """(B, W, n, DEM batch stride, batched) of a launch: pcol (W, 8) and
    fscal (4,) march one viewpoint of a 2-D DEM; pcol (B, W, 8) and fscal
    (B, 4) a batch, of a shared (n, n) DEM or one (B, n, n) each (``band``:
    (nj, ni) and (B, nj, ni))."""
    if dem.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dem.device}")
    batched = pcol.dim() == 3
    b, w = (pcol.shape[0], pcol.shape[1]) if batched else (1, pcol.shape[0])
    n = dem.shape[-1]
    shape = tuple(dem.shape[-2:]) if band else (n, n)
    stride = _plane_stride(fn, "dem", dem, shape, b, batched, torch.float32,
                           dem.device)
    _check(fn, "pcol", pcol, (b, w, PCOL_WIDTH) if batched
           else (w, PCOL_WIDTH), torch.float32, dem.device)
    _check(fn, "fscal", fscal, (b, 4) if batched else (4,), torch.float32,
           dem.device)
    if b >= 1 << 31:
        raise ValueError(f"{fn}: batch {b} exceeds the launch's int32 count")
    return b, w, n, stride, batched


def _plain(fn: str, dem, out, tex_out, result):
    """The CPU route: the plain version's result, copied into ``out`` (and
    ``tex_out``) where given."""
    if out is None and tex_out is None:
        return result
    textured = isinstance(result, tuple)
    shape = (result[0] if textured else result).shape
    _outputs(fn, shape, dem.device, out, tex_out, textured)
    if textured:
        return out.copy_(result[0]), tex_out.copy_(result[1])
    return out.copy_(result)


def march(dem: torch.Tensor, pcol: torch.Tensor, fscal: torch.Tensor,
          k: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """(W, k) float32 far-field samples of a square (n, n) float32 DEM.

    ``pcol``: (W, 8) float32 per-column geometry (see PCOL_WIDTH);
    ``fscal``: (4,) float32 [viewer z, znear, zfar, curvature]. A batch of
    B viewpoints is one launch: pcol (B, W, 8), fscal (B, 4) and a shared
    (n, n) DEM or one (B, n, n) per viewpoint give (B, W, k). ``out``: a
    view to write them into (the module docstring)."""
    if dem.device.type == "cpu":
        return _plain("march", dem, out, None,
                      march_plain(dem, pcol, fscal, k))
    b, w, n, stride, batched = _check_march("march", dem, pcol, fscal)
    out, _, ld = _outputs("march", (b, w, k) if batched else (w, k),
                          dem.device, out, None, False)
    rc = build.library().hz_window_march(
        dem.data_ptr(), n, stride, pcol.data_ptr(), fscal.data_ptr(), b, w,
        k, out.data_ptr(), ld,
        torch.cuda.current_stream(dem.device).cuda_stream)
    if rc:
        raise RuntimeError(f"window march launch failed: CUDA error {rc}")
    march.launches += 1
    return out


march.launches = 0


def march_textured(dem: torch.Tensor, pcol: torch.Tensor,
                   fscal: torch.Tensor, k: int, colors: torch.Tensor,
                   scale: int, out: torch.Tensor | None = None,
                   tex_out: torch.Tensor | None = None):
    """(tanel (W, k) float32, tex (W, k) int32): ``march`` plus each
    sample's packed 0x00RRGGBB color from the (scale*n, scale*n) int32
    plane ``colors`` (scale 1: cell resolution, 2: half-cell). Batched as
    ``march``; in a batch ``colors`` is shared or (B, scale*n, scale*n).
    ``out`` and ``tex_out``: views at one row stride to write into."""
    if dem.device.type == "cpu":
        return _plain("march_textured", dem, out, tex_out,
                      march_plain(dem, pcol, fscal, k, colors, scale))
    b, w, n, stride, batched = _check_march("march_textured", dem, pcol,
                                            fscal)
    if scale not in (1, 2):
        raise ValueError(f"march_textured: scale must be 1 or 2, got {scale}")
    cstride = _plane_stride("march_textured", "colors", colors,
                            (scale * n, scale * n), b, batched, torch.int32,
                            dem.device)
    out, tex, ld = _outputs("march_textured",
                            (b, w, k) if batched else (w, k), dem.device,
                            out, tex_out, True)
    rc = build.library().hz_window_march_tex(
        dem.data_ptr(), n, stride, colors.data_ptr(), scale, cstride,
        pcol.data_ptr(), fscal.data_ptr(), b, w, k, out.data_ptr(),
        tex.data_ptr(), ld, torch.cuda.current_stream(dem.device).cuda_stream)
    if rc:
        raise RuntimeError(f"textured window march launch failed: CUDA "
                           f"error {rc}")
    march_textured.launches += 1
    return out, tex


march_textured.launches = 0


def _band_args(fn: str, dem, j_offset: int, j_hi: float):
    nj, ni = dem.shape[-2:]
    if not 0 <= int(j_offset) < 1 << 30:
        raise ValueError(f"{fn}: j_offset {j_offset} out of range")
    return nj, ni, int(j_offset), float(j_hi)


def march_band(dem: torch.Tensor, pcol: torch.Tensor, fscal: torch.Tensor,
               k: int, j_offset: int, j_hi: float,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """(W, k) far-field samples of a row band: a rectangular (nj, ni)
    float32 grid whose row 0 is global row ``j_offset``, rows valid up to
    global j_offset + j_hi (module docstring). Batched as ``march``: one
    (nj, ni) band for every viewpoint or (B, nj, ni). ``out`` as
    ``march``'s."""
    if dem.device.type == "cpu":
        return _plain("march_band", dem, out, None, march_plain(
            dem, pcol, fscal, k, j_offset=j_offset, j_hi=j_hi))
    b, w, _, stride, batched = _check_march("march_band", dem, pcol, fscal,
                                            band=True)
    nj, ni, off, jh = _band_args("march_band", dem, j_offset, j_hi)
    out, _, ld = _outputs("march_band", (b, w, k) if batched else (w, k),
                          dem.device, out, None, False)
    rc = build.library().hz_window_march_band(
        dem.data_ptr(), nj, ni, off, jh, stride, pcol.data_ptr(),
        fscal.data_ptr(), b, w, k, out.data_ptr(), ld,
        torch.cuda.current_stream(dem.device).cuda_stream)
    if rc:
        raise RuntimeError(f"banded window march launch failed: CUDA error "
                           f"{rc}")
    march_band.launches += 1
    return out


march_band.launches = 0


def march_band_textured(dem: torch.Tensor, pcol: torch.Tensor,
                        fscal: torch.Tensor, k: int, colors: torch.Tensor,
                        scale: int, j_offset: int, j_hi: float,
                        out: torch.Tensor | None = None,
                        tex_out: torch.Tensor | None = None):
    """(tanel (W, k), tex (W, k) int32): ``march_band`` plus each sample's
    packed color from the band's (scale*nj, scale*ni) int32 plane, whose
    row 0 is global 2x row scale*j_offset. Batched as ``march_band``;
    ``out`` and ``tex_out`` as ``march_textured``'s."""
    fn = "march_band_textured"
    if dem.device.type == "cpu":
        return _plain(fn, dem, out, tex_out, march_plain(
            dem, pcol, fscal, k, colors, scale, j_offset=j_offset, j_hi=j_hi))
    b, w, _, stride, batched = _check_march(fn, dem, pcol, fscal, band=True)
    nj, ni, off, jh = _band_args(fn, dem, j_offset, j_hi)
    if scale not in (1, 2):
        raise ValueError(f"{fn}: scale must be 1 or 2, got {scale}")
    cstride = _plane_stride(fn, "colors", colors, (scale * nj, scale * ni),
                            b, batched, torch.int32, dem.device)
    out, tex, ld = _outputs(fn, (b, w, k) if batched else (w, k),
                            dem.device, out, tex_out, True)
    rc = build.library().hz_window_march_band_tex(
        dem.data_ptr(), nj, ni, off, jh, stride, colors.data_ptr(), scale,
        cstride, pcol.data_ptr(), fscal.data_ptr(), b, w, k, out.data_ptr(),
        tex.data_ptr(), ld, torch.cuda.current_stream(dem.device).cuda_stream)
    if rc:
        raise RuntimeError(f"textured banded window march launch failed: "
                           f"CUDA error {rc}")
    march_band_textured.launches += 1
    return out, tex


march_band_textured.launches = 0
