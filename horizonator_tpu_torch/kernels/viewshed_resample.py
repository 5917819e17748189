"""Viewshed resampler: the contract raster's cell test, CUDA kernels + plain
version.

``resample`` launches ``csrc/viewshed_resample.cu`` for CUDA tensors,
takes ``resample_plain`` for CPU tensors and raises for any other device;
``ops/viewshed.py`` calls it for every contract raster but ``plain=True``'s
direct masked max. ``resample_plain`` is the kernels' function in plain
PyTorch, op for op: the CPU's route, and the card's checks' reference.

Given a batch of B viewpoints' marches, tangents ``tanel`` and distances
``d`` (B, W, K), it returns each cell of the (2 hw)^2 frame as
``viewshed_grid(method="contract")`` computes it: the cell's own bilinear
(or triangulated) elevation tangent against

    th = max{tanel[b, x, k] : d[b, x, k] < r}     (NEG where empty)

with x the cell's polar column and r its radius along x less half a
crossing step, nn / cos(az_x) - half_x where |nn| >= |ee| (region A), else
ee / sin(az_x) - half_x. The columns are sorted by distance once, with a
running max of the tangents, so th is one binary search of the cell's own
radius: ``run[cnt - 1]`` with cnt = #{d < r}, the masked max whatever the
order of equal distances. Under ``full_circle`` a cell whose column lies
off its quadrant's quarter arc reads NEG and counts as uncovered
(``ops/viewshed._arc_covered``); the arcs' first columns come from each
viewpoint's azimuth window, on the device.

Inputs: ``obs`` (B, 11) float32, the RenderParams fields in their order;
``colv`` (B, W, 4) float32, cos and sin of each column's azimuth and its
half step (the fourth unused). With ``total`` ((2 hw, 2 hw) int32) the
visible viewpoints of each cell are added into it; otherwise the (B, 2 hw,
2 hw) bool raster and the (B,) int32 uncovered counts are returned.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import build

NEG = -3.0e38
OBS_WIDTH = 11                 # RenderParams fields a viewpoint
SORT_SMEM_MAX = 16384          # the longest column sorted in shared memory
PI32 = float(np.float32(math.pi))
TWO_PI32 = float(np.float32(2.0 * math.pi))
RECIP_2PI = float(np.float32(1.0) / np.float32(2.0 * math.pi))
_QA = math.pi / 4.0
# the quarter arcs' first azimuths, here and in ops/viewshed._arc_covered:
# by region (A, B), then north, then east
ARC_THETA = (math.pi, math.pi - _QA, -_QA, 0.0, -3.0 * _QA, math.pi / 2.0,
             -math.pi / 2.0, _QA)


def _padded(k: int) -> int:
    """The bitonic network's length: a power of two, at least 64."""
    return max(64, 1 << max(k - 1, 0).bit_length())


def _row_stride(k: int) -> int:
    """Elements a sorted column takes in the kernel's outputs: K, or the
    padded length where the column sorts in device memory."""
    kp = _padded(k)
    return kp if kp > SORT_SMEM_MAX else k


def columns_plain(tanel: torch.Tensor, d: torch.Tensor):
    """(sorted distances, running max of the tangents in that order), each
    (B, W, K); a NaN distance sorts as +inf."""
    key = torch.where(torch.isnan(d), torch.inf, d)
    key, order = torch.sort(key, dim=-1, stable=True)
    return key, torch.cummax(torch.gather(tanel, -1, order), dim=-1).values


def _search(dsorted, run, cell, r):
    """The kernel's binary search: run[cnt - 1] with cnt = #{dsorted < r}
    in each cell's row ``cell`` of the flat (B*W, K) columns, NEG where
    cnt is 0 or r is NaN."""
    k = dsorted.shape[-1]
    ds, rn = dsorted.reshape(-1, k), run.reshape(-1, k)
    lo = torch.zeros_like(cell)
    hi = torch.where(torch.isnan(r), 0, k)
    for _ in range(k.bit_length()):
        live = lo < hi
        mid = (lo + hi) // 2
        below = ds[cell, mid.clamp(max=k - 1)] < r
        lo = torch.where(live & below, mid + 1, lo)
        hi = torch.where(live & ~below, mid, hi)
    th = rn[cell, (lo - 1).clamp(min=0)]
    return torch.where(lo > 0, th, NEG)


def resample_plain(dem, tanel, d, obs, colv, *, hw: int, cell_n: float,
                   center, triangulated: bool, full_circle: bool,
                   total=None):
    """``resample`` in plain PyTorch, op for op the kernels' float32
    arithmetic (the module docstring)."""
    b, w, _ = tanel.shape
    n0, n1 = dem.shape
    dev = dem.device
    f32 = torch.float32
    dsorted, run = columns_plain(tanel, d)
    vci, vcj, vz, coslat, az0, az1, znear, zfar, _, _, curv = obs.unbind(1)
    # the viewpoints' own values (the kernel's ``observer``), (B,)
    dd = ((az1 - az0) - PI32) * RECIP_2PI
    a1 = ((dd - torch.round(dd)) * 2.0) * PI32 + PI32 + az0
    a1 = torch.where(a1 <= az0, az0 + TWO_PI32, a1)
    azc = (az0 + a1) * 0.5
    ndc = torch.full((), 2.0, dtype=f32, device=dev) / (a1 - az0)
    cn = torch.full((), cell_n, dtype=f32, device=dev)
    cell_e = cn * coslat
    off = torch.arange(2 * hw, dtype=f32, device=dev) - hw + 0.5
    di = dj = off.expand(b, -1)                                # (B, P2)
    if center is not None:
        di = (off + float(center[0])) - vci[:, None]
        dj = (off + float(center[1])) - vcj[:, None]
    pj, pi = vcj[:, None] + dj, vci[:, None] + di
    j0, i0 = torch.floor(pj[:, 0]), torch.floor(pi[:, 0])
    fj, fi = pj[:, 0] - j0, pi[:, 0] - i0
    pad, s = hw + 2, 2 * hw + 2
    js = torch.clamp(j0 + pad, 0, n0 + 2 * pad - s).to(torch.int64)
    is_ = torch.clamp(i0 + pad, 0, n1 + 2 * pad - s).to(torch.int64)
    theta = torch.tensor(ARC_THETA, dtype=f32, device=dev)
    xf = ((((theta - azc[:, None]) + PI32) * float(w)) * RECIP_2PI) - 0.5
    start = torch.remainder(torch.floor(xf).to(torch.int64) - 2, w)

    def view(x):                          # a (B,) value against the cells
        return x[:, None, None]
    # each viewpoint and cell: (B, P2 rows j, P2 columns i)
    nn = (dj * cn)[:, :, None]
    ee = (di * cell_e[:, None])[:, None, :]
    dist = torch.sqrt(ee * ee + nn * nn)
    dd = (torch.atan2(ee, nn) - view(azc)) * RECIP_2PI
    az = ((dd - torch.round(dd)) * 2.0) * PI32 + view(azc)
    x_ndc = (az - view(azc)) * view(ndc)
    xc = torch.clamp(torch.round(((x_ndc + 1.0) * 0.5) * float(w) - 0.5),
                     0, w - 1).to(torch.int64)
    ing = (((pj >= 0) & (pj <= n0 - 1))[:, :, None]
           & ((pi >= 0) & (pi <= n1 - 1))[:, None, :])
    mask = ((dist >= view(znear)) & (dist <= view(zfar)) & ing
            & (x_ndc >= -1.0) & (x_ndc <= 1.0))
    region_a = nn.abs() >= ee.abs()
    cell = torch.arange(b, device=dev)[:, None, None] * w + xc
    cv = colv.reshape(-1, 4)[cell]
    r = torch.where(region_a, nn / cv[..., 0], ee / cv[..., 1]) - cv[..., 2]
    th = _search(dsorted, run, cell, r)
    uncovered = torch.zeros(b, dtype=torch.int32, device=dev)
    if full_circle:
        arc = ((~region_a).to(torch.int64) * 4
               + (nn >= 0.0).to(torch.int64) * 2 + (ee >= 0.0).to(torch.int64))
        s_arc = torch.gather(start, 1, arc.reshape(b, -1)).view_as(arc)
        covered = torch.remainder(xc - s_arc, w) < min(w, w // 8 + 8)
        th = torch.where(covered, th, NEG)
        uncovered = (mask & ~covered).sum(dim=(1, 2), dtype=torch.int32)
    u = torch.arange(2 * hw, device=dev)
    rows = [torch.clamp(js[:, None] + u + o - pad, 0, n0 - 1)[:, :, None]
            for o in (0, 1)]
    cols = [torch.clamp(is_[:, None] + u + o - pad, 0, n1 - 1)[:, None, :]
            for o in (0, 1)]
    w00, w01, w10, w11 = (dem[rr, cc] for rr in rows for cc in cols)
    fj, fi = view(fj), view(fi)
    if triangulated:
        z_lower = (w00 + (w01 - w00) * fi) + (w11 - w01) * fj
        z_upper = (w00 + (w11 - w10) * fi) + (w10 - w00) * fj
        z = torch.where(fj <= fi, z_lower, z_upper)
    else:
        gj, gi = 1.0 - fj, 1.0 - fi
        z = (((gj * gi) * w00 + (gj * fi) * w01) + (fj * gi) * w10) \
            + (fj * fi) * w11
    t_cell = (z - view(vz)) / dist - dist * view(curv)
    vis = (t_cell >= th) & mask
    if total is not None:
        total += vis.sum(dim=0, dtype=torch.int32)
        return None
    return vis, uncovered


def _check(name: str, x: torch.Tensor, shape, dtype, device):
    if (x.device != device or x.dtype != dtype or tuple(x.shape) != shape
            or not x.is_contiguous()):
        raise ValueError(f"resample: {name} must be a contiguous {dtype} "
                         f"{shape} tensor on {device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def resample(dem, tanel, d, obs, colv, *, hw: int, cell_n: float, center,
             triangulated: bool, full_circle: bool, total=None):
    """The contract raster of a batch (the module docstring): (visible (B,
    2 hw, 2 hw) bool, uncovered (B,) int32), or None after adding the
    visible viewpoints of each cell into ``total``. On a card two
    launches, the columns' sort, then the cells; CPU tensors take
    ``resample_plain`` and launch nothing."""
    dev = dem.device
    if dem.dim() != 2 or tanel.dim() != 3:
        raise ValueError(f"resample: dem (n0, n1) and tanel (B, W, K), got "
                         f"{tuple(dem.shape)} and {tuple(tanel.shape)}")
    b, w, k = tanel.shape
    p2 = 2 * int(hw)
    _check("dem", dem, tuple(dem.shape), torch.float32, dev)
    _check("tanel", tanel, (b, w, k), torch.float32, dev)
    _check("d", d, (b, w, k), torch.float32, dev)
    _check("obs", obs, (b, OBS_WIDTH), torch.float32, dev)
    _check("colv", colv, (b, w, 4), torch.float32, dev)
    if total is not None:
        _check("total", total, (p2, p2), torch.int32, dev)
    if b * w >= 1 << 31 or k >= 1 << 30 or p2 > 1 << 19:
        raise ValueError(f"resample: B*W {b * w}, K {k} or 2 hw {p2} "
                         f"beyond the launch's limits")
    if dev.type == "cpu":
        return resample_plain(dem, tanel, d, obs, colv, hw=hw, cell_n=cell_n,
                              center=center, triangulated=triangulated,
                              full_circle=full_circle, total=total)
    if dev.type != "cuda":
        raise ValueError(f"resample: unsupported device {dev}")
    kp, ks = _padded(k), _row_stride(k)
    dsorted = torch.empty((b, w, ks), dtype=torch.float32, device=dev)
    run = torch.empty_like(dsorted)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = build.library()
    rc = lib.hz_viewshed_columns(tanel.data_ptr(), d.data_ptr(), b, w, k,
                                 kp, ks, dsorted.data_ptr(), run.data_ptr(),
                                 stream)
    if rc:
        raise RuntimeError(f"viewshed columns launch failed: CUDA error {rc}")
    vis = unc = None
    if total is None:
        vis = torch.empty((b, p2, p2), dtype=torch.bool, device=dev)
        unc = torch.zeros(b, dtype=torch.int32, device=dev)
    ci, cj = (0.0, 0.0) if center is None else map(float, center)
    rc = lib.hz_viewshed_cells(
        dem.data_ptr(), dem.shape[0], dem.shape[1], obs.data_ptr(),
        colv.data_ptr(), dsorted.data_ptr(), run.data_ptr(), b, w, k, ks,
        int(hw), cell_n, center is not None, ci, cj, RECIP_2PI,
        bool(triangulated), bool(full_circle),
        total.data_ptr() if total is not None else None,
        vis.data_ptr() if vis is not None else None,
        unc.data_ptr() if unc is not None and full_circle else None, stream)
    if rc:
        raise RuntimeError(f"viewshed cells launch failed: CUDA error {rc}")
    resample.launches += 1
    return None if total is not None else (vis, unc)


resample.launches = 0
