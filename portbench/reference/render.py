"""Plain reference of the panorama renderer (untextured window sampler).

One viewpoint at a time, in plain PyTorch, on whatever device its inputs
lie on. It imports nothing of the program: it is a frozen copy, trimmed to
the benchmark's path, of the float32 arithmetic that the program's render
defines (the crossing geometry, the far-field crossing march, the near band
through the viewer's 0.5 m patch, the first-crossing resolve with its
quantized refine fraction, ranges and the distance-red ramp), so a later
change to the program cannot move it. The program's kernels are held to
this arithmetic bit for bit, so sound runs agree with it to the last bit.

``dtype`` is the storage precision of the march's input and output, the
DEM and the (W, K) tangent field: float32 is the reference; bfloat16 is the
control, the step a later change that halves the march's bytes would take.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

EARTH_RADIUS_M = 6371000.0
DEG = math.pi / 180.0
NEG_BIG = -3.0e38
N_NEAR = 4
TILE_K = 128
ALIGN_MIN_N = TILE_K + 8
NEAR_PATCH_CAP = 64
_A_CAP = 10
_N2_MAX = 4096
BIG = 1 << 30


class View(NamedTuple):
    """One viewpoint's camera, each field a 0-d float32 tensor."""
    vi: torch.Tensor          # fractional grid column of the viewer (east)
    vj: torch.Tensor          # fractional grid row (north, row 0 = south)
    vz: torch.Tensor          # viewer elevation, m
    cos_lat: torch.Tensor
    az0: torch.Tensor         # left edge azimuth, rad (0 = north)
    az1: torch.Tensor
    znear: torch.Tensor
    zfar: torch.Tensor
    znear_color: torch.Tensor
    zfar_color: torch.Tensor
    curv: torch.Tensor


def make_view(device, **fields) -> View:
    """A View from Python numbers, each rounded to float32 once."""
    fields.setdefault("curv", 0.0)
    return View(*(torch.tensor(np.float32(fields[k]), device=device)
                  for k in View._fields))


def recip(c: float) -> float:
    return float(np.float32(1.0) / np.float32(c))


def const(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def fma32(x, y, z):
    """float32 x*y + z rounded once (float64 product, sum rounded to odd)."""
    p = x.double() * y.double()
    zd = z.double()
    s = p + zd
    bb = s - zd
    err = (zd - (s - bb)) + (p - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.to(torch.float32)


def k_cross_for(zfar_m, cells_per_deg, lat_deg, n=None, multiple=64) -> int:
    """Crossing steps that cover zfar at this latitude."""
    cell_n = EARTH_RADIUS_M * DEG / cells_per_deg
    cell_e = cell_n * abs(math.cos(math.radians(lat_deg)))
    k = int(math.ceil(zfar_m / max(cell_e, 1e-6))) + 2
    if n is not None:
        k = min(k, n)
    return max(multiple, -(-k // multiple) * multiple)


def step_budget(k_cross: int, n: int) -> int:
    """The far field's sample count: the budget capped by the grid."""
    n_ax = max(n, ALIGN_MIN_N)
    k_kernel = max(TILE_K, min(k_cross, -(-n_ax // TILE_K) * TILE_K))
    k_kernel = -(-k_kernel // TILE_K) * TILE_K
    return min(k_cross, k_kernel)


def near_patch_size(znear_hint_m, cells_per_deg, lat_hint_deg) -> int:
    cell_n = EARTH_RADIUS_M * DEG / cells_per_deg
    cell_e = cell_n * max(0.05, abs(math.cos(math.radians(lat_hint_deg))))
    reach = znear_hint_m + 1.5 * cell_n
    r = int(math.ceil(reach / min(cell_n, cell_e))) + 2
    return -(-(2 * r + 2) // 8) * 8


def _unwrap_near(x, near):
    d = (x - near) * recip(2.0 * math.pi)
    return (d - torch.round(d)) * 2.0 * math.pi + near


def az_window(az0, az1):
    """(az1 unwrapped into (az0, az0 + 2 pi], centre, ndc per radian)."""
    az1 = _unwrap_near(az1 - az0, math.pi) + az0
    az1 = torch.where(az1 <= az0, az0 + 2.0 * math.pi, az1)
    return az1, (az0 + az1) * 0.5, const(2.0, az0) / (az1 - az0)


def column_az(v: View, width: int):
    _, center, ndc = az_window(v.az0, v.az1)
    x = torch.arange(width, dtype=torch.float32, device=center.device)
    az_ndc = (x + 0.5) * recip(width) * 2.0 - 1.0
    return center[None] + az_ndc / ndc[None]


class Geom(NamedTuple):
    az: torch.Tensor
    j_dom: torch.Tensor
    axis0: torch.Tensor
    sign: torch.Tensor
    e: torch.Tensor
    scale: torch.Tensor
    a: torch.Tensor
    t: torch.Tensor
    cell_n: torch.Tensor
    cell_e: torch.Tensor


def geometry(v: View, az, cells_per_deg: int) -> Geom:
    """Each column's grid-crossing parameters: row-dominant rays cross
    integer rows, the others integer columns, the crossing at step m at
    cross position a + m t and horizontal distance (m + e) scale."""
    cell_n = const(EARTH_RADIUS_M * DEG / cells_per_deg, az)
    cell_e_v = cell_n * v.cos_lat
    cell_e = cell_e_v[None]
    sin_az, cos_az = torch.sin(az), torch.cos(az)
    eps = const(1e-30, az)
    g = sin_az * cell_n / (torch.where(cos_az.abs() < eps,
                                       torch.where(cos_az >= 0, eps, -eps),
                                       cos_az) * cell_e)
    gi = cos_az * cell_e / (torch.where(sin_az.abs() < eps,
                                        torch.where(sin_az >= 0, eps, -eps),
                                        sin_az) * cell_n)
    j_dom = g.abs() <= 1.0
    one = const(1.0, az)
    sign_j = torch.where(cos_az >= 0, one, -one)
    sign_i = torch.where(sin_az >= 0, one, -one)
    ci, cj = v.vi[None], v.vj[None]
    r0 = torch.where(sign_j > 0, torch.floor(cj) + 1.0, torch.ceil(cj) - 1.0)
    c0 = torch.where(sign_i > 0, torch.floor(ci) + 1.0, torch.ceil(ci) - 1.0)
    e_j = (r0 - cj) * sign_j
    e_i = (c0 - ci) * sign_i
    scale_j = cell_n / torch.maximum(cos_az.abs(), eps)
    scale_i = cell_e / torch.maximum(sin_az.abs(), eps)
    a_j = ci + sign_j * e_j * g
    a_i = cj + sign_i * e_i * gi
    return Geom(az=az, j_dom=j_dom,
                axis0=torch.where(j_dom, r0, c0).to(torch.int32),
                sign=torch.where(j_dom, sign_j, sign_i).to(torch.int32),
                e=torch.where(j_dom, e_j, e_i),
                scale=torch.where(j_dom, scale_j, scale_i),
                a=torch.where(j_dom, a_j, a_i),
                t=torch.where(j_dom, sign_j * g, sign_i * gi),
                cell_n=cell_n, cell_e=cell_e_v)


def _hats(x):
    fl = torch.floor(x)
    return (fl, torch.clamp(1.0 - torch.abs(x - fl), min=0.0),
            torch.clamp(1.0 - torch.abs(x - (fl + 1.0)), min=0.0))


def _far(dem, v: View, geo: Geom, k: int):
    """(W, k) tangents of the grid crossings, two taps along the crossed
    grid line, NEG_BIG outside the grid or [znear, zfar]."""
    n = dem.shape[0]
    col = [x[:, None] for x in (geo.a, geo.t, geo.e, geo.scale,
                                geo.axis0.to(torch.float32),
                                geo.sign.to(torch.float32))]
    a, t, e, dscale, axis0, sgn = col
    jd = geo.j_dom[:, None]
    mf = torch.arange(k, dtype=torch.float32, device=dem.device)[None, :]
    pos = fma32(mf, t, a)
    axis_m = axis0 + mf * sgn
    dm = (mf + e) * dscale
    hi = float(n - 1)
    valid = ((axis_m >= 0.0) & (axis_m <= hi) & (pos >= 0.0) & (pos <= hi)
             & (dm >= v.znear) & (dm <= v.zfar))
    fl, h_lo, h_hi = _hats(pos)
    ax = axis_m.clamp(-1, n).to(torch.int64)
    r = fl.clamp(-1, n).to(torch.int64)
    row = torch.where(jd, ax, r).clamp(0, n - 1)
    cl = torch.where(jd, r, ax).clamp(0, n - 1)
    i_lo = row * n + cl
    has_hi = torch.where(jd, cl + 1 < n, row + 1 < n)
    i_hi = torch.where(has_hi, i_lo + torch.where(jd, 1, n), i_lo)
    flat = dem.reshape(-1)
    z_lo, z_hi = flat[i_lo], torch.where(has_hi, flat[i_hi], 0)
    z = fma32(h_hi, z_hi, h_lo * z_lo)
    return torch.where(valid, fma32(-dm, v.curv.expand_as(dm),
                                    (z - v.vz) / dm), NEG_BIG)


def _hat(x, r):
    return torch.clamp(1.0 - torch.abs(x - r), min=0.0)


def _near(dem, v: View, geo: Geom, near_hi, patch_n: int):
    """(W, N_NEAR) tangents of the near band: uniform distances over
    [znear, near_hi), bilinear through the viewer-centred patch of 0.5 m
    elevations."""
    n_real = dem.shape[0]
    pad = max(n_real, ALIGN_MIN_N) - n_real
    grid = torch.nn.functional.pad(dem, (0, pad, 0, pad)) if pad else dem
    ng = n_real + pad
    q = torch.arange(N_NEAR, dtype=torch.float32,
                     device=near_hi.device)[None, :]
    dq = torch.clamp(v.znear + q * ((near_hi[:, None] - v.znear)
                                    * recip(N_NEAR)), min=1e-3)
    sin_az = torch.sin(geo.az)[:, None]
    cos_az = torch.cos(geo.az)[:, None]
    iq = v.vi + dq * sin_az / geo.cell_e
    jq = v.vj + dq * cos_az * (1.0 / geo.cell_n)
    vq = ((iq >= 0) & (iq <= float(n_real - 1)) & (jq >= 0)
          & (jq <= const(float(n_real - 1), jq)) & (dq >= v.znear)
          & (dq <= v.zfar) & (dq < near_hi[:, None]))
    oi, oj = (torch.clamp(torch.floor(c).to(torch.int32)
                          - (patch_n // 2 - 1), 0, ng - patch_n)
              for c in (v.vi, v.vj))
    ir = iq - oi.to(torch.float32)
    jr = jq - oj.to(torch.float32)
    u0, v0 = torch.floor(ir), torch.floor(jr)
    rows = [(v0 + d).clamp(0, patch_n - 1).to(torch.int64) for d in (0, 1)]
    cls = [(u0 + d).clamp(0, patch_n - 1).to(torch.int64) for d in (0, 1)]
    c = [[torch.round(grid[oj + r, oi + cc] * 2.0) * 0.5 for cc in cls]
         for r in rows]
    hx0, hx1 = _hat(ir, u0), _hat(ir, u0 + 1.0)
    acc0 = hx0 * c[0][0] + hx1 * c[0][1]
    acc1 = hx0 * c[1][0] + hx1 * c[1][1]
    zq = fma32(_hat(jr, v0 + 1.0), acc1, _hat(jr, v0) * acc0)
    last = float(patch_n - 1)
    vq = vq & (ir >= 0.0) & (ir <= last) & (jr >= 0.0) & (jr <= last)
    return torch.where(vq, fma32(-dq, v.curv.expand_as(dq),
                                 (zq - v.vz) / dq), const(NEG_BIG, zq))


class Dists(NamedTuple):
    e: torch.Tensor
    scale: torch.Tensor
    znear: torch.Tensor
    near_hi: torch.Tensor

    def d_of(self, idx):
        """Sample distance of (W, X) sample indices."""
        idxf = idx.to(torch.float32)
        d_near = self.znear + idxf * ((self.near_hi[:, None] - self.znear)
                                      * recip(N_NEAR))
        d_cross = (idxf - N_NEAR + self.e[:, None]) * self.scale[:, None]
        return torch.where(idxf < N_NEAR, d_near, d_cross)


def march(dem, v: View, az, *, k_cross, cells_per_deg, lat_hint_deg,
          znear_hint_m, dtype=torch.float32):
    """(tanel (W, N_NEAR + k), Dists, Geom) of one viewpoint on a square
    float32 DEM (row 0 south), the DEM and the field stored in ``dtype``."""
    dem = dem.to(dtype).to(torch.float32)
    n = dem.shape[0]
    geo = geometry(v, az, cells_per_deg)
    far = _far(dem, v, geo, step_budget(k_cross, n))
    m_star = torch.clamp(torch.ceil(v.znear / geo.scale - geo.e), min=0.0)
    near_hi = torch.maximum((m_star + geo.e) * geo.scale, v.znear[None])
    patch_n = near_patch_size(znear_hint_m, cells_per_deg, lat_hint_deg)
    if patch_n > NEAR_PATCH_CAP or patch_n > max(n, ALIGN_MIN_N):
        raise ValueError(f"near patch {patch_n} outside this reference")
    tanel = torch.cat([_near(dem, v, geo, near_hi, patch_n), far], dim=-1)
    tanel = tanel.to(dtype).to(torch.float32)
    return tanel, Dists(geo.e, geo.scale, v.znear, near_hi), geo


def _plan_bits(k: int, height: int):
    kp = -(-k // 128) * 128
    hp = max(-(-height // 128) * 128, 128)
    hb = max((hp - 1).bit_length(), 1)
    kb = max(kp.bit_length(), 1)
    a_bits = min(31 - hb - kb - 1, _A_CAP)
    n2 = 1 << (kp + hp - 1).bit_length()
    return a_bits, n2


def alpha_quantum(k: int, height: int):
    """(amax, int_first): the refine fraction's quantum 1/amax and how its
    numerator rounds, fixed by (K, H)."""
    a_bits, n2 = _plan_bits(k, height)
    if a_bits >= 5 and n2 <= _N2_MAX:
        return float((1 << a_bits) - 1), True
    rank_bits = height.bit_length()
    idx_bits = max((k + height).bit_length(), 1)
    a_bits = 32 - 1 - rank_bits - idx_bits - 1
    return float((1 << a_bits) - 1 if a_bits >= 5 else 32767), False


def resolve(y, height: int):
    """(idx, alpha, ok), each (W, height), of continuous rows y (W, K):
    the first sample whose running horizon reaches each pixel row at
    1/256 px, and the refine fraction between it and the one before."""
    w, k = y.shape
    amax, int_first = alpha_quantum(k, height)
    yq = torch.clamp(torch.round(y * 256.0), -2.0 ** 30, 2.0 ** 30)
    keys = torch.clamp(yq.to(torch.int32), -(BIG - 1), BIG - 1)
    keys = torch.cummin(keys, dim=1).values
    thr = (torch.arange(height, dtype=torch.int32, device=y.device)
           << 8)[None, :].expand(w, height)
    idx = torch.searchsorted((-keys).contiguous(), (-thr).contiguous(),
                             out_int32=True)
    has_cur, has_prev = idx < k, idx > 0
    cur = idx.clamp(max=k - 1).long()
    y_cur = torch.where(has_cur, torch.gather(keys, 1, cur), -BIG)
    y_prev = torch.where(
        has_prev, torch.gather(keys, 1, (idx - 1).clamp(min=0).long()), BIG)
    denom = (y_prev - y_cur).to(torch.float32)
    ok = (y_cur > -BIG) & (y_prev < BIG) & (denom > 0)
    if int_first:
        num = (y_prev - thr).to(torch.float32)
    else:
        num = y_prev.to(torch.float32) - thr.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=y.device)
    alpha = torch.clamp(num / torch.where(denom > 0, denom, one), 0.0, 1.0)
    alpha = torch.round(alpha * amax) * recip(amax)
    return idx, alpha, ok


def image(tanel, dists: Dists, v: View, *, width: int, height: int):
    """(image (H, W, 3) uint8 BGR, ranges (H, W) float32, -1 for sky)."""
    ktotal = tanel.shape[-1]
    _, _, ndc = az_window(v.az0, v.az1)
    aspect = width / height
    yy = torch.arange(height, dtype=torch.float32, device=tanel.device)
    el_ndc = 1.0 - (2.0 * yy + 1.0) * recip(height)
    el = el_ndc / ndc[None] * recip(aspect)
    el_k = torch.atan(tanel)
    y_k = (1.0 - el_k * (ndc * (width / height))) * (height * 0.5) - 0.5
    idx, alpha, ok = resolve(y_k.contiguous(), height)
    sky = idx >= ktotal
    idxc = torch.clamp(idx, max=ktotal - 1)
    d_hit = dists.d_of(idxc)
    okr = ok & (idxc > 0) & ~sky
    d_prev = dists.d_of(torch.clamp(idxc - 1, min=0))
    d_hit = torch.where(okr, d_prev + alpha * (d_hit - d_prev), d_hit)
    d_hit = torch.clamp(d_hit, v.znear, v.zfar)
    ranges = d_hit / torch.cos(el)[None, :]
    ranges = torch.where(sky, const(-1.0, ranges), ranges)
    red = torch.clamp((d_hit - v.znear_color)
                      / (v.zfar_color - v.znear_color), 0.0, 1.0)
    r8 = torch.round(red * 255.0).to(torch.uint8)
    zero = torch.zeros_like(r8)
    img = torch.stack([sky.to(torch.uint8) * 255, zero,
                       torch.where(sky, zero, r8)], dim=-1)
    return img.transpose(0, 1).contiguous(), ranges.t().contiguous()


def render(dem, v: View, *, width, height, k_cross, cells_per_deg,
           lat_hint_deg, znear_hint_m, dtype=torch.float32):
    """One panorama of the window sampler: (image, ranges) on dem's
    device."""
    tanel, dists, _ = march(dem, v, column_az(v, width), k_cross=k_cross,
                            cells_per_deg=cells_per_deg,
                            lat_hint_deg=lat_hint_deg,
                            znear_hint_m=znear_hint_m, dtype=dtype)
    return image(tanel, dists, v, width=width, height=height)
