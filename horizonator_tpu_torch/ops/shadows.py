"""Cast terrain shadows and solar-exposure analysis, on torch tensors.

Counterpart of horizonator_tpu.ops.shadows. A cell p is shadowed iff some
terrain sample toward the sun pokes above the sun ray through p, i.e. with

    g(p) = z(p) - s(p) * tan(alt),   s(p) = projection of p onto the
                                            horizontal sun direction (m)

p is shadowed iff the suffix-max of ``g`` along the sun direction beyond p
exceeds g(p). The sun's minor/dominant slope is snapped on the host to the
best rational p/q with q <= ray_denom_max (``_ray_step``); the first q taps
are single-level 2-tap lerps of the raw g field, then ceil(log2(n/q))
doubling stages max the field with itself shifted by the integer lattice
vector (q, p) * 2^k. Every pass is an elementwise shift and max over the
grid: no gathers, no host loops over cells.

The JAX function is jitted, and XLA on the CPU lets LLVM contract some of
its products into fused multiply-adds; which ones depends on the grid's
shape (where a fused loop is unrolled whole, LLVM folds the column ramp
into constants), so no fixed rounding is bitwise the JAX package's at
every shape. The port rounds every operation once, in float32, in the
JAX source's order; only ``diff / soft_m`` becomes a product with the
float32 reciprocal, as XLA writes it and as it must be for the CPU and the
card to agree (CUDA divides by a host scalar through its reciprocal, the
CPU truly). The same operations run on both devices, so they agree
bitwise; against the JAX package the light field agrees to within 2 ulp
of the largest |g|, divided by soft_m (tests/test_torch_shadows.py).
"""

from __future__ import annotations

import math
from datetime import date as _date, datetime, timedelta
from fractions import Fraction

import torch

from .. import geometry
from ..geometry import recip

DEG = math.pi / 180.0
_NEG = -3.0e38

__all__ = ["shadow_light", "sun_hours"]


def _shift_int(a: torch.Tensor, sj: int, si: int, fill: float) -> torch.Tensor:
    """out[j, i] = a[j + sj, i + si]; cells shifted in from outside the
    grid take ``fill``. One pass: the valid slice copied into a filled
    tensor."""
    nj, ni = a.shape
    out = torch.full_like(a, fill)
    j0, j1 = max(0, -sj), min(nj, nj - sj)
    i0, i1 = max(0, -si), min(ni, ni - si)
    if j0 < j1 and i0 < i1:
        out[j0:j1, i0:i1] = a[j0 + sj:j1 + sj, i0 + si:i1 + si]
    return out


def _shift_ray(a: torch.Tensor, tj: float, ti: float,
               fill: float) -> torch.Tensor:
    """Shift by a real (tj, ti) cell offset, at most one axis fractional
    (the ray step is exactly +-1 on its dominant axis): integer shifts
    plus a 2-tap lerp on the minor axis."""
    j0, i0 = math.floor(tj), math.floor(ti)
    fj, fi = tj - j0, ti - i0
    v = _shift_int(a, j0, i0, fill)
    if fj > 1e-9:
        w = _shift_int(a, j0 + 1, i0, fill)
        f = fj
    elif fi > 1e-9:
        w = _shift_int(a, j0, i0 + 1, fill)
        f = fi
    else:
        return v
    return (1.0 - f) * v + f * w


def _ray_step(cells_per_deg: int, lat_deg: float, sun_az_deg: float,
              ray_denom_max: int):
    """The quantized toward-sun ray: per-step cell offsets (dj, di) with
    the minor/dominant slope snapped to the best rational p/q
    (q <= ray_denom_max), meters per step h, and (p, q, dom_is_j).
    Host math, as the JAX package's (ops/shadows.py:76)."""
    cell_n = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    cell_e = cell_n * max(0.05, abs(math.cos(math.radians(lat_deg))))
    az = math.radians(sun_az_deg)
    dj_m = math.cos(az) / cell_n                 # cells per meter, north
    di_m = math.sin(az) / cell_e                 # cells per meter, east
    dom_is_j = abs(dj_m) >= abs(di_m)            # dominant axis: +-1 cell/step
    if dom_is_j:
        sgn = 1.0 if dj_m >= 0 else -1.0
        f = Fraction(di_m / abs(dj_m)).limit_denominator(ray_denom_max)
        dj, di = sgn, float(f)
        h = math.hypot(cell_n, cell_e * float(f))
    else:
        sgn = 1.0 if di_m >= 0 else -1.0
        f = Fraction(dj_m / abs(di_m)).limit_denominator(ray_denom_max)
        dj, di = float(f), sgn
        h = math.hypot(cell_e, cell_n * float(f))
    return dj, di, h, f.numerator, f.denominator, dom_is_j


def shadow_light(dem: torch.Tensor, *, cells_per_deg: int, lat_deg: float,
                 sun_az_deg: float, sun_alt_deg: float, soft_m: float = 2.0,
                 ray_denom_max: int = 16) -> torch.Tensor:
    """Direct-sun visibility of every DEM cell: (n_j, n_i) float32 in
    [0, 1] on the DEM's device, 1 = the cell sees the sun, 0 = fully
    shadowed by terrain.

    Grid conventions match the render pipeline (row 0 = SOUTH, +j north,
    +i east; ``sun_az_deg`` clockwise from north, ``sun_alt_deg`` above
    the horizon). ``soft_m``: blockers within this many meters of grazing
    ramp the light linearly instead of thresholding. A sun at or below the
    horizon returns all zeros. Terrain beyond the DEM edge is absent (no
    blocker)."""
    z = dem.to(torch.float32)
    if z.dim() != 2:
        raise ValueError(f"dem must be 2D, got {tuple(z.shape)}")
    if sun_alt_deg <= 0.0:
        return torch.zeros_like(z)
    nj, ni = z.shape
    cell_n = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    cell_e = cell_n * max(0.05, abs(math.cos(math.radians(lat_deg))))
    tan_alt = math.tan(math.radians(min(sun_alt_deg, 89.9)))
    dj, di, h, p, q, _ = _ray_step(cells_per_deg, lat_deg, sun_az_deg,
                                   ray_denom_max)

    # linear sun-ray ramp: s advances exactly h per step (u = the
    # quantized unit direction, so perpendicular drift cancels)
    u_n, u_e = dj * cell_n / h, di * cell_e / h
    jj = torch.arange(nj, dtype=torch.float32, device=z.device)[:, None]
    ii = torch.arange(ni, dtype=torch.float32, device=z.device)[None, :]
    s = jj * (cell_n * u_n) + ii * (cell_e * u_e)
    g = z - s * tan_alt

    # window [1, q]: q single-level lerped taps of the raw field
    m = _shift_ray(g, dj, di, _NEG)
    for t in range(2, q + 1):
        m = torch.maximum(m, _shift_ray(g, t * dj, t * di, _NEG))
    # doubling over the INTEGER period vector: exact lattice shifts
    vj, vi = round(q * dj), round(q * di)
    assert (abs(vj), abs(vi)) in ((q, abs(p)), (abs(p), q))
    n_dom = nj if abs(vj) == q else ni
    for k in range(max(-(-max(n_dom, 2) // q) - 1, 1).bit_length()):
        m = torch.maximum(m, _shift_int(m, vj << k, vi << k, _NEG))

    # blocker height above the sun ray, in meters, ramped over soft_m
    diff = m - g
    light = 1.0 - diff * recip(max(soft_m, 1e-3))
    return torch.clamp(light, 0.0, 1.0)


def sun_hours(dem: torch.Tensor, *, cells_per_deg: int, lat_deg: float,
              lon_deg: float, date, samples: int = 24,
              soft_m: float = 2.0) -> torch.Tensor:
    """Hours of direct sun per DEM cell over one UTC day: (n_j, n_i)
    float32 in [0, 24] on the DEM's device.

    ``date``: a datetime.date, a datetime or a 'YYYY-MM-DD' string. The
    day is sampled at ``samples`` evenly spaced instants; each daylight
    instant adds shadow_light at its astronomical sun position
    (geometry.sun_position), in the instants' order, and the sum is scaled
    by 24 / samples."""
    if isinstance(date, str):
        d = _date.fromisoformat(date)
    elif isinstance(date, datetime):
        d = date.date()
    else:
        d = date
    z = dem.to(torch.float32)
    acc = torch.zeros_like(z)
    for k in range(samples):
        t = datetime(d.year, d.month, d.day) + _frac_day(k / samples)
        az_deg, alt_deg = geometry.sun_position(lat_deg, lon_deg, t)
        if alt_deg > 0.0:
            acc = acc + shadow_light(
                z, cells_per_deg=cells_per_deg, lat_deg=lat_deg,
                sun_az_deg=az_deg, sun_alt_deg=alt_deg, soft_m=soft_m)
    return acc * (24.0 / samples)


def _frac_day(f: float) -> timedelta:
    return timedelta(seconds=round(f * 86400.0))
