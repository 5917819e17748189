"""Window march: far-field crossing samples, CUDA kernel + plain version.

``march`` launches ``csrc/window_march.cu`` for CUDA tensors and takes
``march_plain`` only for CPU tensors. Both compute, per (column w, step m)
of a square (n, n) DEM:

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


def march_plain(dem: torch.Tensor, pcol: torch.Tensor, fscal: torch.Tensor,
                k: int) -> torch.Tensor:
    """(W, k) float32 samples; the gather form of the kernel's math."""
    n = dem.shape[0]
    a, t, e, scale, axis0, sgn, jdom = (pcol[:, c:c + 1] for c in range(7))
    vz, znear, zfar, curv = fscal
    mf = torch.arange(k, dtype=torch.float32, device=dem.device)[None, :]
    pos = fma32(mf, t, a)
    axis_m = axis0 + mf * sgn
    dm = (mf + e) * scale
    hi = float(n - 1)
    valid = ((axis_m >= 0.0) & (axis_m <= hi) & (pos >= 0.0) & (pos <= hi)
             & (dm >= znear) & (dm <= zfar))
    fl = torch.floor(pos)
    h_lo = torch.clamp(1.0 - torch.abs(pos - fl), min=0.0)
    h_hi = torch.clamp(1.0 - torch.abs(pos - (fl + 1.0)), min=0.0)
    r = fl.clamp(0, n - 1).to(torch.int64)
    ax = axis_m.clamp(0, n - 1).to(torch.int64)
    jd = jdom != 0.0
    i_lo = torch.where(jd, ax * n + r, r * n + ax)
    has_hi = r + 1 < n    # pos == n-1: the upper tap is outside, weight 0
    i_hi = torch.where(has_hi, i_lo + torch.where(jd, 1, n), i_lo)
    flat = dem.reshape(-1)
    z_lo = flat[i_lo]
    z_hi = torch.where(has_hi, flat[i_hi], 0.0)
    z = fma32(h_hi, z_hi, h_lo * z_lo)
    tanel = fma32(-dm, curv, (z - vz) / dm)
    return torch.where(valid, tanel, NEG_BIG)


def march(dem: torch.Tensor, pcol: torch.Tensor, fscal: torch.Tensor,
          k: int) -> torch.Tensor:
    """(W, k) float32 far-field samples of a square (n, n) float32 DEM.

    ``pcol``: (W, 8) float32 per-column geometry (see PCOL_WIDTH);
    ``fscal``: (4,) float32 [viewer z, znear, zfar, curvature]."""
    if dem.device.type == "cpu":
        return march_plain(dem, pcol, fscal, k)
    if dem.device.type != "cuda":
        raise ValueError(f"march: unsupported device {dem.device}")
    n = dem.shape[0]
    w = pcol.shape[0]
    for name, x, shape in (("dem", dem, (n, n)),
                           ("pcol", pcol, (w, PCOL_WIDTH)),
                           ("fscal", fscal, (4,))):
        if (x.device != dem.device or x.dtype != torch.float32
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(f"march: {name} must be a contiguous float32 "
                             f"{shape} tensor on {dem.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    out = torch.empty((w, k), dtype=torch.float32, device=dem.device)
    rc = build.library().hz_window_march(
        dem.data_ptr(), n, pcol.data_ptr(), fscal.data_ptr(), w, k,
        out.data_ptr(), torch.cuda.current_stream(dem.device).cuda_stream)
    if rc:
        raise RuntimeError(f"window march launch failed: CUDA error {rc}")
    march.launches += 1
    return out


march.launches = 0
