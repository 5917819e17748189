"""Projection math on torch tensors (counterpart of horizonator_tpu.geometry).

Conventions are the reference's (vertex.glsl:112-156,
horizonator-lib.c:1055-1213): azimuth 0 = North, 90 deg = East; the
azimuth window [az0, az1] maps to the full viewport width with az1
unwrapped into (az0, az0 + 2 pi].

Every function takes float32 tensors and keeps float32 arithmetic, in the
operations the JAX package's jitted code performs:

- XLA rewrites a division by a compile-time constant into a product with
  the constant's float32 reciprocal; the port writes that product
  (``x * recip(c)``) wherever the JAX package divides by a Python number;
- a Python number that a tensor divides goes through ``const`` first:
  torch computes ``scalar / tensor`` as a reciprocal times the scalar on
  the CPU, which moves the result by an ulp against a true division.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EARTH_RADIUS_M = 6371000.0   # vertex.glsl:30
DEG = math.pi / 180.0
REFRACTION_K_STD = 0.13       # standard terrestrial refraction coefficient


def const(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d float32 tensor on ``like``'s device (filled there, so
    no host-to-device copy stalls the host)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def recip(c: float) -> float:
    """float32 1/c of float32 c: what XLA multiplies by for ``x / c``."""
    return float(np.float32(1.0) / np.float32(c))


def unwrap_near_rad(x: torch.Tensor, near) -> torch.Tensor:
    """Unwrap angle x to lie within pi of ``near`` (vertex.glsl:34-38)."""
    d = (x - near) * recip(2.0 * math.pi)
    return (d - torch.round(d)) * 2.0 * math.pi + near


def az_window_rad(az_rad0: torch.Tensor, az_rad1: torch.Tensor):
    """Normalize the azimuth window: az1 unwrapped to (az0, az0+2pi], plus
    the center and the ndc scale (horizonator-lib.c:1075-1083)."""
    az_rad1 = unwrap_near_rad(az_rad1 - az_rad0, math.pi) + az_rad0
    # az1 == az0 means a FULL circle: torch.round, like jnp.round, rounds
    # half to even, which lands the unwrap on az0 rather than az0 + 2 pi
    # (C roundf's choice); patch only that degenerate case.
    az_rad1 = torch.where(az_rad1 <= az_rad0, az_rad0 + 2.0 * math.pi,
                          az_rad1)
    az_center = (az_rad0 + az_rad1) * 0.5
    az_ndc_per_rad = const(2.0, az_rad0) / (az_rad1 - az_rad0)
    return az_rad1, az_center, az_ndc_per_rad


def x_from_az(az_rad, az_rad0, az_rad1, width: int):
    """Map azimuth -> pixel x. Returns (x, az_ndc, az_ndc_per_rad); the
    caller checks |az_ndc| <= 1 for visibility
    (horizonator-lib.c:1062-1095)."""
    _, az_center, az_ndc_per_rad = az_window_rad(az_rad0, az_rad1)
    az = unwrap_near_rad(az_rad, az_center)
    az_ndc = (az - az_center) * az_ndc_per_rad
    x = (az_ndc + 1.0) * 0.5 * width - 0.5
    return x, az_ndc, az_ndc_per_rad


def curvature_coeff(mode) -> float:
    """Apparent-elevation drop rate 1/(2 R_effective) in 1/m.

    'none' (or None/0): the reference's flat tangent plane. 'spherical':
    1/(2R). 'refracted': (1 - k)/(2R) with k = 0.13. A number passes
    through as an explicit coefficient."""
    if mode in (None, "none", 0, 0.0, False):
        return 0.0
    if mode == "spherical":
        return 1.0 / (2.0 * EARTH_RADIUS_M)
    if mode == "refracted":
        return (1.0 - REFRACTION_K_STD) / (2.0 * EARTH_RADIUS_M)
    if isinstance(mode, str):
        raise ValueError(
            f"unknown curvature mode {mode!r}: expected 'none', 'spherical', "
            "'refracted', or a numeric coefficient in 1/m")
    return float(mode)
