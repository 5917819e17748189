"""Projection math on torch tensors (counterpart of horizonator_tpu.geometry).

Conventions are the reference's (vertex.glsl:112-156,
horizonator-lib.c:1055-1213): azimuth 0 = North, 90 deg = East; the
azimuth window [az0, az1] maps to the full viewport width with az1
unwrapped into (az0, az0 + 2 pi].

The render's functions take float32 tensors and keep float32 arithmetic,
in the operations the JAX package's jitted code performs:

- XLA rewrites a division by a compile-time constant into a product with
  the constant's float32 reciprocal; the port writes that product
  (``x * recip(c)``) wherever the JAX package divides by a Python number;
- a Python number that a tensor divides goes through ``const`` first:
  torch computes ``scalar / tensor`` as a reciprocal times the scalar on
  the CPU, which moves the result by an ulp against a true division.

The projection math (``project``, ``pixel_az_el_rad``, ``unproject``) runs
eagerly in the JAX package, on the numbers and numpy arrays of the
annotator and of pick(): their arithmetic stays in float64 until a jnp
function converts it to float32. The port converts at the same points
(``as_f32``), so its results are float32 tensors within an ulp or two of
the JAX package's; ``project``'s x goes through the render's
``x_from_az`` and lands within a few ulps more.
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


def as_f32(x) -> torch.Tensor:
    """x as a float32 tensor: where the JAX package's projection math hands
    a Python number or a numpy array to a jnp function, which converts it
    to float32 (x64 off)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def latlon_to_en(lat, lon, lat_viewer, cos_lat_viewer, lon_viewer):
    """Tangent-plane east/north meters from the viewer (vertex.glsl:128-130).
    Computes in the inputs' own type: float32 for tensors, float64 for
    numpy arrays and Python numbers, as the JAX package does there."""
    east = (lon - lon_viewer) * DEG * EARTH_RADIUS_M * cos_lat_viewer
    north = (lat - lat_viewer) * DEG * EARTH_RADIUS_M
    return east, north


def en_to_latlon(east, north, lat_viewer, cos_lat_viewer, lon_viewer):
    """Inverse of latlon_to_en (horizonator-lib.c:1209-1210)."""
    lon = lon_viewer + east / EARTH_RADIUS_M / DEG / cos_lat_viewer
    lat = lat_viewer + north / EARTH_RADIUS_M / DEG
    return lat, lon


def project(lat_viewer, cos_lat_viewer, lon_viewer, ele_viewer,
            lat, lon, ele, az_rad0, az_rad1, width, height, curv=0.0):
    """Project world points into the panorama: (x, y, range_enh, visible),
    float32 tensors; ``visible`` is |az_ndc| <= 1 and |el_ndc| <= 1
    (horizonator-lib.c:1097-1155). lat/lon/ele may be numbers, numpy
    arrays or tensors; the viewer and window are numbers. ``curv`` must
    match the render's for annotations and picks to line up."""
    east, north = latlon_to_en(lat, lon, lat_viewer, cos_lat_viewer,
                               lon_viewer)
    dist_sq_ne = east * east + north * north
    x, az_ndc, az_ndc_per_rad = x_from_az(
        torch.atan2(as_f32(east), as_f32(north)), as_f32(az_rad0),
        as_f32(az_rad1), width)
    h = ele - ele_viewer
    distance_ne = torch.sqrt(as_f32(dist_sq_ne))
    range_enh = torch.sqrt(as_f32(dist_sq_ne + h * h))
    aspect = width / height
    # apparent elevation: tan el = h/d - d*curv (atan2 keeps d = 0 safe)
    el_ndc = (torch.atan2(as_f32(h - dist_sq_ne * curv), distance_ne)
              * aspect * az_ndc_per_rad)
    y = (-el_ndc + 1.0) / 2.0 * height - 0.5
    visible = (torch.abs(az_ndc) <= 1.0) & (torch.abs(el_ndc) <= 1.0)
    return x, y, range_enh, visible


def pixel_az_el_rad(x, y, az_deg0, az_deg1, width, height):
    """Azimuth/elevation in radians at the CENTER of pixel (x, y), y from
    the top row (horizonator-lib.c:1181-1201), window in degrees.

    The span az1 - az0 is normalized into (0, 360], as the renderer unwraps
    it, so wrapped (350, 10) and over-wound (0, 540) windows map pixels to
    the azimuths that render() drew; a window already in (0, 360] keeps
    az1 bitwise."""
    span0 = az_deg1 - az_deg0
    turns = torch.where(torch.as_tensor(span0 <= 0.0),
                        torch.floor(as_f32(-span0 / 360.0)) + 1.0,
                        -torch.ceil(as_f32(span0 / 360.0)) + 1.0)
    az_deg1 = az_deg1 + 360.0 * turns
    az_ndc = (x + 0.5) / width * 2.0 - 1.0
    az = (as_f32(az_ndc) * (az_deg1 - az_deg0) / 2.0
          + (az_deg1 + az_deg0) / 2.0) * DEG
    el_ndc = 1.0 - (y + 0.5) / height * 2.0   # top row -> +1 side
    aspect = width / height
    el = as_f32(el_ndc) * (az_deg1 - az_deg0) / 2.0 / aspect * DEG
    return az, el


def unproject(x, y, range_enh, range_en,
              lat_viewer, cos_lat_viewer, lon_viewer,
              az_deg0, az_deg1, width, height):
    """Pixel + range -> (lat, lon) float32 tensors
    (horizonator-lib.c:1157-1213): range_en (horizontal) where positive,
    else cos(el) * range_enh (slant)."""
    az, el = pixel_az_el_rad(x, y, az_deg0, az_deg1, width, height)
    range_en = torch.where(as_f32(range_en) > 0, as_f32(range_en),
                           torch.cos(el) * as_f32(range_enh))
    east = range_en * torch.sin(az)
    north = range_en * torch.cos(az)
    return en_to_latlon(east, north, lat_viewer, cos_lat_viewer, lon_viewer)


def sun_position(lat_deg: float, lon_deg: float, when) -> tuple[float, float]:
    """Solar (azimuth_deg cw from north, altitude_deg) at a UTC time, for
    hillshade's ``sun_time=`` (host side): the low-precision NOAA/Meeus
    formulas, good to a few hundredths of a degree over +-2 centuries of
    J2000. ``when``: a datetime (naive = UTC, aware = converted) or an
    ISO-8601 string."""
    from datetime import datetime, timezone

    if isinstance(when, str):
        when = datetime.fromisoformat(when)
    if when.tzinfo is not None:
        when = when.astimezone(timezone.utc).replace(tzinfo=None)
    epoch = datetime(2000, 1, 1, 12, 0, 0)              # J2000.0 (TT~UTC)
    n = (when - epoch).total_seconds() / 86400.0

    L = math.radians((280.460 + 0.9856474 * n) % 360.0)    # mean longitude
    g = math.radians((357.528 + 0.9856003 * n) % 360.0)    # mean anomaly
    lam = (L + math.radians(1.915) * math.sin(g)
           + math.radians(0.020) * math.sin(2 * g))
    eps = math.radians(23.439 - 4.0e-7 * n)                # obliquity
    ra = math.atan2(math.cos(eps) * math.sin(lam), math.cos(lam))
    dec = math.asin(math.sin(eps) * math.sin(lam))

    ut_h = when.hour + when.minute / 60.0 + when.second / 3600.0
    gmst_h = (6.697375 + 0.0657098242 * (n - ut_h / 24.0)
              + 1.00273790935 * ut_h) % 24.0
    lst = math.radians((gmst_h * 15.0 + lon_deg) % 360.0)  # local sidereal
    hour = lst - ra

    lat = math.radians(lat_deg)
    alt = math.asin(math.sin(dec) * math.sin(lat)
                    + math.cos(dec) * math.cos(lat) * math.cos(hour))
    az = math.atan2(-math.sin(hour),
                    math.tan(dec) * math.cos(lat)
                    - math.sin(lat) * math.cos(hour))
    return (math.degrees(az) % 360.0, math.degrees(alt))


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
