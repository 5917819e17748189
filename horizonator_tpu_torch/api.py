"""The user-facing API: the reference's Python extension, on torch.

``horizonator(lat, lon, width, height, ...)`` + ``.render(az_deg0,
az_deg1, ...)`` keep the constructor/render signature and return shapes of
the reference's CPython module (horizonator-pywrap.c:49-125, 158-279):
the constructor loads the DEM window (and, for textured renders, the tile
atlas and its color planes) and puts it on ``device``; render() is the
repeatable path with a movable camera; pick() reads the last render's
range image back to lat/lon, and horizon() gives the per-column horizon
without an image. This port covers the window sampler, untextured,
textured (``render_texture``) and hillshaded; cast shadows, debug fill
modes, region sharding and long-clip LOD renders raise
NotImplementedError.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from . import geometry
from .dem import load_mosaic, RADIUS_CELLS_DEFAULT_PY
from .render import make_params, render_panorama
from .render.crossing import k_cross_for
from .render import texture
from .render.window import march_window

ZNEAR_DEFAULT = 100.0     # horizonator.h:9
ZFAR_DEFAULT = 40000.0    # horizonator.h:10
# the JAX package swaps renders needing more crossing steps than this to its
# LOD march (api.py:648), which is not ported
LOD_SWAP_NSTEPS = 1536


class horizonator:
    """Offscreen SRTM terrain renderer (reference-compatible signature plus
    keyword-only quality knobs). ``device``: where the DEM lives and the
    render runs (default "cuda")."""

    def __init__(self, lat, lon, width, height,
                 render_texture=False, SRTM1=False,
                 dir_dems=None, dir_tiles=None,
                 tiles_name=None, tiles_url_fmt=None,
                 allow_downloads=True,
                 render_radius_cells=-1, render_radius_m=-1.0,
                 *,
                 nsteps=None, surface="bilinear", refine=True,
                 oversample=1.5, sampler="auto", device="cuda",
                 texture_on_error="raise", texture_quality="hybrid",
                 exact_near_m=1200.0, curvature="none",
                 allow_dem_downloads=False, dem_url_fmt=None,
                 hillshade=False, sun_az_deg=315.0, sun_alt_deg=45.0,
                 sun_time=None, shadows=False, strict_coverage=False,
                 region_mesh=None):
        if render_radius_cells < 0 and render_radius_m < 0:
            render_radius_cells = RADIUS_CELLS_DEFAULT_PY
        elif render_radius_cells > 0 and render_radius_m > 0:
            raise ValueError(
                "both render_radius_cells,render_radius_m cannot be >0")
        if hillshade and render_texture:
            raise ValueError(
                "hillshade and render_texture are mutually exclusive")
        if shadows and not hillshade:
            raise ValueError("shadows=True requires hillshade=True")
        if shadows:
            raise NotImplementedError("shadows need ops/shadows, which is "
                                      "not ported")
        if texture_quality not in ("grid", "grid2x", "hybrid", "exact"):
            raise ValueError(f"unknown texture_quality {texture_quality!r}")
        if region_mesh is not None:
            raise NotImplementedError("region_mesh is not ported")
        if allow_dem_downloads:
            raise NotImplementedError("DEM downloads are not ported")
        if sampler not in ("auto", "window"):
            raise NotImplementedError(f"sampler={sampler!r} is not ported; "
                                      "only 'window' is")
        if surface != "bilinear":
            raise NotImplementedError(
                f"surface={surface!r} needs the uniform-step sampler, which "
                "is not ported")

        self.width = int(width)
        self.height = int(height)
        self.curvature = curvature
        self._curv = geometry.curvature_coeff(curvature)
        self.surface = surface
        self.refine = bool(refine)
        # the uniform-step sampler's steps per cell; stored as the JAX
        # package stores it, unused by the window sampler
        self.oversample = float(oversample)
        self._nsteps_fixed = nsteps
        self.device = torch.device(device)
        self.mosaic = load_mosaic(
            lat, lon,
            render_radius_cells=render_radius_cells,
            render_radius_m=render_radius_m,
            datadir=dir_dems, srtm1=SRTM1, dem_url_fmt=dem_url_fmt)
        self._dem = torch.from_numpy(
            self.mosaic.grid.astype(np.float32)).to(self.device)
        n = self.mosaic.grid.shape[0]
        cpd = self.mosaic.cells_per_deg

        self.render_texture = bool(render_texture)
        self._atlas = None
        self._atlas_params = None
        self._color_planes = None
        if render_texture:
            from .tiles import build_atlas
            atlas, ap = build_atlas(
                lat, lon, self.mosaic.radius_cells, cpd,
                self.mosaic.origin_cell_lon_deg,
                self.mosaic.origin_cell_lat_deg,
                dir_tiles=dir_tiles, tiles_name=tiles_name,
                tiles_url_fmt=tiles_url_fmt, allow_downloads=allow_downloads,
                on_error=texture_on_error)
            # one int32 per texel, packed once per scene
            self._atlas = texture.pack_atlas(
                torch.from_numpy(atlas).to(self.device))
            self._atlas_params = ap
            if texture_quality != "exact":
                # colors resampled onto the DEM grid once and sampled in
                # the march: "grid" at cell resolution, "grid2x" and
                # "hybrid" at half-cell; "hybrid" also swaps in atlas-true
                # z12 texels nearer than exact_near_m. "exact" gathers the
                # atlas per pixel instead.
                scale = 1 if texture_quality == "grid" else 2
                self._put_color_planes(texture.atlas_to_grid_colors(
                    self._atlas, ap, n, cpd, scale=scale), scale)
        self._exact_near_m = (float(exact_near_m)
                              if render_texture and exact_near_m
                              and texture_quality == "hybrid" else None)

        self.hillshade = bool(hillshade)
        if hillshade:
            # Lambertian sun shading from the DEM itself, through the same
            # textured path (the gray planes stand in for map colors)
            if sun_time is not None:
                sun_az_deg, sun_alt_deg = geometry.sun_position(
                    lat, lon, sun_time)
            self.sun_az_deg, self.sun_alt_deg = sun_az_deg, sun_alt_deg
            scale = 2 if texture_quality == "grid2x" else 1
            self._put_color_planes(texture.hillshade_planes(
                self._dem, cpd, lat, sun_az_deg=sun_az_deg,
                sun_alt_deg=sun_alt_deg, scale=scale), scale)
            self.render_texture = True   # drives the textured render path

        self.viewer_lat = float(lat)
        self.viewer_lon = float(lon)
        self.viewer_z = self.mosaic.auto_viewer_z(lat, lon)
        self.strict_coverage = bool(strict_coverage)
        self._last = None    # the last render's ranges and window, for pick()

    def _put_color_planes(self, planes, scale):
        """Half-cell planes are packed once per scene (ColorPlanes2x);
        cell-resolution float planes stay as they are (the march packs them
        for the kernel and samples them unpacked in the near band, as the
        JAX package does)."""
        self._color_planes = (texture.prepare_color_planes(planes)
                              if scale == 2 else planes)

    # -- coverage guard -----------------------------------------------------

    def _check_dropped(self, guard, what="render"):
        """Warn (raise under strict_coverage) when the march reports
        ``dropped`` near-band samples outside the static patch or
        ``truncated`` columns whose march stopped short of zfar/the grid
        edge (a manual nsteps= below k_cross_for's budget)."""
        n_drop, n_trunc = guard.tolist()
        if not (n_drop or n_trunc):
            return
        parts = []
        if n_drop:
            parts.append(
                f"{n_drop} march samples exceeded the static window/patch "
                f"and were masked (undersized lat_hint_deg/znear_hint_m "
                f"for this scene)")
        if n_trunc:
            parts.append(
                f"{n_trunc} image columns stopped marching short of zfar/"
                f"the grid edge, so their far samples were masked (manual "
                f"nsteps= below k_cross_for's latitude-scaled budget -- "
                f"raise nsteps or drop the override)")
        msg = (f"{what}(): " + "; ".join(parts)
               + " -- horizons may be silently low.")
        if self.strict_coverage:
            raise RuntimeError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)

    def resized(self, width, height):
        """Change the output viewport (horizonator_resized,
        horizonator-lib.c:838-856); the DEM stays on the device."""
        self.width = int(width)
        self.height = int(height)

    @property
    def cell_m_north(self) -> float:
        return (geometry.EARTH_RADIUS_M * math.pi / 180.0
                / self.mosaic.cells_per_deg)

    # -- static hints ---------------------------------------------------------

    def _lat_hint(self):
        # 10-degree buckets, as the JAX package's static hint
        return round(self.viewer_lat / 10.0) * 10.0

    @staticmethod
    def _znear_hint(znear):
        """znear rounded UP to a power of two (floor 128): sizes the static
        near patch; a larger hint only grows it."""
        return float(max(128.0, 2.0 ** math.ceil(math.log2(max(znear, 1.0)))))

    def _params(self, az_deg0, az_deg1, znear, zfar, znear_color,
                zfar_color):
        ci, cj = self.mosaic.viewer_cell(self.viewer_lat, self.viewer_lon)
        return make_params(
            device=self.device,
            viewer_cell_i=ci, viewer_cell_j=cj, viewer_z=self.viewer_z,
            cos_viewer_lat=math.cos(math.radians(self.viewer_lat)),
            az_rad0=math.radians(az_deg0), az_rad1=math.radians(az_deg1),
            znear=znear, zfar=zfar, znear_color=znear_color,
            zfar_color=zfar_color, curv=self._curv)

    def _auto_nsteps(self, znear, zfar):
        if self._nsteps_fixed is not None:
            return int(self._nsteps_fixed)
        return k_cross_for(zfar, self.mosaic.cells_per_deg, self.viewer_lat,
                           n=self.mosaic.grid.shape[0])

    # -- the main entry point -------------------------------------------------

    def render(self, az_deg0, az_deg1, lat=None, lon=None,
               return_image=True, return_range=True,
               az_extents_use_pixel_centers=False,
               znear=ZNEAR_DEFAULT, zfar=ZFAR_DEFAULT,
               znear_color=-1.0, zfar_color=-1.0,
               *, ele_m=None, debug_fill=None):
        """Render; same contract as the reference render()
        (horizonator-pywrap.c:158-279). Returns (image, ranges) as numpy
        arrays, or one of them, or () if neither is asked for. image:
        (H, W, 3) uint8 BGR top-row-first; ranges: (H, W) float32 slant
        meters, invisible = -1. ``debug_fill`` (the lattice debug views) is
        not ported."""
        if debug_fill is not None:
            raise NotImplementedError("debug_fill is not ported")
        if znear_color < 0.0:
            znear_color = znear
        if zfar_color < 0.0:
            zfar_color = zfar
        if not return_image and not return_range:
            return ()

        az_deg0 = float(az_deg0)
        az_deg1 = float(az_deg1)
        if az_extents_use_pixel_centers:
            az_per_pixel = (az_deg1 - az_deg0) / (self.width - 1)
            az_deg0 -= az_per_pixel / 2.0
            az_deg1 += az_per_pixel / 2.0

        if lat is not None and lat > -1000.0:
            if lon is None:
                raise ValueError("lat given without lon")
            self.viewer_lat = float(lat)
            self.viewer_lon = float(lon)
            self.viewer_z = (float(ele_m) if ele_m is not None
                             else self.mosaic.auto_viewer_z(lat, lon))
        elif ele_m is not None:
            self.viewer_z = float(ele_m)

        nsteps = self._auto_nsteps(znear, zfar)
        if nsteps > LOD_SWAP_NSTEPS:
            raise NotImplementedError(
                f"this render needs {nsteps} crossing steps; the JAX package "
                f"renders it with the LOD march, which is not ported "
                f"(shorten zfar or pass nsteps<={LOD_SWAP_NSTEPS})")
        params = self._params(az_deg0, az_deg1, znear, zfar, znear_color,
                              zfar_color)
        image, ranges, guard = render_panorama(
            self._dem, params, width=self.width, height=self.height,
            nsteps=nsteps, cells_per_deg=self.mosaic.cells_per_deg,
            surface=self.surface, refine=self.refine,
            textured=self.render_texture, atlas=self._atlas,
            atlas_params=self._atlas_params,
            lat_hint_deg=self._lat_hint(),
            color_planes=self._color_planes,
            znear_hint_m=self._znear_hint(znear), with_dropped=True,
            exact_near_m=self._exact_near_m)
        # pick() reads the ranges; the host copy is made only when asked for
        ranges_np = ranges.cpu().numpy() if return_range else None
        self._last = dict(ranges=ranges_np, ranges_dev=ranges,
                          az_deg0=az_deg0, az_deg1=az_deg1,
                          lat=self.viewer_lat, lon=self.viewer_lon)
        out = []
        if return_image:
            out.append(image.cpu().numpy())
        if return_range:
            out.append(ranges_np)
        self._check_dropped(guard)
        return tuple(out) if len(out) > 1 else out[0]

    def _last_ranges(self):
        """Host copy of the last render's range image (made on first use)."""
        last = self._last
        if last["ranges"] is None:
            last["ranges"] = last["ranges_dev"].cpu().numpy()
        return last["ranges"]

    def pick(self, x, y):
        """Pixel of the last render -> (lat, lon), or None for sky
        (horizonator-lib.c:1216-1296, reading the range image instead of the
        GL depth buffer)."""
        if self._last is None:
            raise RuntimeError("pick() before render()")
        last = self._last
        r = self._last_ranges()[int(y), int(x)]
        if r <= 0:
            return None
        lat, lon = geometry.unproject(
            float(x), float(y), float(r), -1.0,
            last["lat"], math.cos(math.radians(last["lat"])), last["lon"],
            last["az_deg0"], last["az_deg1"], self.width, self.height)
        return float(lat), float(lon)

    def horizon(self, az_deg0, az_deg1, *, width=None,
                znear=ZNEAR_DEFAULT, zfar=ZFAR_DEFAULT):
        """Per-column horizon (az_rad, tan_el) as numpy float32 arrays,
        without an image: the window march and a plain max over each
        column's samples. It marches the full crossing budget at any zfar
        (no LOD swap, as in the JAX package)."""
        width = self.width if width is None else int(width)
        params = self._params(float(az_deg0), float(az_deg1), znear, zfar,
                              znear, zfar)
        tanel, _, dists, az = march_window(
            self._dem, params, width=width,
            k_cross=self._auto_nsteps(znear, zfar),
            cells_per_deg=self.mosaic.cells_per_deg,
            lat_hint_deg=self._lat_hint(),
            znear_hint_m=self._znear_hint(znear))
        out = az.cpu().numpy(), tanel.max(dim=1).values.cpu().numpy()
        self._check_dropped(torch.stack([dists.dropped, dists.truncated]),
                            "horizon")
        return out

    def __str__(self):
        return f"Looking out from {self.viewer_lat:.4f},{self.viewer_lon:.4f}"

    __repr__ = __str__
