"""The user-facing API: the reference's Python extension, on torch.

``horizonator(lat, lon, width, height, ...)`` + ``.render(az_deg0,
az_deg1, ...)`` keep the constructor/render signature and return shapes of
the reference's CPython module (horizonator-pywrap.c:49-125, 158-279):
the constructor loads the DEM window (and, for textured renders, the tile
atlas and its color planes) and puts it on ``device``; render() is the
repeatable path with a movable camera; pick() reads the last render's
range image back to lat/lon, and horizon() gives the per-column horizon
without an image, and skyline() the geolocated horizon ridgeline;
render_batch() renders many viewpoints in one pass; intervisible(),
sightline() and visible_peaks() answer line-of-sight questions on the
loaded DEM. ``sampler`` picks the march: "window" (the kernel path:
untextured, textured (``render_texture``) and hillshaded (with cast
``shadows``), the debug lattice views (``debug_fill``), and the LOD march
that long clip ranges swap to), or the JAX package's oracles "crossing"
(grid crossings) and "step" (uniform steps, the one that samples the
reference's ``surface="triangulated"`` mesh); "auto" is "window" on the
bilinear surface and "step" on the triangulated one. Every sampler ends in
the resolve kernel. ``allow_dem_downloads`` fetches missing .hgt tiles
from ``dem_url_fmt`` (SRTM1 defaults to DEM_URL_FMT_SRTM1) into
``dir_dems``.

Scale-out: ``region_mesh`` ("auto", a rank count or a DeviceMesh with a
"region" dim, parallel.mesh) splits the DEM into row bands over the mesh's
ranks, each holding only its band, and render(), horizon() and
render_batch() run through parallel.regions, bitwise the unsharded
render; ``render_batch(mesh=)`` shards a batch over ranks. Several ranks
are one process each (torchrun); "auto" on one process makes a one-rank
group.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from . import geometry, profiling
from .dem import load_mosaic, RADIUS_CELLS_DEFAULT_PY
from .render import lod, make_params, render_panorama
from .render.crossing import k_cross_for, march_crossing, pack_scene
from .render import texture
from .render.raymarch import horizon_profile, pack_dem_pairs
from .render.window import march_window

ZNEAR_DEFAULT = 100.0     # horizonator.h:9
ZFAR_DEFAULT = 40000.0    # horizonator.h:10
# render() swaps renders needing more crossing steps than this to the LOD
# march, as the JAX package does (api.py:648)
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
        if texture_quality not in ("grid", "grid2x", "hybrid", "exact"):
            raise ValueError(f"unknown texture_quality {texture_quality!r}")
        if surface not in ("bilinear", "triangulated"):
            raise ValueError(f"unknown surface mode {surface!r}")
        if sampler == "auto":
            # the triangulated surface needs the uniform-step sampler's
            # sub-cell evaluation (api.py:100-102)
            sampler = "window" if surface == "bilinear" else "step"
        if sampler == "lod":
            # the JAX constructor packs pair planes for 'lod' and then
            # marches them as elevations through the window path
            raise ValueError(
                "sampler='lod' is not a scene sampler: the LOD march is what "
                "the window sampler swaps to for long clip ranges; pass "
                "'window' or 'auto'")
        if sampler not in ("window", "crossing", "step"):
            raise ValueError(f"unknown sampler {sampler!r}")
        if hillshade and sampler != "window":
            raise ValueError("hillshade requires sampler='window'")
        if region_mesh is not None and sampler != "window":
            raise ValueError("region_mesh requires the 'window' sampler")
        self.sampler = sampler
        # region_mesh: the grid and its colour planes are placed band by
        # band in _init_region, never whole on the device
        self._region = None
        self._region_pending = region_mesh

        self.width = int(width)
        self.height = int(height)
        self.curvature = curvature
        self._curv = geometry.curvature_coeff(curvature)
        self.surface = surface
        self.refine = bool(refine)
        # the uniform-step sampler's steps per cell (_auto_nsteps)
        self.oversample = float(oversample)
        self._nsteps_fixed = nsteps
        self.device = torch.device(device)
        if allow_dem_downloads and dem_url_fmt is None:
            if not SRTM1:
                raise ValueError(
                    "allow_dem_downloads needs dem_url_fmt for SRTM3 (no "
                    "canonical free mirror of raw 1201^2 .hgt exists); "
                    "SRTM1 defaults to the AWS terrain-tiles skadi bucket")
            from .dem.mosaic import DEM_URL_FMT_SRTM1
            dem_url_fmt = DEM_URL_FMT_SRTM1
        self.mosaic = load_mosaic(
            lat, lon,
            render_radius_cells=render_radius_cells,
            render_radius_m=render_radius_m,
            datadir=dir_dems, srtm1=SRTM1,
            dem_url_fmt=dem_url_fmt if allow_dem_downloads else None)
        self._dem = (torch.from_numpy(self.mosaic.grid.astype(np.float32))
                     .to(self.device) if region_mesh is None else None)
        n = self.mosaic.grid.shape[0]
        cpd = self.mosaic.cells_per_deg
        # the sampler's scene: the grid for the window march, a
        # CrossingScene or the pair-packed plane for the oracles
        self._scene = (pack_scene(self._dem) if sampler == "crossing" else
                       pack_dem_pairs(self._dem) if sampler == "step" else
                       self._dem)

        self.render_texture = bool(render_texture)
        self._atlas = None
        self._atlas_params = None
        self._color_planes = None
        if render_texture:
            from .tiles import build_atlas
            with profiling.phase("hz.tiles.atlas"):
                atlas, ap = build_atlas(
                    lat, lon, self.mosaic.radius_cells, cpd,
                    self.mosaic.origin_cell_lon_deg,
                    self.mosaic.origin_cell_lat_deg,
                    dir_tiles=dir_tiles, tiles_name=tiles_name,
                    tiles_url_fmt=tiles_url_fmt,
                    allow_downloads=allow_downloads,
                    on_error=texture_on_error)
            # one int32 per texel, packed once per scene
            self._atlas = texture.pack_atlas(
                torch.from_numpy(atlas).to(self.device))
            self._atlas_params = ap
            if texture_quality != "exact" and sampler == "window":
                # colors resampled onto the DEM grid once and sampled in
                # the march: "grid" at cell resolution, "grid2x" and
                # "hybrid" at half-cell; "hybrid" also swaps in atlas-true
                # z12 texels nearer than exact_near_m. "exact" and the
                # oracle samplers gather the atlas per pixel instead.
                scale = 1 if texture_quality == "grid" else 2
                with profiling.phase("hz.texture.planes"):
                    self._put_color_planes(texture.atlas_to_grid_colors(
                        self._atlas, ap, n, cpd, scale=scale), scale)
        self._exact_near_m = (float(exact_near_m)
                              if render_texture and exact_near_m
                              and texture_quality == "hybrid" else None)

        self.hillshade = bool(hillshade)
        if hillshade:
            # Lambertian sun shading from the DEM itself, through the same
            # textured path (the gray planes stand in for map colors);
            # shadows: the direct term times ops/shadows' cast-shadow light
            if sun_time is not None:
                sun_az_deg, sun_alt_deg = geometry.sun_position(
                    lat, lon, sun_time)
            self.sun_az_deg, self.sun_alt_deg = sun_az_deg, sun_alt_deg
            scale = 2 if texture_quality == "grid2x" else 1
            # (a region instance's grid comes to the device for this once,
            # as the JAX package's hillshade_planes takes it)
            dem = (self._dem if self._dem is not None else torch.from_numpy(
                self.mosaic.grid.astype(np.float32)).to(self.device))
            self._put_color_planes(texture.hillshade_planes(
                dem, cpd, lat, sun_az_deg=sun_az_deg,
                sun_alt_deg=sun_alt_deg, scale=scale,
                cast_shadows=bool(shadows)), scale)
            self.render_texture = True   # drives the textured render path

        self.viewer_lat = float(lat)
        self.viewer_lon = float(lon)
        self.viewer_z = self.mosaic.auto_viewer_z(lat, lon)
        self.strict_coverage = bool(strict_coverage)
        self._last = None    # the last render's ranges and window, for pick()
        # the LOD mip chains, built on the first render that swaps to LOD
        self._pyramid = None
        self._color_pyramid = None
        self._debug_cp = None           # (mode, lattice planes)
        self._los_packed = None         # the pair-packed DEM for LOS
        self._skyline_scene = None      # the oracles' skyline march scene
        self._warned_lod_hybrid = False
        if region_mesh is not None:
            self._init_region(region_mesh)

    def _put_color_planes(self, planes, scale):
        """Half-cell planes are packed once per scene (ColorPlanes2x);
        cell-resolution float planes stay as they are (the march packs them
        for the kernel and samples them unpacked in the near band, as the
        JAX package does). A region instance keeps them on the host, for
        _init_region to place band by band."""
        planes = texture.prepare_color_planes(planes) if scale == 2 else planes
        if self._region_pending is not None:
            self._color_scale = scale
            planes = (planes.full_packed if scale == 2 else planes).cpu(
                ).numpy()
        self._color_planes = planes

    def _init_region(self, region_mesh):
        """Row bands of the grid over the mesh's "region" dim (api.py:
        220-285): the grid zero-padded to a band multiple (the padding
        masked through n_valid_rows), each rank's band and colour band
        copied to its device from the host and given its halo once (the
        scene does not change), the z12 atlas (the hybrid near field's)
        replicated."""
        from .parallel.mesh import coord, dim_size, resolve_mesh
        from .parallel.regions import band_of, exchange_halo
        mesh = resolve_mesh(region_mesh, ("region",), self.device)
        r, idx = dim_size(mesh, "region"), coord(mesh, "region")
        n = self.mosaic.grid.shape[0]
        n_pad = -(-n // r) * r
        grid = np.pad(self.mosaic.grid.astype(np.float32),
                      ((0, n_pad - n), (0, 0)))
        colors, tex_scale = None, 0
        if self._color_planes is not None:
            s = tex_scale = self._color_scale
            planes = np.pad(self._color_planes,
                            [(0, 0)] * (self._color_planes.ndim - 2)
                            + [(0, s * (n_pad - n)), (0, 0)])
            colors = band_of(planes, idx, r, self.device, scale=s)
            if s == 2:
                colors = texture.ColorPlanes2x(colors)
        atlas = (self._atlas if self._exact_near_m is not None
                 and tex_scale == 2 else None)
        band = band_of(grid, idx, r, self.device)
        if colors is None:
            band, = exchange_halo([band], mesh)
        else:
            band, colors = exchange_halo([band, colors], mesh)
        self._region = dict(mesh=mesh, r=r, n_valid=n, colors=colors,
                            band=band, tex_scale=tex_scale, atlas=atlas,
                            fns={})

    def _render_region(self, params, znear, zfar):
        """render() through the region renderer, one per static config
        (api.py:287-312); returns (image, ranges, guard)."""
        from .parallel.regions import make_region_sharded_renderer
        R = self._region
        nsteps = self._auto_nsteps(znear, zfar)
        key = ("render", self.width, self.height, nsteps, self._lat_hint())
        if key not in R["fns"]:
            R["fns"][key] = make_region_sharded_renderer(
                R["mesh"], width=self.width, height=self.height,
                k_cross=nsteps, cells_per_deg=self.mosaic.cells_per_deg,
                refine=self.refine, lat_hint_deg=self._lat_hint(),
                textured=R["tex_scale"] > 0,
                texture_scale=max(R["tex_scale"], 1),
                n_valid_rows=R["n_valid"],
                atlas_params=(self._atlas_params if R["atlas"] is not None
                              else None),
                exact_near_m=(self._exact_near_m if R["atlas"] is not None
                              else None),
                with_guard=True)
        fn = R["fns"][key]
        return fn.run(R["band"], params, R["colors"], R["atlas"])

    # -- coverage guard -----------------------------------------------------

    def _check_dropped(self, guard, what="render", sampler="window"):
        """Warn (raise under strict_coverage) when the march reports
        ``dropped`` near-band samples outside the static patch or
        ``truncated`` columns whose march stopped short of zfar/the grid
        edge (a manual nsteps= below k_cross_for's budget; under the LOD
        march, a plan or crop sized for a lat_hint_deg below the viewer's
        latitude). A (B, 2) guard is a batch's: one host copy, the counts
        summed, the viewpoints at fault named by index."""
        with profiling.sync():
            counts = guard.tolist()
        counts = np.asarray(counts, dtype=np.int64).reshape(-1, 2)
        bad = np.flatnonzero(counts.any(axis=1))
        if not len(bad):
            return
        n_drop, n_trunc = (int(v) for v in counts.sum(axis=0))
        parts = []
        if n_drop:
            parts.append(
                f"{n_drop} march samples exceeded the static window/patch "
                f"and were masked (undersized lat_hint_deg/znear_hint_m "
                f"for this scene)")
        if n_trunc and sampler == "lod":
            parts.append(
                f"{n_trunc} image columns stopped marching short of their "
                f"LOD bands, so their far samples were masked (lod_plan "
                f"budgets and level crops sized for a lat_hint_deg below "
                f"the viewer's latitude)")
        elif n_trunc:
            parts.append(
                f"{n_trunc} image columns stopped marching short of zfar/"
                f"the grid edge, so their far samples were masked (manual "
                f"nsteps= below k_cross_for's latitude-scaled budget -- "
                f"raise nsteps or drop the override)")
        where = (f" (viewpoints {bad.tolist()} of {len(counts)})"
                 if guard.dim() == 2 else "")
        msg = (f"{what}(){where}: " + "; ".join(parts)
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

    def _lat_plan_hint(self):
        # the LOD plan's step budgets scale with 1/cell_e(lat): the
        # bucket's worst-case |lat| can only over-budget them, and keeps
        # the plan the same while the viewer stays in its bucket
        return min(abs(self._lat_hint()) + 5.0, 85.0)

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
        if self.sampler != "step":
            return k_cross_for(zfar, self.mosaic.cells_per_deg,
                               self.viewer_lat, n=self.mosaic.grid.shape[0])
        # uniform steps at <= cell/oversample spacing, a multiple of 256
        # (api.py:398-405)
        n = (zfar - znear) / self.cell_m_north * self.oversample
        return max(256, min(8192, -(-int(math.ceil(n)) // 256) * 256))

    def _batch_render_plan(self, znear, zfar):
        """(dem, sampler, nsteps, lod_plan, color_planes): renders that
        need more than LOD_SWAP_NSTEPS crossing steps (e.g. SRTM1 at the
        default 40 km) swap to the LOD march, whose step count grows with
        log(zfar). Its DEM and colour mip chains are built on the first
        such render and kept on the device; textured and hillshade renders
        march their colour pyramid (api.py:635-669)."""
        nsteps = self._auto_nsteps(znear, zfar)
        if self.sampler != "window":
            return self._scene, self.sampler, nsteps, None, None
        cp = self._color_planes
        if nsteps <= LOD_SWAP_NSTEPS:
            return self._dem, "window", nsteps, None, cp
        n = self.mosaic.grid.shape[0]
        plan = lod.lod_plan(zfar, self.width, self.mosaic.cells_per_deg,
                            self._lat_plan_hint(), n)
        nlev = 1 + max(s.level for s in plan)
        if self._pyramid is None or len(self._pyramid) < nlev:
            self._pyramid = lod.build_pyramid(self._dem, nlev)
        if cp is not None:
            if self._color_pyramid is None or len(self._color_pyramid) < nlev:
                self._color_pyramid = lod.build_color_pyramid(cp, nlev, n)
            cp = self._color_pyramid
        return self._pyramid, "lod", nsteps, plan, cp

    def _render_plan(self, znear, zfar, what):
        """_batch_render_plan plus the hybrid near field's exact_near_m:
        the LOD march has none, as in the JAX package (api.py:570), which
        drops it without a word; here the drop warns once per instance."""
        dem, sampler, nsteps, plan, cp = self._batch_render_plan(znear, zfar)
        exact_near = self._exact_near_m if sampler in ("window",
                                                        "lod") else None
        if sampler == "lod" and exact_near is not None:
            exact_near = None
            if not self._warned_lod_hybrid:
                self._warned_lod_hybrid = True
                warnings.warn(
                    f"{what}(): this clip range needs {nsteps} crossing "
                    f"steps, so it renders through the LOD march, which has "
                    f"no hybrid near field: near colors come from the "
                    f"half-cell planes, not the z12 atlas (shorten zfar for "
                    f"atlas-true near texels)", RuntimeWarning, stacklevel=3)
        return dem, sampler, nsteps, plan, cp, exact_near

    _DEBUG_FILL_PITCH = 4

    def _debug_planes(self, mode):
        """(3, n, n) float32 B/G/R cell planes that draw the DEM lattice,
        the reference's GLUT wireframe/point fill modes (standalone.c:
        68-97): bright green grid lines ('wireframe') or nodes ('point')
        every _DEBUG_FILL_PITCH cells over dark terrain, through the
        textured path (api.py:456-486). Cached per mode."""
        if mode not in ("wireframe", "point"):
            raise ValueError(
                f"debug_fill must be 'wireframe' or 'point', got {mode!r}")
        if self._debug_cp is not None and self._debug_cp[0] == mode:
            return self._debug_cp[1]
        nj, ni = self._dem.shape
        pitch = self._DEBUG_FILL_PITCH
        jj = (np.arange(nj) % pitch) == 0
        ii = (np.arange(ni) % pitch) == 0
        on = (jj[:, None] | ii[None, :] if mode == "wireframe"
              else jj[:, None] & ii[None, :])
        base = np.full((nj, ni), 40.0, np.float32)
        g = np.where(on, 255.0, base).astype(np.float32)
        b = np.where(on, 0.0, base).astype(np.float32)
        planes = torch.from_numpy(np.stack([b, g, b])).to(self.device)
        self._debug_cp = (mode, planes)
        return planes

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
        meters, invisible = -1. ``debug_fill``: 'wireframe' or 'point'
        renders the DEM lattice in place of the scene's colors (see
        _debug_planes); window sampler only."""
        with profiling.phase("hz.api.render"):
            profiling.count("hz.viewpoints")
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

            if self._region is not None:
                if debug_fill is not None:
                    raise NotImplementedError(
                        "debug_fill is not supported on region_mesh instances "
                        "(the debug lattice planes are not region-sharded); "
                        "construct an unsharded horizonator for debug views")
                with profiling.phase("hz.api.plan"):
                    params = self._params(az_deg0, az_deg1, znear, zfar,
                                          znear_color, zfar_color)
                image, ranges, guard = self._render_region(params, znear, zfar)
                return self._finish_render(image, ranges, guard, "window",
                                           az_deg0, az_deg1, return_image,
                                           return_range)
            with profiling.phase("hz.api.plan"):
                dem, sampler, nsteps, plan, cp, exact_near = self._render_plan(
                    znear, zfar, "render")
                params = self._params(az_deg0, az_deg1, znear, zfar,
                                      znear_color, zfar_color)
            textured = self.render_texture
            atlas, atlas_params = self._atlas, self._atlas_params
            if debug_fill is not None:
                if sampler != "window":
                    raise ValueError(
                        f"debug_fill requires the window sampler (this "
                        f"render planned sampler={sampler!r}: an oracle "
                        f"sampler, or the auto-LOD long-clip swap, which a "
                        f"shorter zfar avoids)")
                cp = self._debug_planes(debug_fill)
                textured, atlas, atlas_params = True, None, None
                exact_near = None
            image, ranges, guard = render_panorama(
                dem, params, width=self.width, height=self.height,
                nsteps=nsteps, cells_per_deg=self.mosaic.cells_per_deg,
                surface=self.surface, refine=self.refine, textured=textured,
                atlas=atlas, atlas_params=atlas_params, sampler=sampler,
                lat_hint_deg=self._lat_hint(), lod_plan=plan, color_planes=cp,
                znear_hint_m=self._znear_hint(znear), with_dropped=True,
                exact_near_m=exact_near)
            return self._finish_render(image, ranges, guard, sampler, az_deg0,
                                       az_deg1, return_image, return_range)

    def _finish_render(self, image, ranges, guard, sampler, az_deg0,
                       az_deg1, return_image, return_range):
        # pick() reads the ranges; the host copy is made only when asked for
        with profiling.phase("hz.api.readback"):
            ranges_np = None
            if return_range:
                with profiling.sync():
                    ranges_np = ranges.cpu().numpy()
            out = []
            if return_image:
                with profiling.sync():
                    out.append(image.cpu().numpy())
            if return_range:
                out.append(ranges_np)
        self._last = dict(ranges=ranges_np, ranges_dev=ranges,
                          az_deg0=az_deg0, az_deg1=az_deg1,
                          lat=self.viewer_lat, lon=self.viewer_lon)
        with profiling.phase("hz.api.guard"):
            self._check_dropped(guard, sampler=sampler)
        return tuple(out) if len(out) > 1 else out[0]

    def render_batch(self, az_deg0, az_deg1, lats, lons, *, ele_m=None,
                     znear=ZNEAR_DEFAULT, zfar=ZFAR_DEFAULT,
                     znear_color=-1.0, zfar_color=-1.0, mesh=None):
        """Render many viewpoints in one pass (api.py:671-758, one
        device): ``lats``/``lons`` are sequences of viewer positions, with
        auto elevation unless ``ele_m`` gives them. The clip and colour
        ramp, texture, hillshade and the LOD swap of long clip ranges are
        render()'s, for every viewpoint; the viewer state that render()
        keeps for pick() is left as it is.

        The coverage guard is one host copy for the whole batch: it warns
        (raises under strict_coverage) naming the viewpoints at fault, where
        the JAX package drops them silently.

        ``mesh`` (api.py:752-790): "auto" (every rank on "batch") or a
        DeviceMesh with a "batch" dim and optionally an "az" dim (columns
        then shard into azimuth wedges; a batch-only mesh gets a size-1
        "az"): the viewpoints, padded to a multiple of the batch dim with
        the last one and sliced back, render over make_sharded_renderer,
        and every rank returns the whole batch. On a region_mesh instance
        the batch is a loop of render() calls, and ``mesh`` raises.

        Returns (images (B, H, W, 3) uint8 BGR, ranges (B, H, W) float32)
        as numpy arrays, one device-to-host copy each."""
        with profiling.phase("hz.api.render_batch"):
            from .parallel import render_batch as _rb
            if znear_color < 0.0:
                znear_color = znear
            if zfar_color < 0.0:
                zfar_color = zfar
            lats = [float(v) for v in lats]
            lons = [float(v) for v in lons]
            if len(lats) != len(lons) or not lats:
                raise ValueError(f"render_batch needs as many lats as lons, "
                                 f"at least one: got {len(lats)} and "
                                 f"{len(lons)}")
            if self._region is not None:
                if mesh is not None:
                    raise ValueError("render_batch(mesh=) cannot combine with "
                                     "a region_mesh instance")
                return self._region_batch(az_deg0, az_deg1, lats, lons, ele_m,
                                          znear, zfar, znear_color, zfar_color)
            b_real = len(lats)
            if mesh is not None:
                from .parallel.mesh import dim_size, resolve_mesh
                mesh = resolve_mesh(mesh, ("batch", "az"), self.device)
                pad = -b_real % dim_size(mesh, "batch")
                lats, lons = lats + lats[-1:] * pad, lons + lons[-1:] * pad
                if ele_m is not None:
                    ele_m = list(ele_m) + list(ele_m)[-1:] * pad
            cells = [self.mosaic.viewer_cell(la, lo) for la, lo in zip(lats,
                                                                        lons)]
            vz = ([float(v) for v in ele_m] if ele_m is not None else
                  [self.mosaic.auto_viewer_z(la, lo)
                   for la, lo in zip(lats, lons)])
            params = make_params(
                device=self.device,
                viewer_cell_i=[c[0] for c in cells],
                viewer_cell_j=[c[1] for c in cells], viewer_z=vz,
                cos_viewer_lat=[math.cos(math.radians(la)) for la in lats],
                az_rad0=math.radians(az_deg0), az_rad1=math.radians(az_deg1),
                znear=znear, zfar=zfar, znear_color=znear_color,
                zfar_color=zfar_color, curv=self._curv)
            dem, sampler, nsteps, plan, cp, exact_near = self._render_plan(
                znear, zfar, "render_batch")
            kw = dict(width=self.width, height=self.height, nsteps=nsteps,
                      cells_per_deg=self.mosaic.cells_per_deg,
                      surface=self.surface, refine=self.refine,
                      textured=self.render_texture,
                      atlas_params=self._atlas_params, sampler=sampler,
                      lat_hint_deg=self._lat_hint(), lod_plan=plan,
                      znear_hint_m=self._znear_hint(znear),
                      exact_near_m=exact_near)
            if mesh is None:
                images, ranges, guard = _rb(dem, params, color_planes=cp,
                                            atlas=self._atlas,
                                            with_dropped=True, **kw)
            else:
                from .parallel import make_sharded_renderer
                images, ranges, guard = make_sharded_renderer(mesh, **kw)(
                    dem, params, color_planes=cp, atlas=self._atlas,
                    with_dropped=True)
            with profiling.phase("hz.api.readback"):
                with profiling.sync():
                    images = images[:b_real].cpu().numpy()
                with profiling.sync():
                    ranges = ranges[:b_real].cpu().numpy()
            with profiling.phase("hz.api.guard"):
                self._check_dropped(guard[:b_real], "render_batch",
                                    sampler=sampler)
            return images, ranges

    def _region_batch(self, az_deg0, az_deg1, lats, lons, ele_m, znear,
                      zfar, znear_color, zfar_color):
        """render_batch on a region instance: a loop of region renders
        (api.py:695-711), the viewer state that pick() reads kept as it
        was."""
        keep = (self.viewer_lat, self.viewer_lon, self.viewer_z, self._last)
        try:
            out = [self.render(az_deg0, az_deg1, lat=la, lon=lo,
                               ele_m=None if ele_m is None else ele_m[b],
                               znear=znear, zfar=zfar,
                               znear_color=znear_color,
                               zfar_color=zfar_color)
                   for b, (la, lo) in enumerate(zip(lats, lons))]
        finally:
            (self.viewer_lat, self.viewer_lon, self.viewer_z,
             self._last) = keep
        return tuple(np.stack(xs) for xs in zip(*out))

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
        without an image: the sampler's march and a plain max over each
        column's samples. It marches the full budget at any zfar (no LOD
        swap, as in the JAX package)."""
        width = self.width if width is None else int(width)
        params = self._params(float(az_deg0), float(az_deg1), znear, zfar,
                              znear, zfar)
        nsteps = self._auto_nsteps(znear, zfar)
        if self._region is not None:
            # the region horizon (api.py:814-830), one per static config
            from .parallel.regions import make_region_sharded_horizon
            R = self._region
            key = ("horizon", width, nsteps, self._lat_hint())
            if key not in R["fns"]:
                R["fns"][key] = make_region_sharded_horizon(
                    R["mesh"], width=width, k_cross=nsteps,
                    cells_per_deg=self.mosaic.cells_per_deg,
                    lat_hint_deg=self._lat_hint(),
                    n_valid_rows=R["n_valid"])
            az, tan_el = R["fns"][key].run(R["band"], params)
            return az.cpu().numpy(), tan_el.cpu().numpy()
        if self.sampler == "crossing":
            tanel, _, _, az = march_crossing(
                self._scene, params, width=width, k_cross=nsteps,
                cells_per_deg=self.mosaic.cells_per_deg)
            return az.cpu().numpy(), tanel.amax(dim=1).cpu().numpy()
        if self.sampler == "step":
            az, tan_el = horizon_profile(
                self._scene, params, width=width, nsteps=nsteps,
                cells_per_deg=self.mosaic.cells_per_deg,
                surface=self.surface)
            return az.cpu().numpy(), tan_el.cpu().numpy()
        tanel, _, dists, az = march_window(
            self._dem, params, width=width, k_cross=nsteps,
            cells_per_deg=self.mosaic.cells_per_deg,
            lat_hint_deg=self._lat_hint(),
            znear_hint_m=self._znear_hint(znear))
        out = az.cpu().numpy(), tanel.max(dim=1).values.cpu().numpy()
        self._check_dropped(torch.stack([dists.dropped, dists.truncated]),
                            "horizon")
        return out

    def skyline(self, az_deg0, az_deg1, *, width=None,
                znear=ZNEAR_DEFAULT, zfar=ZFAR_DEFAULT):
        """The geolocated horizon ridgeline (api.py:858-940): a dict of
        per-column float64 numpy arrays ``az_deg`` (pixel-centre
        azimuths), ``el_deg`` (apparent elevation of the horizon),
        ``dist_m`` (horizontal range to the horizon point) and ``lat`` /
        ``lon`` (its position). Export with :mod:`..geojson` or the CLI's
        ``--horizon-out``.

        The horizon point is the march sample of greatest apparent
        elevation at the full crossing budget (no LOD swap); among equal
        ones the first, i.e. the nearest, as torch.argmax and jnp.argmax
        both keep. It maps back through the march's distance table and
        the tangent-plane geometry that pick() uses. Every sampler but the
        window one takes the crossing march here (api.py:901-930), with
        k_cross_for's budget unless nsteps= was given: a uniform-step
        budget would stop short of zfar above |lat| ~48 deg. A region
        instance raises, as in the JAX package (api.py:879)."""
        if self._region is not None:
            raise NotImplementedError(
                "skyline() on a region_mesh instance is not yet supported "
                "(the banded march's distance table stays per-band); use "
                "horizon() or an unsharded instance")
        width = self.width if width is None else int(width)
        params = self._params(float(az_deg0), float(az_deg1), znear, zfar,
                              znear, zfar)
        nsteps = self._auto_nsteps(znear, zfar)
        if self.sampler == "window":
            tanel, _, dists, az = march_window(
                self._dem, params, width=width, k_cross=nsteps,
                cells_per_deg=self.mosaic.cells_per_deg,
                lat_hint_deg=self._lat_hint(),
                znear_hint_m=self._znear_hint(znear))
            guard = torch.stack([dists.dropped, dists.truncated])
        else:
            if self.sampler == "crossing":
                scene = self._scene
            else:
                if self._nsteps_fixed is None:
                    nsteps = k_cross_for(zfar, self.mosaic.cells_per_deg,
                                         self.viewer_lat,
                                         n=self.mosaic.grid.shape[0])
                if self._skyline_scene is None:
                    self._skyline_scene = pack_scene(self._dem)
                scene = self._skyline_scene
            tanel, _, dists, az = march_crossing(
                scene, params, width=width, k_cross=nsteps,
                cells_per_deg=self.mosaic.cells_per_deg)
            guard = None
        idx = torch.argmax(tanel, dim=1)
        tan_el = torch.take_along_dim(tanel, idx[:, None], dim=1)[:, 0]
        d = dists.d_of(idx[:, None])[:, 0]
        viewer = torch.tensor(
            [self.viewer_lat, math.cos(math.radians(self.viewer_lat)),
             self.viewer_lon], dtype=torch.float32, device=self.device)
        lat, lon = geometry.en_to_latlon(d * torch.sin(az),
                                         d * torch.cos(az), *viewer.unbind())
        # one stacked device-to-host copy
        out = torch.stack([az, torch.atan(tan_el), d, lat, lon]).cpu().numpy(
            ).astype(np.float64)
        if guard is not None:
            self._check_dropped(guard, "skyline")
        return {"az_deg": np.degrees(out[0]), "el_deg": np.degrees(out[1]),
                "dist_m": out[2], "lat": out[3], "lon": out[4]}

    # -- line of sight (ops/los.py) -----------------------------------------

    def _dem_packed_pairs(self):
        """The pair-packed int32 DEM plane for the LOS ops: the step
        sampler's scene, else built on the instance's device on first
        use."""
        if self.sampler == "step":
            return self._scene
        if self._los_packed is None:
            self._los_packed = pack_dem_pairs(
                self._dem if self._dem is not None else torch.from_numpy(
                    self.mosaic.grid.astype(np.float32)).to(self.device))
        return self._los_packed

    def _los_cells(self, lat0, lon0, lat1, lon1, nsteps):
        """lat/lon -> (a, b, nsteps) for the LOS methods: float32 grid
        coordinates and, by default, the longest pair at 1.5 samples a
        cell (a multiple of 128 in [128, 8192])."""
        i0, j0 = self.mosaic.viewer_cell(np.asarray(lat0, np.float32),
                                         np.asarray(lon0, np.float32))
        i1, j1 = self.mosaic.viewer_cell(np.asarray(lat1, np.float32),
                                         np.asarray(lon1, np.float32))
        i0, j0, i1, j1 = np.broadcast_arrays(i0, j0, i1, j1)
        a = np.stack([i0, j0], axis=-1)
        b = np.stack([i1, j1], axis=-1)
        if nsteps is None:
            span = float(np.hypot(i1 - i0, j1 - j0).max())
            nsteps = int(min(8192, max(128, -(-span * 1.5 // 128) * 128)))
        return a, b, nsteps

    def _los_kw(self, nsteps, observer_height_m, target_height_m,
                curvature):
        return dict(cells_per_deg=self.mosaic.cells_per_deg,
                    cos_lat=math.cos(math.radians(self.viewer_lat)),
                    nsteps=nsteps, observer_height_m=observer_height_m,
                    target_height_m=target_height_m, surface="bilinear",
                    curvature=self.curvature if curvature is None
                    else curvature)

    def intervisible(self, lat0, lon0, lat1, lon1, *,
                     observer_height_m=2.0, target_height_m=0.0,
                     nsteps=None, curvature=None):
        """Can an observer at (lat0, lon0) see a target at (lat1, lon1)?

        Array arguments broadcast, so one call answers a whole batch of
        pairs. The observer stands observer_height_m above the terrain; the
        target sits target_height_m above it. curvature defaults to the
        constructor's. Returns a bool (scalar inputs) or a bool ndarray.
        Points outside the loaded mosaic window are never visible (the
        reference's out-of-window convention, dem.c:270,293)."""
        from .ops.los import intervisible as _iv
        a, b, nsteps = self._los_cells(lat0, lon0, lat1, lon1, nsteps)
        out = _iv(self._dem_packed_pairs(), a, b, **self._los_kw(
            nsteps, observer_height_m, target_height_m,
            curvature)).cpu().numpy()
        return bool(out) if out.ndim == 0 else out

    def sightline(self, lat0, lon0, lat1, lon1, *,
                  observer_height_m=2.0, target_height_m=0.0,
                  nsteps=None, curvature=None):
        """Full LOS profile between two points: distances, terrain
        elevations, chord heights, clearances, visibility, and the
        worst-obstruction distance (ops.los.Sightline of numpy arrays)."""
        from .ops.los import sightline as _sl
        a, b, nsteps = self._los_cells(lat0, lon0, lat1, lon1, nsteps)
        prof = _sl(self._dem_packed_pairs(), a, b, **self._los_kw(
            nsteps, observer_height_m, target_height_m, curvature))
        return type(prof)(*[x.cpu().numpy() for x in prof])

    def visible_peaks(self, pois, *, observer_height_m=2.0,
                      target_height_m=0.0, curvature=None):
        """Which POIs can the viewer see?

        ``pois``: a JSON path (annotate.load_pois format), a list of
        ``annotate.Poi``, or a list of {name, lat, lon, ele_m} dicts. One
        batched intervisible call (observer ``observer_height_m`` above
        the terrain) answers every POI; the report adds the viewing
        geometry in float64 on the host (viewer_z and the tan el = h/d -
        d*curv law the panorama projects with, geometry.project).

        Returns a list of dicts: {name, lat, lon, ele_m, visible, dist_m,
        az_deg, el_deg}. Export with geojson.points_geojson or the CLI's
        ``--pois-out``. POIs outside the loaded mosaic are visible=False.
        """
        from .annotate import Poi, load_pois
        if isinstance(pois, (str, bytes)) or hasattr(pois, "__fspath__"):
            pois = load_pois(str(pois))
        recs = [(p.name, p.lat, p.lon, p.ele_m) if isinstance(p, Poi)
                else (str(p["name"]), float(p["lat"]), float(p["lon"]),
                      float(p.get("ele_m", p.get("ele", 0.0))))
                for p in pois]
        if not recs:
            return []
        names = [r[0] for r in recs]
        lats = np.array([r[1] for r in recs], np.float64)
        lons = np.array([r[2] for r in recs], np.float64)
        eles = np.array([r[3] for r in recs], np.float64)
        vis = np.atleast_1d(self.intervisible(
            self.viewer_lat, self.viewer_lon, lats, lons,
            observer_height_m=observer_height_m,
            target_height_m=target_height_m, curvature=curvature))
        cos_lat = math.cos(math.radians(self.viewer_lat))
        east, north = geometry.latlon_to_en(
            lats, lons, self.viewer_lat, cos_lat, self.viewer_lon)
        d = np.hypot(east, north)
        az = np.degrees(np.arctan2(east, north))
        curv = self._curv if curvature is None else geometry.curvature_coeff(
            curvature)
        h = eles + target_height_m - self.viewer_z
        el = np.degrees(np.arctan2(h - d * d * curv, d))
        return [{"name": names[k], "lat": float(lats[k]),
                 "lon": float(lons[k]), "ele_m": float(eles[k]),
                 "visible": bool(vis[k]), "dist_m": float(d[k]),
                 "az_deg": float(az[k]), "el_deg": float(el[k])}
                for k in range(len(names))]

    def __str__(self):
        return f"Looking out from {self.viewer_lat:.4f},{self.viewer_lon:.4f}"

    __repr__ = __str__
