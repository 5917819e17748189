"""The ``standalone``-compatible CLI: one render to .png/.pdf/.svg.

The counterpart of horizonator_tpu.cli, with the same flag surface,
validation messages and exit codes, and the reference tool's conventions
(standalone.c:115-323):

- ``--width`` selects offscreen mode (required with ``--image``);
- ``--height`` optional; a 20-degree FOV default otherwise (standalone.c:407-411);
- positional LAT LON AZ_CENTER_DEG AZ_RADIUS_DEG; in image mode the azimuths
  refer to pixel CENTERS and get the half-pixel viewport conversion
  (standalone.c:400-404);
- ``--znear/--zfar`` clip, ``--znear-color/--zfar-color`` ramp (defaulting to
  the clip values, standalone.c:333-334);
- ``.png`` -> plain render; ``.pdf``/``.svg`` -> annotated render;
  ``--ranges`` also writes the range image.

``--horizon-out`` also writes the geolocated skyline as .csv or GeoJSON;
without ``--image`` it is the only output (the headless GIS mode).
``--pois-out`` writes the line-of-sight-tested ``--pois`` report as GeoJSON
points (api.visible_peaks), with ``--image`` or without it.
``--viewshed FILE.tif`` writes the GIS visibility raster around LAT LON as
a WGS84 GeoTIFF (ops/viewshed + geotiff.py), through the window march
or, with ``--viewshed-sampler step|crossing``, an oracle march; alone, or
before the panorama and the vector outputs. ``--surface triangulated``
renders the reference's mesh surface through the uniform-step sampler.
``--hillshade --shadows`` shades the panorama with cast terrain shadows
(ops/shadows).

``--device`` (default ``cuda``) picks where the render runs; the JAX CLI
takes its backend from JAX_PLATFORMS instead. Flags whose code is not
ported yet (``--allow-dem-downloads``, ``--dem-url``, and the interactive
viewer) exit with status 1 and a message naming the missing module.

Usage: python -m horizonator_tpu_torch.cli [options] LAT LON AZ_C AZ_R
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="horizonator-tpu-torch",
        description="Render a terrain panorama from SRTM data (PyTorch + "
                    "CUDA port of horizonator_tpu, a rebuild of "
                    "dkogan/horizonator's `standalone` tool)")
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--cut-off-bottom-px", type=int, default=0, dest="cut_off_bottom_px")
    p.add_argument("--image", type=str, default=None,
                   help="output file: .png (render) or .pdf/.svg (annotated)")
    p.add_argument("--dirdems", type=str, default=None)
    p.add_argument("--dirtiles", type=str, default=None)
    p.add_argument("--tiles", type=str, default=None, metavar="NAME=FMT")
    p.add_argument("--texture", action="store_true")
    p.add_argument("--hillshade", action="store_true",
                   help="beyond-reference: Lambertian sun shading computed "
                        "from the DEM (no tiles needed); exclusive with "
                        "--texture")
    p.add_argument("--sun-az", type=float, default=315.0, dest="sun_az",
                   metavar="DEG", help="hillshade sun azimuth, deg cw from "
                                       "north (default 315 = NW)")
    p.add_argument("--sun-alt", type=float, default=45.0, dest="sun_alt",
                   metavar="DEG", help="hillshade sun altitude above the "
                                       "horizon (default 45)")
    p.add_argument("--shadows", action="store_true",
                   help="with --hillshade: cast terrain shadows (terrain "
                        "blocking the sun ray), not just slope shading")
    p.add_argument("--sun-time", type=str, default=None, dest="sun_time",
                   metavar="ISO8601",
                   help="place the hillshade sun at its real position for "
                        "this UTC time (e.g. 2026-08-18T15:00); overrides "
                        "--sun-az/--sun-alt")
    p.add_argument("--SRTM1", action="store_true")
    p.add_argument("--curvature", choices=["none", "spherical", "refracted"],
                   default="none",
                   help="correct apparent elevations for earth curvature "
                        "(and standard atmospheric refraction); the "
                        "reference renders on a flat tangent plane = none")
    p.add_argument("--allow-tile-downloads", action="store_true",
                   dest="allow_downloads")
    p.add_argument("--allow-dem-downloads", action="store_true",
                   dest="allow_dem_downloads",
                   help="fetch missing .hgt tiles into --dirdems (not "
                        "ported: needs the DEM downloader)")
    p.add_argument("--dem-url", type=str, default=None, dest="dem_url_fmt",
                   metavar="FMT",
                   help="DEM download URL template: %%s or {name} = "
                        "N34W118.hgt, {ns} = N34; gzip/zip unwrapped")
    p.add_argument("--znear", type=float, default=100.0)
    p.add_argument("--zfar", type=float, default=40000.0)
    p.add_argument("--znear-color", type=float, default=-1.0, dest="znear_color")
    p.add_argument("--zfar-color", type=float, default=-1.0, dest="zfar_color")
    p.add_argument("--ranges", type=str, default=None, metavar="FILE",
                   help="also write the float32 range image (slant meters, "
                        "invisible/sky = -1) as .npy, or raw little-endian "
                        "f32 for any other extension")
    p.add_argument("--horizon-out", type=str, default=None,
                   dest="horizon_out", metavar="FILE",
                   help="also write the geolocated skyline ridgeline "
                        "(per-column azimuth, apparent elevation, range, "
                        "lat/lon of the horizon point) as .csv, or GeoJSON "
                        "for any other extension. Works with --image or "
                        "standalone (with --width)")
    p.add_argument("--pois", type=str, default=None,
                   help="peak list for .pdf/.svg annotation: a JSON file of "
                        "[{name, lat, lon, ele_m}] (replaces the reference's "
                        "compiled-in socal-peaks.h)")
    p.add_argument("--pois-out", type=str, default=None, dest="pois_out",
                   metavar="FILE",
                   help="also write the --pois list as GeoJSON points, each "
                        "tested for line of sight from the viewer (visible, "
                        "dist_m, az_deg, el_deg). Works with --image or "
                        "standalone (with --width)")
    p.add_argument("--nsteps", type=int, default=None,
                   help="ray-march samples (default: auto from zfar)")
    p.add_argument("--surface", choices=["bilinear", "triangulated"],
                   default="bilinear")
    p.add_argument("--viewshed", type=str, default=None, metavar="FILE.tif",
                   help="write a GIS viewshed raster around LAT LON as a "
                        "georeferenced WGS84 GeoTIFF (uint8 0/1); the "
                        "azimuth args bound the swept sector (0 180 for the "
                        "full circle), --znear/--zfar the range. May be "
                        "combined with --image and --horizon-out")
    p.add_argument("--viewshed-halfwidth", type=int, default=0,
                   dest="viewshed_halfwidth", metavar="CELLS",
                   help="half-width of the --viewshed raster in DEM cells "
                        "(default: zfar's reach, clipped to the mosaic)")
    p.add_argument("--viewshed-sampler", choices=["step", "crossing",
                                                  "window"],
                   default="window", dest="viewshed_sampler",
                   help="--viewshed march sampler (window = the kernel "
                        "march; step and crossing = the oracle marches)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the render (default cuda; cpu runs "
                        "the kernels' plain versions)")
    p.add_argument("lat", type=float)
    p.add_argument("lon", type=float)
    p.add_argument("az_center_deg", type=float)
    p.add_argument("az_radius_deg", type=float)
    return p


def _validate(args) -> str | None:
    """The JAX CLI's argument checks, in its order; the message, or None."""
    if not (-80.0 <= args.lat <= 80.0):
        return "Got invalid latitude"                    # standalone.c:360-364
    if not (-180.0 <= args.lon <= 180.0):
        return "Got invalid longitude"
    wants_gis_vectors = (args.horizon_out is not None
                         or args.pois_out is not None)
    if args.width > 0 and args.image is None and not wants_gis_vectors:
        return ("--width makes sense only with --image, --horizon-out or "
                "--pois-out")
    if args.width <= 0 and args.image is not None:
        return "--width required if --image"
    if args.width == 1:
        # the pixel-center az conversion divides by width-1
        return "--width must be >= 2"
    if args.height > 0 and args.width <= 0:
        return "--height makes sense only with --width"
    if args.az_radius_deg <= 0 and (args.image is not None
                                    or wants_gis_vectors):
        # the default-height formula divides by az_radius
        return "AZ_RADIUS_DEG must be > 0"
    if args.pois_out is not None and args.pois is None:
        return "--pois-out needs --pois"
    return None


def _unported(args) -> str | None:
    """The first requested feature whose code the port lacks, as a message."""
    missing = [
        (args.allow_dem_downloads, "--allow-dem-downloads",
         "the DEM downloader"),
        (args.image is None and args.horizon_out is None
         and args.pois_out is None and args.viewshed is None,
         "interactive mode (no --image)",
         "viewer.py"),
    ]
    for wanted, flag, module in missing:
        if wanted:
            return (f"{flag} needs {module}, which is not ported to "
                    f"horizonator_tpu_torch")
    return None


def _run_viewshed(args) -> int:
    """--viewshed: the visibility raster of the cells within the half-width
    around the viewer (default zfar's reach, clipped to the mosaic) as a
    WGS84 GeoTIFF, north up, with the JAX CLI's polar width, step budget
    (per sampler) and bounds."""
    import math

    import numpy as np
    import torch

    from . import geometry
    from .dem import load_mosaic
    from .geotiff import write_geotiff
    from .ops import viewshed_grid
    from .render import make_params
    from .render.crossing import k_cross_for

    m = load_mosaic(args.lat, args.lon, render_radius_m=args.zfar,
                    datadir=args.dirdems, srtm1=args.SRTM1)
    n = m.grid.shape[0]
    ci, cj = m.viewer_cell(args.lat, args.lon)
    cell_n = geometry.EARTH_RADIUS_M * math.pi / 180.0 / m.cells_per_deg
    cos_lat = math.cos(math.radians(args.lat))
    hw = args.viewshed_halfwidth
    if hw <= 0:
        # zfar's reach in cells (east cells are the short ones)
        hw = int(math.ceil(args.zfar / (cell_n * cos_lat)))
    hw = max(8, min(hw, int(min(ci, cj, n - 1 - ci, n - 1 - cj))))
    # ~1 polar column per rim cell, a multiple of 256, bounded
    width = int(min(4096, max(256, -(-2.0 * math.pi * hw // 256) * 256)))
    if args.nsteps:
        nsteps = args.nsteps
    elif args.viewshed_sampler == "step":
        # 1.5 uniform steps a cell, a multiple of 128
        nsteps = int(-(-1.5 * (args.zfar - args.znear) / cell_n // 128)
                     * 128)
    else:
        nsteps = k_cross_for(args.zfar, m.cells_per_deg, args.lat, n=n)
    params = make_params(
        device=args.device, viewer_cell_i=ci, viewer_cell_j=cj,
        viewer_z=m.auto_viewer_z(args.lat, args.lon), cos_viewer_lat=cos_lat,
        az_rad0=math.radians(args.az_center_deg - args.az_radius_deg),
        az_rad1=math.radians(args.az_center_deg + args.az_radius_deg),
        znear=args.znear, zfar=args.zfar, znear_color=args.znear,
        zfar_color=args.zfar, curv=geometry.curvature_coeff(args.curvature))
    # a full circle iff the unwrapped span is exactly 2 pi: the azimuth
    # window rewraps larger spans, so only multiples of 180 qualify
    r = abs(float(args.az_radius_deg))
    dem = torch.from_numpy(m.grid.astype(np.float32)).to(args.device)
    vis = viewshed_grid(
        dem, params, width=width, nsteps=nsteps,
        cells_per_deg=m.cells_per_deg, out_halfwidth=hw,
        sampler=args.viewshed_sampler,
        lat_hint_deg=float(args.lat), znear_hint_m=float(args.znear),
        full_circle=r > 0.0 and r % 180.0 == 0.0).cpu().numpy()
    # the raster covers cells viewer +- hw; georeference its outer edges
    cpd = m.cells_per_deg
    olon, olat = m.origin_dem_lon_lat
    oi, oj = m.origin_dem_cellij
    bounds = (olat + (oj + cj - hw) / cpd, olon + (oi + ci - hw) / cpd,
              olat + (oj + cj + hw) / cpd, olon + (oi + ci + hw) / cpd)
    write_geotiff(args.viewshed, vis, bounds=bounds, row0="south")
    print(f"wrote {args.viewshed}: {2 * hw}x{2 * hw} cells, "
          f"{vis.mean():.1%} visible", file=sys.stderr)
    return 0


def _write_pois(h, args) -> None:
    """--pois-out: the LOS-tested peak report as GeoJSON Points."""
    from . import geojson as gj
    peaks = h.visible_peaks(args.pois)
    gj.points_geojson([p["lat"] for p in peaks], [p["lon"] for p in peaks],
                      args.pois_out,
                      properties=[{k: (round(v, 7) if isinstance(v, float)
                                       else v) for k, v in p.items()
                                   if k not in ("lat", "lon")}
                                  for p in peaks])


def _write_horizon(h, args, az_deg0, az_deg1) -> None:
    """--horizon-out: the geolocated skyline as CSV or GeoJSON."""
    from . import geojson as gj
    sky = h.skyline(az_deg0, az_deg1, znear=args.znear, zfar=args.zfar)
    if args.horizon_out.lower().endswith(".csv"):
        gj.skyline_csv(sky, args.horizon_out)
    else:
        gj.skyline_geojson(sky, args.horizon_out, properties={
            "viewer_lat": round(float(h.viewer_lat), 7),
            "viewer_lon": round(float(h.viewer_lon), 7),
            "viewer_ele_m": round(float(h.viewer_z), 1)})


def _az_radius(args, width: int) -> float:
    """AZ_RADIUS_DEG widened from pixel centres to the viewport's edges,
    half a pixel on each side (standalone.c:400-404). AZ_RADIUS_DEG == 180
    stays a FULL circle: the widened span would pass 360 deg, which the
    azimuth window rewraps to a half-pixel-wide window facing
    az_center+180, so it is clamped at exactly 360. Radii > 180 keep the
    reference's rewrap."""
    az_radius = args.az_radius_deg
    az_radius += 2.0 * az_radius / (width - 1) / 2.0
    if args.az_radius_deg <= 180.0:
        az_radius = min(az_radius, 180.0)
    return az_radius


def _horizonator(args, width: int, height: int, **kw):
    """The API instance for the flags, or None (after a message) where the
    constructor reaches a code path that is not ported, e.g. --dem-url."""
    from .api import horizonator
    try:
        return horizonator(args.lat, args.lon, width, height,
                           SRTM1=args.SRTM1, dir_dems=args.dirdems,
                           render_radius_m=args.zfar,   # standalone.c:437
                           nsteps=args.nsteps, surface=args.surface,
                           curvature=args.curvature,
                           dem_url_fmt=args.dem_url_fmt, device=args.device,
                           **kw)
    except NotImplementedError as e:
        print(f"not ported to horizonator_tpu_torch: {e}", file=sys.stderr)
        return None


def _gis_only(args) -> int:
    """--horizon-out / --pois-out without --image: the vector outputs and
    no panorama."""
    width = args.width if args.width > 0 else 1024
    az_radius = _az_radius(args, width)
    h = _horizonator(args, width,
                     max(1, int(round(width * 20.0 / az_radius))))
    if h is None:
        return 1
    if args.horizon_out is not None:
        _write_horizon(h, args, args.az_center_deg - az_radius,
                       args.az_center_deg + az_radius)
    if args.pois_out is not None:
        _write_pois(h, args)
    return 0


def _render_image(args) -> int:
    """--image: one render to .png/.pdf/.svg (+ --ranges, --horizon-out)."""
    suffix = args.image.lower()[-4:]
    if suffix not in (".png", ".pdf", ".svg"):
        print("--image MUST be given a '.png' or '.pdf' or '.svg' filename",
              file=sys.stderr)
        return 1

    tiles_name = tiles_url_fmt = None
    if args.tiles is not None:
        if "=" not in args.tiles:
            print("Couldn't find '=' in --tiles", file=sys.stderr)
            return 1
        tiles_name, tiles_url_fmt = args.tiles.split("=", 1)

    znear_color = args.znear_color if args.znear_color > 0 else args.znear
    zfar_color = args.zfar_color if args.zfar_color > 0 else args.zfar

    az_radius = _az_radius(args, args.width)
    az_deg0 = args.az_center_deg - az_radius
    az_deg1 = args.az_center_deg + az_radius

    height = args.height
    if height <= 0:
        # the reference's default-height formula (standalone.c:407-411):
        # its comment says a 20-deg fov, but width*20/az_radius under the
        # equirect mapping gives a 40-deg vertical span; parity wins
        fovy_deg = 20.0
        height = int(round(args.width * fovy_deg / az_radius))

    h = _horizonator(args, args.width, height, render_texture=args.texture,
                     dir_tiles=args.dirtiles, tiles_name=tiles_name,
                     tiles_url_fmt=tiles_url_fmt,
                     allow_downloads=args.allow_downloads,
                     hillshade=args.hillshade, sun_az_deg=args.sun_az,
                     sun_alt_deg=args.sun_alt, sun_time=args.sun_time,
                     shadows=args.shadows)
    if h is None:
        return 1
    image, ranges = h.render(az_deg0, az_deg1, znear=args.znear,
                             zfar=args.zfar, znear_color=znear_color,
                             zfar_color=zfar_color)

    crop = args.cut_off_bottom_px
    if args.ranges:
        import numpy as np
        r = ranges[: ranges.shape[0] - crop]
        if args.ranges.lower().endswith(".npy"):
            np.save(args.ranges, r)
        else:
            r.astype("<f4").tofile(args.ranges)
    if suffix == ".png" and not args.pois:
        from PIL import Image
        out = image[: image.shape[0] - crop, :, ::-1]   # BGR -> RGB
        Image.fromarray(out).save(args.image)
    else:
        # .pdf/.svg (reference annotator parity) or .png with --pois
        # (labels rasterized straight into the bitmap)
        from .annotate import annotate, load_pois
        pois = load_pois(args.pois) if args.pois else []
        annotate(args.image, image, ranges,
                 cut_off_bottom_px=crop, pois=pois,
                 lat=h.viewer_lat, lon=h.viewer_lon,
                 az_deg0=az_deg0, az_deg1=az_deg1,
                 ele_m=h.viewer_z, curv=h._curv)
    if args.horizon_out is not None:
        _write_horizon(h, args, az_deg0, az_deg1)
    if args.pois_out is not None:
        _write_pois(h, args)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    msg = _validate(args) or _unported(args)
    if msg:
        print(msg, file=sys.stderr)
        return 1
    if args.viewshed is not None:
        rc = _run_viewshed(args)
        # --image, --horizon-out and --pois-out compose with --viewshed
        if rc != 0 or (args.image is None and args.horizon_out is None
                       and args.pois_out is None):
            return rc
    return _gis_only(args) if args.image is None else _render_image(args)


if __name__ == "__main__":
    raise SystemExit(main())
