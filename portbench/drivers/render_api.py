"""Interactive panoramas through the API: ``horizonator(...).render()``.

Set-up writes the configuration's seeded SRTM tiles under the run's
temporary directory and builds ``horizonator_tpu_torch.api.horizonator``
at the configuration's view with the mix's image size (the DEM window
loaded once, as a viewer does). A request moves the viewer to its
(lat, lon) and renders the mix's azimuth window; it returns the numpy
(image, ranges) that a caller gets. The coverage guard raises
(``strict_coverage``), so a render that dropped samples counts as failed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import faults, roofline, terrain
from portbench.reference import render as ref
from portbench.reference.dem import Window


def _window(ctx) -> Window:
    if "window" not in ctx.inputs:
        c, d = ctx.config, ctx.config["dem"]
        ctx.inputs["window"] = Window(ctx.inputs["mosaic"], *d["sw_tile"],
                                      d["cells_per_deg"],
                                      *c["view_latlon"], c["radius_cells"])
    return ctx.inputs["window"]


def setup(ctx):
    c, d, m = ctx.config, ctx.config["dem"], ctx.mix
    mosaic = terrain.mosaic(ctx.seed, *d["tiles"], d["cells_per_deg"])
    ctx.inputs["mosaic"] = mosaic
    tiles = ctx.tmp / "dems"
    terrain.write_tiles(mosaic, *d["sw_tile"], d["cells_per_deg"], tiles)
    from horizonator_tpu_torch.api import horizonator
    api = horizonator(*c["view_latlon"], m["width"], m["height"],
                      dir_dems=str(tiles), render_radius_cells=c[
                          "radius_cells"], device=str(ctx.device),
                      strict_coverage=True)
    return {"api": api}


def request(ctx, state, req):
    c, (az0, az1) = ctx.config, ctx.mix["az_deg"]
    with ctx.span("pb.api.render"):
        return state["api"].render(az0, az1, lat=req["lat"], lon=req["lon"],
                                   znear=c["znear_m"], zfar=c["zfar_m"])


def viewpoints(ctx, req) -> int:
    return 1


def reference(ctx, req, dtype):
    c, m = ctx.config, ctx.mix
    win = _window(ctx)
    if "dem" not in ctx.inputs:
        ctx.inputs["dem"] = torch.from_numpy(
            win.grid.astype(np.float32)).to(ctx.device)
    lat, lon = req["lat"], req["lon"]
    ci, cj = win.cell(lat, lon)
    znear, zfar = c["znear_m"], c["zfar_m"]
    v = ref.make_view(ctx.device, vi=ci, vj=cj, vz=win.viewer_z(lat, lon),
                      cos_lat=math.cos(math.radians(lat)),
                      az0=math.radians(m["az_deg"][0]),
                      az1=math.radians(m["az_deg"][1]), znear=znear,
                      zfar=zfar, znear_color=znear, zfar_color=zfar)
    cpd = c["dem"]["cells_per_deg"]
    img, rng = ref.render(
        ctx.inputs["dem"], v, width=m["width"], height=m["height"],
        k_cross=ref.k_cross_for(zfar, cpd, lat, n=win.grid.shape[0]),
        cells_per_deg=cpd, lat_hint_deg=round(lat / 10.0) * 10.0,
        znear_hint_m=max(128.0, 2.0 ** math.ceil(math.log2(max(znear, 1.0)))),
        dtype=dtype)
    return img.cpu().numpy(), rng.cpu().numpy()


def compare(out, ref_out) -> dict:
    """px_off_pct: pixels whose range misses the reference's by more than
    1e-3 of it + 1 m (sky against ground included) or whose colour misses
    it by more than 1 in a channel, in % of the image."""
    img, rng = (np.asarray(x) for x in out)
    img_r, rng_r = ref_out
    off = np.abs(rng - rng_r) > 1e-3 * np.abs(rng_r) + 1.0
    off |= np.abs(img.astype(np.int16) - img_r.astype(np.int16)).max(-1) > 1
    return {"px_off_pct": 100.0 * float(off.mean())}


def tiny(mix, config):
    """Cut the mix and configuration to sizes the CPU runs in seconds."""
    mix.update(width=64, height=32, check_requests=3)
    mix["viewpoints"]["box_deg"] = 0.05
    config.update(radius_cells=300, zfar_m=5000.0)


def planted_faults() -> dict:
    return {"altered": faults.altered_march}


def work(ctx, req) -> dict:
    c, m = ctx.config, ctx.mix
    win = _window(ctx)
    ci, cj = win.cell(req["lat"], req["lon"])
    kw = dict(width=m["width"], zfar_m=c["zfar_m"],
              cpd=c["dem"]["cells_per_deg"], lat_deg=req["lat"])
    n = win.grid.shape[0]
    return {"march": roofline.march_bound_s(n, [ci], [cj], device=ctx.device,
                                            **kw),
            "resolve": roofline.resolve_bound_s(n, 1, height=m["height"],
                                                **kw)}
