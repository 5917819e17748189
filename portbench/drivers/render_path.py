"""Fly-through batches: ``horizonator_tpu_torch.parallel.render_path``.

Set-up puts the DEM window that the API loads at the configuration's view
on the device as one float32 grid. A request is a camera path of the
mix's frames, each ``above_m`` over the highest of its four cells, with a
turning azimuth window; one call renders the whole path, the outputs stay
on the device and the call ends in a synchronize. A path whose coverage
guard reports dropped samples counts as failed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import faults, roofline, terrain
from portbench.reference import render as ref
from portbench.reference.dem import Window


def _frames(ctx, req):
    """Per frame: (vi, vj, vz, lat, az0 deg, az1 deg)."""
    win = ctx.inputs["window"]
    ci, cj = win.cell(*ctx.config["view_latlon"])
    vi, vj = ci + req["di"], cj + req["dj"]
    vz = [win.ground_z(i, j) + ctx.mix["above_m"] for i, j in zip(vi, vj)]
    lat = [win.lat_of(j) for j in vj]
    return vi, vj, vz, lat, req["az0"], req["az1"]


def _k(ctx):
    c = ctx.config
    return ref.k_cross_for(c["zfar_m"], c["dem"]["cells_per_deg"],
                           c["view_latlon"][0],
                           n=ctx.inputs["window"].grid.shape[0])


def setup(ctx):
    c, d = ctx.config, ctx.config["dem"]
    mosaic = terrain.mosaic(ctx.seed, *d["tiles"], d["cells_per_deg"])
    win = Window(mosaic, *d["sw_tile"], d["cells_per_deg"],
                 *c["view_latlon"], c["radius_cells"])
    ctx.inputs["window"] = win
    ctx.inputs["dem"] = torch.from_numpy(
        win.grid.astype(np.float32)).to(ctx.device)
    return {}


def request(ctx, state, req):
    from horizonator_tpu_torch.parallel import render_path
    from horizonator_tpu_torch.render import make_params
    c, m = ctx.config, ctx.mix
    vi, vj, vz, lat, az0, az1 = _frames(ctx, req)
    with ctx.span("pb.parallel.render_path"):
        p = make_params(device=ctx.device, viewer_cell_i=list(vi),
                        viewer_cell_j=list(vj), viewer_z=vz,
                        cos_viewer_lat=[math.cos(math.radians(x))
                                        for x in lat],
                        az_rad0=list(np.radians(az0)),
                        az_rad1=list(np.radians(az1)),
                        znear=c["znear_m"], zfar=c["zfar_m"],
                        znear_color=c["znear_m"], zfar_color=c["zfar_m"])
        img, rng, guard = render_path(
            ctx.inputs["dem"], p, width=m["width"], height=m["height"],
            nsteps=_k(ctx), cells_per_deg=c["dem"]["cells_per_deg"],
            sampler="window", lat_hint_deg=c["view_latlon"][0],
            znear_hint_m=c["znear_m"], with_dropped=True)
        bad = bool(guard.any())
    if bad:
        raise RuntimeError(f"coverage guard: {guard.sum(0).tolist()}")
    return img, rng


def viewpoints(ctx, req) -> int:
    return len(req["di"])


def reference(ctx, req, dtype):
    c, m = ctx.config, ctx.mix
    cpd = c["dem"]["cells_per_deg"]
    znear, zfar = c["znear_m"], c["zfar_m"]
    imgs, rngs = [], []
    for vi, vj, vz, lat, az0, az1 in zip(*_frames(ctx, req)):
        v = ref.make_view(ctx.device, vi=vi, vj=vj, vz=vz,
                          cos_lat=math.cos(math.radians(lat)),
                          az0=math.radians(az0), az1=math.radians(az1),
                          znear=znear, zfar=zfar, znear_color=znear,
                          zfar_color=zfar)
        img, rng = ref.render(ctx.inputs["dem"], v, width=m["width"],
                              height=m["height"], k_cross=_k(ctx),
                              cells_per_deg=cpd,
                              lat_hint_deg=c["view_latlon"][0],
                              znear_hint_m=znear, dtype=dtype)
        imgs.append(img)
        rngs.append(rng)
    return torch.stack(imgs), torch.stack(rngs)


def compare(out, ref_out) -> dict:
    """px_off_pct over every frame of the path: as render_api's."""
    img, rng = out
    img_r, rng_r = ref_out
    off = (rng - rng_r).abs() > 1e-3 * rng_r.abs() + 1.0
    off |= (img.to(torch.int16) - img_r.to(torch.int16)).abs().amax(-1) > 1
    return {"px_off_pct": 100.0 * float(off.float().mean())}


def tiny(mix, config):
    """Cut the mix and configuration to sizes the CPU runs in seconds."""
    mix.update(width=48, height=16, check_requests=2)
    mix["viewpoints"].update(frames=4, start_cells=20.0)
    config.update(radius_cells=300, zfar_m=5000.0)


def _half_batch(monkeypatch):
    """render_path renders the first half of the path's frames only and
    repeats them for the rest."""
    import horizonator_tpu_torch.parallel as parallel
    real = parallel.render_path

    def fn(dem, p, **kw):
        b = p.viewer_cell_i.shape[0]
        half = type(p)(*(x[: b // 2] for x in p))
        out = real(dem, half, **kw)
        return tuple(torch.cat([x, x])[:b] for x in out)
    monkeypatch.setattr(parallel, "render_path", fn)


def planted_faults() -> dict:
    return {"altered": faults.altered_march, "half_batch": _half_batch}


def work(ctx, req) -> dict:
    c, m = ctx.config, ctx.mix
    vi, vj, _, _, az0, az1 = _frames(ctx, req)
    kw = dict(width=m["width"], zfar_m=c["zfar_m"],
              cpd=c["dem"]["cells_per_deg"], lat_deg=c["view_latlon"][0])
    n = ctx.inputs["window"].grid.shape[0]
    return {"march": roofline.march_bound_s(n, vi, vj, az0=az0, az1=az1,
                                            device=ctx.device, **kw),
            "resolve": roofline.resolve_bound_s(n, len(vi),
                                                height=m["height"], **kw)}
