"""Horizon sweeps: ``horizonator_tpu_torch.ops.viewshed_sweep``.

Set-up puts the configuration's seeded SRTM tile on the device as one
float32 grid. A request gives the horizon profile (the highest elevation
tangent of each azimuth column) of each of its viewpoints, the
configuration's ``observer_m`` above the terrain, through the window sampler in batches of ``batch``;
the call ends in a synchronize. Each profile is an answer of its own: the
check compares ``check_viewpoints`` of them a checked request, the same
seeded positions in each.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import faults, roofline, terrain
from portbench.reference import viewshed as ref


def _kw(ctx):
    c, m = ctx.config, ctx.mix
    return dict(width=m["width"], cells_per_deg=c["dem"]["cells_per_deg"],
                lat_deg=c["lat_deg"], znear=c["znear_m"], zfar=c["zfar_m"])


def setup(ctx):
    d = ctx.config["dem"]
    tile = terrain.mosaic(ctx.seed, *d["tiles"], d["cells_per_deg"])
    ctx.inputs["dem"] = torch.from_numpy(tile.astype("float32")).to(
        ctx.device)
    return {}


def request(ctx, state, req):
    from horizonator_tpu_torch.ops import viewshed_sweep
    c, m = ctx.config, ctx.mix
    with ctx.span("pb.ops.viewshed_sweep"):
        hz = viewshed_sweep(ctx.inputs["dem"], req["pts"],
                            viewer_height_m=c["observer_m"], batch=m["batch"],
                            sampler="window", device=str(ctx.device),
                            **_kw(ctx))
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
    return hz


def viewpoints(ctx, req) -> int:
    return len(req["pts"])


def reference(ctx, req, dtype):
    """(the checked viewpoints' indices, their reference profiles)."""
    n = len(req["pts"])
    idx = np.sort(terrain.rng(ctx.seed, 4).choice(
        n, min(n, ctx.mix["check_viewpoints"]), replace=False))
    pts = torch.from_numpy(req["pts"][idx]).to(ctx.device)
    return idx, ref.horizons(ctx.inputs["dem"], pts,
                             height_m=ctx.config["observer_m"], dtype=dtype,
                             **_kw(ctx))


def compare(out, ref_out) -> dict:
    """horizon_gap_deg: the widest gap between a checked horizon's
    elevation angle and the reference's, in degrees."""
    idx, hz = ref_out
    if isinstance(out, tuple):          # the control: the same viewpoints
        out = out[1]
    else:
        out = out[torch.from_numpy(idx).to(out.device)]
    gap = (torch.atan(out) - torch.atan(hz)).abs().max()
    return {"horizon_gap_deg": math.degrees(float(gap))}


def tiny(mix, config):
    """Cut the mix and configuration to sizes the CPU runs in seconds."""
    mix.update(width=32, batch=8, check_requests=2, check_viewpoints=5)
    mix["viewpoints"].update(side=4, box_cells=[500.0, 700.0])
    config.update(zfar_m=2000.0)


def _half_batch(monkeypatch):
    """viewshed_sweep sweeps the first half of the viewpoints only and
    repeats their profiles for the rest."""
    import horizonator_tpu_torch.ops as ops
    real = ops.viewshed_sweep

    def fn(dem, pts, **kw):
        out = real(dem, pts[: len(pts) // 2], **kw)
        return torch.cat([out, out])[: len(pts)]
    monkeypatch.setattr(ops, "viewshed_sweep", fn)


def planted_faults() -> dict:
    return {"altered": faults.altered_march, "half_batch": _half_batch}


def work(ctx, req) -> dict:
    kw = _kw(ctx)
    return {"march": roofline.batches_bound_s(
        ctx.inputs["dem"].shape[0], req["pts"], ctx.mix["batch"],
        width=kw["width"], zfar_m=kw["zfar"], cpd=kw["cells_per_deg"],
        lat_deg=kw["lat_deg"], device=ctx.device)}
