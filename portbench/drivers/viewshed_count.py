"""Cumulative viewsheds: ``horizonator_tpu_torch.ops.viewshed_count``.

Set-up puts the configuration's seeded SRTM tile on the device as one
float32 grid. A request counts, over the mix's fixed frame, how many of its
observers (full circles, the configuration's ``observer_m`` above the
terrain) see each cell,
in batches of ``batch`` observers; the call ends in a synchronize.
"""

from __future__ import annotations

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
    from horizonator_tpu_torch.ops import viewshed_count
    c, m = ctx.config, ctx.mix
    with ctx.span("pb.ops.viewshed_count"):
        counts = viewshed_count(
            ctx.inputs["dem"], req["pts"], out_center_ij=m["out_center_ij"],
            out_halfwidth=m["out_halfwidth"], viewer_height_m=c["observer_m"],
            batch=m["batch"], sampler="window", device=str(ctx.device),
            **_kw(ctx))
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
    return counts


def viewpoints(ctx, req) -> int:
    return len(req["pts"])


def reference(ctx, req, dtype):
    c, m = ctx.config, ctx.mix
    return ref.count(ctx.inputs["dem"],
                     torch.from_numpy(req["pts"]).to(ctx.device),
                     center=m["out_center_ij"], hw=m["out_halfwidth"],
                     height_m=c["observer_m"], dtype=dtype, **_kw(ctx))


def compare(out, ref_out) -> dict:
    """cells_off_pct: frame cells whose count differs, in %."""
    return {"cells_off_pct": 100.0 * float((out != ref_out).float().mean())}


def tiny(mix, config):
    """Cut the mix and configuration to sizes the CPU runs in seconds."""
    mix.update(width=48, batch=4, out_halfwidth=24, check_requests=1)
    mix["viewpoints"].update(count=8, box_cells=[580.0, 620.0])
    config.update(zfar_m=2000.0)


def _half_batch(monkeypatch):
    """viewshed_count counts the first half of the observers only and
    doubles the count."""
    import horizonator_tpu_torch.ops as ops
    real = ops.viewshed_count

    def fn(dem, pts, **kw):
        return 2 * real(dem, pts[: len(pts) // 2], **kw)
    monkeypatch.setattr(ops, "viewshed_count", fn)


def planted_faults() -> dict:
    return {"altered": faults.altered_march, "half_batch": _half_batch}


def work(ctx, req) -> dict:
    kw = _kw(ctx)
    return {"march": roofline.batches_bound_s(
        ctx.inputs["dem"].shape[0], req["pts"], ctx.mix["batch"],
        width=kw["width"], zfar_m=kw["zfar"], cpd=kw["cells_per_deg"],
        lat_deg=kw["lat_deg"], device=ctx.device)}
