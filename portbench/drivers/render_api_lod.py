"""Interactive SRTM1 panoramas through the API's level-of-detail march:
``horizonator(..., SRTM1=True).render()`` at a clip that needs more than
the window march's 1536 crossing steps.

Set-up writes the configuration's seeded SRTM1 tiles (3601^2 samples,
``mosaic``) under the run's temporary directory and builds
``horizonator_tpu_torch.api.horizonator`` with ``SRTM1=True`` at the
configuration's view with the mix's image size (the DEM window loaded
once, as a viewer does), then renders the walk for ``SETTLE_S`` seconds
(``settle``); its first render builds the level pyramid.
Requests, viewpoints, the comparison and the planted fault are
``render_api``'s (the fault reaches every level's march launch); the
reference is the plain LOD render (``reference/render_lod.py``), which
refuses a view that would not swap to the LOD march.
"""

from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np
import torch

from portbench import roofline_lod, terrain
from portbench.loader import load_module
from portbench.reference import render as ref
from portbench.reference import render_lod
from portbench.traffic import Requests

_api = load_module(Path(__file__).with_name("render_api.py"))
request, viewpoints, compare = _api.request, _api.viewpoints, _api.compare
planted_faults = _api.planted_faults


def mosaic(seed: int, tiles_lat: int, tiles_lon: int, cpd: int):
    """``terrain.mosaic``'s relief at SRTM1's cells: its formula over
    SRTM3 cells (x 1200 / cpd), so the hills are srtm3-40km's in metres,
    and its 30 m of seeded noise a third as tall, so the noise's rise
    from cell to cell is SRTM3's too. (At a tile's own cells the relief
    shrinks threefold and the noise, 30 m in every 31 m cell, walls the
    viewer in within a few hundred metres.)"""
    s = np.float32(cpd / 1200)
    nj, ni = tiles_lat * cpd + 1, tiles_lon * cpd + 1
    jj = np.arange(nj, dtype=np.float32)[:, None] / s
    ii = np.arange(ni, dtype=np.float32)[None, :] / s
    r = terrain.RELIEF_M
    z = (600.0 + r * np.sin(ii / 223.0) * np.cos(jj / 181.0)
         + 0.4 * r * np.sin(ii / 37.0 + 1.3) * np.cos(jj / 53.0))
    z = z + terrain.NOISE_M / s * terrain.rng(seed, 0).standard_normal(
        (nj, ni), dtype=np.float32)
    return np.round(np.maximum(z, 0.0)).astype(np.int16)


def setup(ctx):
    c, d, m = ctx.config, ctx.config["dem"], ctx.mix
    mosaic_ = mosaic(ctx.seed, *d["tiles"], d["cells_per_deg"])
    ctx.inputs["mosaic"] = mosaic_
    tiles = ctx.tmp / "dems"
    terrain.write_tiles(mosaic_, *d["sw_tile"], d["cells_per_deg"], tiles)
    from horizonator_tpu_torch.api import horizonator
    api = horizonator(*c["view_latlon"], m["width"], m["height"], SRTM1=True,
                      dir_dems=str(tiles),
                      render_radius_cells=c["radius_cells"],
                      device=str(ctx.device), strict_coverage=True)
    state = {"api": api}
    settle(ctx, state)
    return state


# seconds of set-up renders before the harness's own warm-up
SETTLE_S = 8.0


def settle(ctx, state):
    """The end of set-up: renders of the walk (from a stream of its own, so
    the window's requests stay the same) for the mix's ``settle_s`` seconds,
    ``SETTLE_S`` where it gives none, in rounds that hold check_requests +
    2 outputs at once. The window's check sample keeps that many alive, so
    it finds their page-locked blocks cached rather than allocating them,
    and the window starts past the first seconds of the loop."""
    gen = Requests(ctx.mix, ctx.config, ctx.seed, stream=4, kinds=ctx.kinds)
    t_end = time.perf_counter() + ctx.mix.get("settle_s", SETTLE_S)
    while time.perf_counter() < t_end:
        held = [request(ctx, state, gen.next())
                for _ in range(ctx.mix["check_requests"] + 2)]
        del held


def _hints(lat: float) -> tuple[float, float]:
    """(the crops' and near patch's latitude hint, the plan's): the
    viewer's 10-degree bucket, and its worst case + 5 degrees."""
    hint = round(lat / 10.0) * 10.0
    return hint, min(abs(hint) + 5.0, 85.0)


def reference(ctx, req, dtype):
    c, m = ctx.config, ctx.mix
    win = _api._window(ctx)
    cpd, n = c["dem"]["cells_per_deg"], win.grid.shape[0]
    if "dem" not in ctx.inputs:
        ctx.inputs["dem"] = torch.from_numpy(
            win.grid.astype(np.float32)).to(ctx.device)
    lat, lon = req["lat"], req["lon"]
    znear, zfar = c["znear_m"], c["zfar_m"]
    k = ref.k_cross_for(zfar, cpd, lat, n=n)
    if k <= render_lod.SWAP_NSTEPS:
        raise ValueError(f"{k} crossing steps: this view renders through "
                         f"the window march, not the LOD march")
    ci, cj = win.cell(lat, lon)
    v = ref.make_view(ctx.device, vi=ci, vj=cj, vz=win.viewer_z(lat, lon),
                      cos_lat=math.cos(math.radians(lat)),
                      az0=math.radians(m["az_deg"][0]),
                      az1=math.radians(m["az_deg"][1]), znear=znear,
                      zfar=zfar, znear_color=znear, zfar_color=zfar)
    hint, plan_lat = _hints(lat)
    img, rng = render_lod.render(
        ctx.inputs["dem"], v, width=m["width"], height=m["height"],
        cells_per_deg=cpd, lat_hint_deg=hint, lat_plan_deg=plan_lat,
        znear_hint_m=max(128.0, 2.0 ** math.ceil(math.log2(max(znear, 1.0)))),
        dtype=dtype)
    return img.cpu().numpy(), rng.cpu().numpy()


def tiny(mix, config):
    """One SRTM1 tile, an 800-cell window and a 41 km clip, so that the
    view still needs 1600 crossing steps and takes the LOD march (four
    levels at 128 columns), at sizes the CPU runs in seconds. The view
    moves onto a ridge of the tile's relief (~1050 m): at the
    configuration's own lat/lon this tile puts the viewer in a valley
    (~250 m) whose sides end most rays within a few hundred metres, where
    neither a fault nor the control shows."""
    mix.update(width=128, height=32, check_requests=3, settle_s=0.0)
    mix["viewpoints"]["box_deg"] = 0.05
    config.update(radius_cells=800, zfar_m=41000.0,
                  view_latlon=[34.4278, -117.2944])
    config["dem"].update(sw_tile=[34, -118], tiles=[1, 1])


def work(ctx, req) -> dict:
    c, m = ctx.config, ctx.mix
    win = _api._window(ctx)
    ci, cj = win.cell(req["lat"], req["lon"])
    cpd, n = c["dem"]["cells_per_deg"], win.grid.shape[0]
    bands = render_lod.plan(c["zfar_m"], m["width"], cpd,
                            _hints(req["lat"])[1], n)
    return {"march": roofline_lod.march_bound_s(
                n, ci, cj, bands, width=m["width"], cpd=cpd,
                lat_deg=req["lat"], device=ctx.device),
            "resolve": roofline_lod.resolve_bound_s(
                bands, width=m["width"], height=m["height"])}
