"""Interactive textured panoramas through the API:
``horizonator(..., render_texture=True).render()``.

Set-up writes the configuration's seeded SRTM tiles and its seeded z12 map
tiles (``portbench/tiles.py``, over the tile range around the view) under
the run's temporary directory, then builds
``horizonator_tpu_torch.api.horizonator`` at the configuration's view with
the mix's image size, texture on at the configuration's quality and
``exact_near_m``, downloads off: the constructor decodes the cache into its
atlas and resamples the half-cell colour planes. Requests, viewpoints and
the comparison are ``render_api``'s; the reference is the textured one
(``reference/render_tex.py``), built from the pixels the tile writer
encoded. A render whose coverage guard drops samples raises
(``strict_coverage``) and counts as failed; one whose hybrid near field
falls back to the planes' colours misses the reference's and fails the
check.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from portbench import roofline_tex, terrain, tiles
from portbench.loader import load_module
from portbench.reference import render as ref
from portbench.reference import render_tex

_api = load_module(Path(__file__).with_name("render_api.py"))
request, viewpoints, compare = _api.request, _api.viewpoints, _api.compare


def setup(ctx):
    c, d, m = ctx.config, ctx.config["dem"], ctx.mix
    tx = c["texture_tiles"]
    mosaic = terrain.mosaic(ctx.seed, *d["tiles"], d["cells_per_deg"])
    ctx.inputs["mosaic"] = mosaic
    dems, cache = ctx.tmp / "dems", ctx.tmp / "tiles"
    terrain.write_tiles(mosaic, *d["sw_tile"], d["cells_per_deg"], dems)
    ctx.inputs["tiles"] = tiles.write_cache(
        ctx.seed, cache, tx["name"], tx["zoom"],
        tiles.tile_range(*c["view_latlon"], c["radius_cells"],
                         d["cells_per_deg"], tx["zoom"]))
    from horizonator_tpu_torch.api import horizonator
    api = horizonator(*c["view_latlon"], m["width"], m["height"],
                      render_texture=True, dir_dems=str(dems),
                      dir_tiles=str(cache), tiles_name=tx["name"],
                      allow_downloads=False,
                      render_radius_cells=c["radius_cells"],
                      device=str(ctx.device),
                      texture_quality=tx["quality"],
                      exact_near_m=tx["exact_near_m"], strict_coverage=True)
    return {"api": api}


def _atlas(ctx) -> render_tex.Atlas:
    if "atlas" not in ctx.inputs:
        win, t = _api._window(ctx), ctx.inputs["tiles"]
        cpd = win.cpd
        ctx.inputs["atlas"] = render_tex.Atlas(
            render_tex.pack_atlas(t.pixels, t.x_lo, t.y_lo, t.x_hi, t.y_hi,
                                  ctx.device),
            origin_lon=win.origin_dem[0] + win.origin_cell[0] / cpd,
            origin_lat=win.origin_dem[1] + win.origin_cell[1] / cpd,
            x_lo=t.x_lo, y_lo=t.y_lo, zoom=t.zoom)
    return ctx.inputs["atlas"]


def reference(ctx, req, dtype):
    c, m = ctx.config, ctx.mix
    win = _api._window(ctx)
    cpd = c["dem"]["cells_per_deg"]
    if "dem" not in ctx.inputs:
        ctx.inputs["dem"] = torch.from_numpy(
            win.grid.astype(np.float32)).to(ctx.device)
    at = _atlas(ctx)
    key = ("planes", dtype)
    if key not in ctx.inputs:
        ctx.inputs[key] = render_tex.color_planes(at, win.grid.shape[0],
                                                  cpd, dtype)
    lat, lon = req["lat"], req["lon"]
    ci, cj = win.cell(lat, lon)
    znear, zfar = c["znear_m"], c["zfar_m"]
    v = ref.make_view(ctx.device, vi=ci, vj=cj, vz=win.viewer_z(lat, lon),
                      cos_lat=math.cos(math.radians(lat)),
                      az0=math.radians(m["az_deg"][0]),
                      az1=math.radians(m["az_deg"][1]), znear=znear,
                      zfar=zfar, znear_color=znear, zfar_color=zfar)
    img, rng = render_tex.render(
        ctx.inputs["dem"], at, ctx.inputs[key], v, width=m["width"],
        height=m["height"],
        k_cross=ref.k_cross_for(zfar, cpd, lat, n=win.grid.shape[0]),
        cells_per_deg=cpd, lat_hint_deg=round(lat / 10.0) * 10.0,
        znear_hint_m=max(128.0, 2.0 ** math.ceil(math.log2(max(znear, 1.0)))),
        exact_near_m=c["texture_tiles"]["exact_near_m"], dtype=dtype)
    return img.cpu().numpy(), rng.cpu().numpy()


def tiny(mix, config):
    """Cut the mix, the window, the clip and so the atlas (~50 tiles) to
    sizes the CPU runs in seconds."""
    mix.update(width=128, height=64, check_requests=3)
    mix["viewpoints"]["box_deg"] = 0.05
    config.update(radius_cells=300, zfar_m=5000.0)


def _altered(monkeypatch):
    """The textured window march's far field raised by 0.1 in its first
    quarter of columns at every valid sample (``faults.altered_march`` on
    the textured entry, which that fault does not reach)."""
    import horizonator_tpu_torch.render.window as window
    real = window.march_textured

    def march_textured(dem, pcol, fscal, k, *a, **kw):
        out, tex = real(dem, pcol, fscal, k, *a, **kw)
        bad = out[..., : max(1, out.shape[-2] // 4), :]
        bad.copy_(torch.where(bad > -1e38, bad + 0.1, bad))
        return out, tex
    monkeypatch.setattr(window, "march_textured", march_textured)


def _atlas_shift(monkeypatch):
    """The program's atlas, as its hybrid near field reads it, moved one
    texel east."""
    import horizonator_tpu_torch.render.window as window
    real = window._exact_near_colors
    monkeypatch.setattr(window, "_exact_near_colors",
                        lambda atlas, *a, **kw: real(
                            torch.roll(atlas, 1, dims=1), *a, **kw))


def _hybrid_off(monkeypatch):
    """The program's hybrid near field skipped: every colour from the
    half-cell planes."""
    import horizonator_tpu_torch.render.window as window
    monkeypatch.setattr(window, "_hybrid_near_field",
                        lambda tex, *a, **kw: tex)


def planted_faults() -> dict:
    return {"altered": _altered, "atlas_shift": _atlas_shift,
            "hybrid_off": _hybrid_off}


def work(ctx, req) -> dict:
    c, m = ctx.config, ctx.mix
    win = _api._window(ctx)
    ci, cj = win.cell(req["lat"], req["lon"])
    kw = dict(width=m["width"], zfar_m=c["zfar_m"],
              cpd=c["dem"]["cells_per_deg"], lat_deg=req["lat"])
    n = win.grid.shape[0]
    return {"march": roofline_tex.march_bound_s(n, [ci], [cj],
                                                device=ctx.device, **kw),
            "resolve": roofline_tex.resolve_bound_s(n, 1,
                                                    height=m["height"], **kw)}
