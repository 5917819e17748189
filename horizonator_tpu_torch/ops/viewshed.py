"""Viewshed and visibility analysis on the ray marches.

Counterpart of horizonator_tpu.ops.viewshed, for its three samplers: the
window march (the kernel path), the grid-crossing march and the
uniform-step march (the oracles, and the JAX defaults: "step" for the
polar field and the raster, "crossing" for the sweep):

- ``viewshed_polar``: per (azimuth column, sample) visibility of one
  viewpoint: a sample is visible iff its elevation tangent reaches the
  running horizon of everything nearer in its column;
- ``viewshed_grid``: the GIS raster of (2 hw)^2 cells around the viewer, or
  around a fixed frame centre, resampled from the polar field;
- ``horizon_sweep`` / ``viewshed_sweep``: the horizon profile (max tangent
  per column) of many viewpoints;
- ``viewshed_count``: per-cell observer counts over one fixed frame.

Many viewpoints are one axis of the march: RenderParams with (B,) fields go
through one batched window-march launch per chunk (``parallel.sharding``'s
``chunk_size`` under ``BATCH_BYTES``), and every viewpoint of a batch is
bitwise its single march's. ``viewshed_grid`` takes (B,) params too and
returns (B, 2 hw, 2 hw).

The contract raster (``method="contract"``) tests each cell's own bilinear
elevation tangent against its polar column's horizon strictly nearer than
the cell, ``th = max{tanel[x, k] : d[x, k] < r}`` with x the cell's column
and r its radius along that column less half a crossing step: keyed by
output row (r = north / cos az_x) where |north| >= |east|, else by output
column (r = east / sin az_x). The JAX package evaluates these masked maxima
as gather-free contractions over quarter arcs, a layout for the TPU. Here
the resampler is ``kernels/viewshed_resample.resample``, two CUDA kernels
on a card and their plain version on the CPU: each column's samples
sorted by distance once with a running max, then each cell computes its
own radius and finds its horizon by one binary search, ``run_max[#{d <
r} - 1]``, the masked max exactly, whatever the order of the distances;
``viewshed_count`` adds each batch into its count inside it, with no
raster. ``plain=True`` takes the direct masked max instead (and the
march's plain version), through (2 hw, W) tables per region that each
cell gathers its entry from: the oracle that the resampler equals bit for
bit.

Under ``full_circle`` the JAX package's quarter-arc forms leave a cell
uncovered when its column lies outside the W/8 + 8 columns that its
quadrant can select on an honest full circle; such a cell reads the empty
horizon, and ``with_dropped`` counts it. The port reproduces that coverage
rule and its count (``_arc_covered``).

The samplers differ in what a column's samples are, and so in the
distances ``d`` that the resamplers key on and in the contract raster's
guard band below a cell (half a crossing step for the crossing marches,
half the cell's footprint along the ray for the uniform steps); the gather
raster inverts each sampler's own distance map. ``dem`` is a float32 grid
for every sampler; the crossing sampler also takes a
render.crossing.CrossingScene and the step sampler a pack_dem_pairs plane
(both then resample with "gather", as "auto" picks for them).

``mesh=`` (viewshed_sweep, viewshed_count): "auto" or a DeviceMesh with a
"batch" dim (parallel.mesh); each batch of viewpoints splits over its
ranks, with the DEM replicated. The sweep's profiles are all-gathered and
the count's per-rank partial counts summed by one all-reduce, so every
rank returns the whole result. An ``aligned_scene`` (the port marches
without AlignedScene tables) raises NotImplementedError.

A window march takes a rectangular grid as the JAX package's does. The
sweeps' viewer elevations read a pack_dem_pairs plane whose row stride the
JAX package takes from the grid's row count (viewshed.py:1007-1009), right
only for a square grid: the sweeps here refuse other grids.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed

from .. import geometry, profiling
from ..geometry import const, recip
from ..kernels.viewshed_resample import ARC_THETA, resample
from ..parallel.sharding import (BATCH_BYTES, SAMPLE_BYTES, chunk_size,
                                 samples_per_column)
from ..render.crossing import (N_NEAR, NEG_BIG, CrossingScene,
                               crossing_geometry, crossing_geometry_at,
                               k_cross_for, march_crossing, pack_scene)
from ..render.raymarch import (RenderParams, _as_packed, _sample_surface,
                               broadcast_params_batch, cols, march_tanel,
                               samples)
from ..render.window import march_from_geometry

DEG = math.pi / 180.0
# the empty masked max; the march's invalid samples hold the same value
NEG = NEG_BIG
# device bytes a raster holds per output cell (its angles, columns, masks,
# elevation, horizon and result) and per table entry (radius, count,
# value), for the chunking of a batch of rasters
RASTER_CELL_BYTES, TABLE_BYTES = 96, 32
# the most device memory one chunk of the direct masked max may hold
DIRECT_BYTES = 1 << 30


SAMPLERS = ("window", "crossing", "step")


def _check_port(fn: str, sampler: str, aligned_scene=None):
    if sampler not in SAMPLERS:
        raise ValueError(f"{fn}: unknown sampler {sampler!r}")
    if aligned_scene is not None:
        raise NotImplementedError(
            f"{fn}: aligned_scene= is not ported (the port marches without "
            f"AlignedScene tables); pass None")


def _check_grid(fn: str, dem, sampler: str):
    """The window march takes one 2-D float grid, square or not."""
    if sampler == "window" and dem.dim() != 2:
        raise ValueError(f"{fn}: the window sampler takes a 2-D elevation "
                         f"grid, got {tuple(dem.shape)}")


def _batch_mesh(fn: str, mesh, batch: int, device):
    """(mesh, ranks on "batch", this rank's index) of a sweep's ``mesh``;
    ``batch`` must divide over the ranks (viewshed.py:1066-1070)."""
    from ..parallel.mesh import coord, dim_size, resolve_mesh
    mesh = resolve_mesh(mesh, ("batch",), device)
    n_b = dim_size(mesh, "batch")
    if batch % n_b:
        raise ValueError(f"batch {batch} not divisible by mesh batch axis "
                         f"{n_b}")
    return mesh, n_b, coord(mesh, "batch")


def _is_packed(dem) -> bool:
    """A pack_dem_pairs plane: (N, N-1) int32."""
    return (isinstance(dem, torch.Tensor) and dem.dtype == torch.int32
            and dem.dim() == 2 and dem.shape[1] == dem.shape[0] - 1)


def _march(dem, p: RenderParams, *, sampler, width, nsteps, cells_per_deg,
           surface, lat_hint_deg, znear_hint_m, plain):
    """(tanel, d, half, az, guard) of the sampler's march: tangents and
    their distances (W, K), the contract raster's guard band (W,), the
    column azimuths (W,) and the int32 guard dropped + truncated (0 for
    the oracle samplers, which mask nothing); (B,) params give a leading
    B, one window-march launch for the batch."""
    if sampler == "step":
        tanel, _, d, az = march_tanel(dem, p, width=width, nsteps=nsteps,
                                      cells_per_deg=cells_per_deg,
                                      surface=surface)
        # the band covers the cell's own footprint along the ray, the
        # dominant axis's spacing (viewshed.py:337-343)
        cell_n = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
        cell_e = cols(cell_n * p.cos_viewer_lat)
        eps = const(1e-6, az)
        half = 0.5 * torch.minimum(
            cell_n / torch.maximum(torch.cos(az).abs(), eps),
            cell_e / torch.maximum(torch.sin(az).abs(), eps))
        guard = torch.zeros(p.znear.shape, dtype=torch.int32,
                            device=tanel.device)
        return tanel, d[..., None, :].expand_as(tanel), half, az, guard
    if sampler == "crossing":
        scene = dem if isinstance(dem, CrossingScene) else pack_scene(dem)
        tanel, _, dists, az = march_crossing(
            scene, p, width=width, k_cross=nsteps,
            cells_per_deg=cells_per_deg)
        guard = torch.zeros(p.znear.shape, dtype=torch.int32,
                            device=tanel.device)
    else:
        geo = crossing_geometry(p, width=width, cells_per_deg=cells_per_deg)
        tanel, dists = march_from_geometry(
            dem, p, geo, k_cross=nsteps, cells_per_deg=cells_per_deg,
            lat_hint_deg=lat_hint_deg, znear_hint_m=znear_hint_m,
            plain=plain)
        az = geo.az
        guard = dists.dropped + dists.truncated
    return tanel, _distances(dists, tanel), 0.5 * dists.scale, az, guard


def _distances(dists, tanel: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(tanel.shape[-1], dtype=torch.int32,
                       device=tanel.device)
    return dists.d_of(idx.expand(tanel.shape))


def _visible(tanel: torch.Tensor) -> torch.Tensor:
    """Samples at or above the running max of everything before them, and
    valid (raymarch.py's visibility scan)."""
    run_max = torch.cummax(tanel, dim=-1).values
    prev = torch.cat([torch.full_like(run_max[..., :1], NEG),
                      run_max[..., :-1]], dim=-1)
    return (tanel >= prev) & (tanel > -1.0e38)


def viewshed_polar(dem, params: RenderParams, *, width, nsteps,
                   cells_per_deg, surface="bilinear", sampler="step",
                   lat_hint_deg=45.0, znear_hint_m=100.0, with_dropped=False,
                   aligned_scene=None, plain=False):
    """Polar visibility field of one viewpoint: (visible (W, K) bool, tanel
    (W, K), d, az (W,)), plus the int32 guard dropped + truncated under
    ``with_dropped`` (0 for the oracle samplers). ``d`` is (W, K) for the
    crossing samplers (their near band and crossings) and (K,) for the
    uniform steps, which every column shares. (B,) params give a leading
    B and (B,) guards. ``surface`` is read by the step sampler alone
    (crossings are exact on both surfaces)."""
    _check_port("viewshed_polar", sampler, aligned_scene)
    _check_grid("viewshed_polar", dem, sampler)
    p = broadcast_params_batch(params)
    tanel, d, _, az, guard = _march(
        dem, p, sampler=sampler, width=width, nsteps=nsteps,
        cells_per_deg=cells_per_deg, surface=surface,
        lat_hint_deg=lat_hint_deg, znear_hint_m=znear_hint_m, plain=plain)
    if sampler == "step":
        d = d[..., 0, :]
    out = (_visible(tanel), tanel, d, az)
    return out + (guard,) if with_dropped else out


def _lift(p: RenderParams) -> RenderParams:
    """(B,) fields, B = 1 for a single viewpoint."""
    p = broadcast_params_batch(p)
    return RenderParams(*(x.reshape(-1) for x in p))


def _frame(p: RenderParams, hw: int, out_center_ij, cells_per_deg: int,
           width: int):
    """The output frame of a (B,) batch: per row the north offset nn (B,
    P2) (axis 0, j), per column the east offset ee (B, P2) (axis 1, i), and
    per cell (B, P2, P2) the distance, the polar column xc (int64) and the
    in-window and in-range masks (viewshed.py:186-212, :421-440)."""
    dev = p.viewer_cell_i.device
    off = torch.arange(2 * hw, dtype=torch.float32, device=dev) - hw + 0.5
    di = off.expand(p.viewer_cell_i.shape[0], -1)
    dj = di
    if out_center_ij is not None:
        ci, cj = out_center_ij
        di = (off + float(ci)) - p.viewer_cell_i[:, None]
        dj = (off + float(cj)) - p.viewer_cell_j[:, None]
    cell_n = const(geometry.EARTH_RADIUS_M * DEG / cells_per_deg, off)
    cell_e = cell_n * p.cos_viewer_lat
    nn = dj * cell_n
    ee = di * cell_e[:, None]
    e, n = ee[:, None, :], nn[:, :, None]
    _, az_center, az_ndc_per_rad = geometry.az_window_rad(p.az_rad0,
                                                          p.az_rad1)
    az = geometry.unwrap_near_rad(torch.atan2(e, n), samples(az_center))
    x_ndc = (az - samples(az_center)) * samples(az_ndc_per_rad)
    xcol = torch.round((x_ndc + 1.0) * 0.5 * width - 0.5)
    xc = torch.clamp(xcol, 0, width - 1).to(torch.int64)
    in_az = (x_ndc >= -1.0) & (x_ndc <= 1.0)
    dist = torch.sqrt(e * e + n * n)
    in_r = (dist >= samples(p.znear)) & (dist <= samples(p.zfar))
    return dict(di=di, dj=dj, nn=nn, ee=ee, dist=dist, xc=xc, in_az=in_az,
                in_r=in_r, az_center=az_center,
                az_ndc_per_rad=az_ndc_per_rad)


def _gather_index(p, f, ktot: int, *, width, cells_per_deg,
                  step_nsteps=None) -> torch.Tensor:
    """(B, P2, P2) int64: the index into a (W, K) polar field of the
    sample nearest each cell (viewshed.py:214-269, unaligned lanes): the
    uniform steps' index of the cell's distance when ``step_nsteps`` is
    given, else its column's closed-form DDA inverted at that distance."""
    xc, dist = f["xc"], f["dist"]
    znear = samples(p.znear)
    if step_nsteps is not None:
        step = samples((p.zfar - p.znear) * recip(step_nsteps))
        kc = torch.clamp(torch.round((dist - znear) / step - 0.5), 0,
                         step_nsteps - 1).to(torch.int64)
    else:
        q = N_NEAR
        az_col = samples(f["az_center"]) + (
            (2.0 * (xc.to(torch.float32) + 0.5)) * recip(width) - 1.0
        ) / samples(f["az_ndc_per_rad"])
        geo = crossing_geometry_at(p, az_col.reshape(xc.shape[0], -1),
                                   cells_per_deg)
        e_x, sc_x = (v.view_as(dist) for v in (geo.e, geo.scale))
        m_star = torch.clamp(torch.ceil(znear / sc_x - e_x), min=0.0)
        nh_x = torch.maximum((m_star + e_x) * sc_x, znear)
        stepn = torch.clamp(nh_x - znear, min=1e-6) * recip(max(q, 1))
        k_near = torch.clamp(torch.round((dist - znear) / stepn), 0,
                             max(q - 1, 0))
        m = torch.clamp(torch.round(dist / sc_x - e_x), 0,
                        max(ktot - q - 1, 0))
        kc = torch.where(dist < nh_x, k_near, q + m).to(torch.int64)
    return xc * ktot + kc


def _gather_raster(tanel, p, f, *, width, cells_per_deg, step_nsteps=None):
    """Visibility of the polar sample nearest each cell (_gather_index)."""
    visible = _visible(tanel)
    b = visible.shape[0]
    with profiling.phase("hz.viewshed.gather_index"):
        idx = _gather_index(p, f, visible.shape[-1], width=width,
                            cells_per_deg=cells_per_deg,
                            step_nsteps=step_nsteps)
    vis = torch.gather(visible.reshape(b, -1), 1,
                       idx.reshape(b, -1)).view_as(idx)
    return vis & f["in_az"] & f["in_r"]


def _cell_tangent(dem, p, f, hw: int, surface: str):
    """Each cell's own elevation tangent from 4 shifted slices of an
    edge-padded window (unit output spacing, so one fractional weight pair
    for the whole raster), and the in-grid mask (viewshed.py:451-486)."""
    n0, n1 = dem.shape
    dev = dem.device
    pj = p.viewer_cell_j[:, None] + f["dj"]
    pi = p.viewer_cell_i[:, None] + f["di"]
    pad, s = hw + 2, 2 * hw + 2
    j0, i0 = torch.floor(pj[:, 0]), torch.floor(pi[:, 0])
    fj, fi = samples(pj[:, 0] - j0), samples(pi[:, 0] - i0)
    js = torch.clamp(j0 + pad, 0, n0 + 2 * pad - s).to(torch.int64)
    is_ = torch.clamp(i0 + pad, 0, n1 + 2 * pad - s).to(torch.int64)
    u = torch.arange(s, device=dev)
    rows = torch.clamp(js[:, None] + u - pad, 0, n0 - 1)
    columns = torch.clamp(is_[:, None] + u - pad, 0, n1 - 1)
    win = dem.to(torch.float32)[rows[:, :, None], columns[:, None, :]]
    w00, w01 = win[:, :-2, :-2], win[:, :-2, 1:-1]
    w10, w11 = win[:, 1:-1, :-2], win[:, 1:-1, 1:-1]
    if surface == "triangulated":
        # the whole raster lies in one triangle half of its cells
        z_lower = w00 + (w01 - w00) * fi + (w11 - w01) * fj
        z_upper = w00 + (w11 - w10) * fi + (w10 - w00) * fj
        z = torch.where(fj <= fi, z_lower, z_upper)
    else:
        z = ((1 - fj) * (1 - fi) * w00 + (1 - fj) * fi * w01
             + fj * (1 - fi) * w10 + fj * fi * w11)
    dist = f["dist"]
    t_cell = (z - samples(p.viewer_z)) / dist - dist * samples(p.curv)
    ing = (((pj >= 0) & (pj <= n0 - 1))[:, :, None]
           & ((pi >= 0) & (pi <= n1 - 1))[:, None, :])
    return t_cell, ing


def _tables_direct(tanel, d, radii):
    """T[..., x, v] = max{tanel[..., x, k] : d[..., x, k] < r[..., x, v]}
    for each radius array r of ``radii``, NEG where the set is empty: the
    direct masked max, chunked."""
    b, w, k = tanel.shape
    out = []
    for r in radii:
        m = r.shape[-1]
        step = max(1, min(m, DIRECT_BYTES // (5 * w * k)))
        out.append(torch.stack([torch.cat([
            torch.where(d[v, :, None, :] < r[v, :, s:s + step, None],
                        tanel[v, :, None, :], NEG).amax(dim=-1)
            for s in range(0, m, step)], dim=-1) for v in range(b)]))
    return out


def _arc_covered(f, region_a, width: int):
    """Whether each cell's column lies on the quarter arc that its quadrant
    selects in the JAX package's full-circle forms (viewshed.py:612-645,
    :775-778): SQ = min(W, W // 8 + 8) columns from floor(xf) - 2 mod W,
    the quadrant from the signs of the cell's north and east offsets."""
    sq = min(width, width // 8 + 8)
    az_center = f["az_center"]
    with profiling.sync():
        theta0 = torch.tensor(ARC_THETA, dtype=torch.float32).to(
            az_center.device)
    xf = (((theta0 - az_center[:, None]) + math.pi) * width
          * recip(2.0 * math.pi) - 0.5)
    start = torch.remainder(torch.floor(xf) - 2.0, width).to(torch.int64)
    arc = ((~region_a).to(torch.int64) * 4
           + (f["nn"] >= 0.0).to(torch.int64)[:, :, None] * 2
           + (f["ee"] >= 0.0).to(torch.int64)[:, None, :])
    s = torch.gather(start, 1, arc.reshape(arc.shape[0], -1)).view_as(arc)
    return torch.remainder(f["xc"] - s, width) < sq


def _contract_raster(dem, tanel, d, half, az_cols, p, f, *, hw, surface,
                     full_circle):
    """(visible (B, P2, P2), uncovered (B,) int32) of the contract
    resampler as the direct masked max, the oracle (viewshed.py:372-579;
    the quarter-arc forms :582-898 through ``_arc_covered``)."""
    with profiling.phase("hz.viewshed.cell_tangent"):
        t_cell, ing = _cell_tangent(dem, p, f, hw, surface)
    mask = f["in_az"] & f["in_r"] & ing
    nn, ee, xc = f["nn"], f["ee"], f["xc"]
    region_a = nn.abs()[:, :, None] >= ee.abs()[:, None, :]
    half = half[:, :, None]
    r_a = nn[:, None, :] / torch.cos(az_cols)[:, :, None] - half  # (B, W, P2)
    r_b = ee[:, None, :] / torch.sin(az_cols)[:, :, None] - half
    with profiling.phase("hz.viewshed.tables"):
        t_a, t_b = _tables_direct(tanel, d, (r_a, r_b))
    th = torch.where(region_a, torch.gather(t_a.transpose(1, 2), 2, xc),
                     torch.gather(t_b, 1, xc))
    uncovered = torch.zeros(xc.shape[0], dtype=torch.int32, device=xc.device)
    if full_circle:
        with profiling.phase("hz.viewshed.arc_cover"):
            covered = _arc_covered(f, region_a, tanel.shape[1])
            th = torch.where(covered, th, NEG)
            uncovered = (mask & ~covered).sum(dim=(1, 2), dtype=torch.int32)
    return (t_cell >= th) & mask, uncovered


def _contract(dem, tanel, d, half, az_cols, p, *, hw, center,
              cells_per_deg, surface, full_circle, total):
    """``_contract_raster`` through the resampler (kernels/
    viewshed_resample.py): (visible, uncovered), or, given ``total``, the
    count's sum added into it and (None, 0). The columns' cos, sin and
    half step come from torch, as the oracle computes them; the counter
    ``hz.kernels.resample`` counts the calls that launched the kernels."""
    colv = torch.stack([torch.cos(az_cols), torch.sin(az_cols), half, half],
                       dim=-1)
    launches = resample.launches
    with profiling.phase("hz.kernels.resample"):
        out = resample(
            dem.to(torch.float32).contiguous(), tanel.contiguous(),
            d.contiguous(), torch.stack(list(p), dim=1), colv, hw=hw,
            cell_n=geometry.EARTH_RADIUS_M * DEG / cells_per_deg,
            center=center, triangulated=surface == "triangulated",
            full_circle=full_circle, total=total)
    if resample.launches != launches:
        profiling.count("hz.kernels.resample",
                        resample.launches - launches)
    return (None, 0) if total is not None else out


def _raster_chunk(b: int, width: int, k: int, hw: int) -> int:
    """The most rasters of a batch of b that one chunk computes under
    ``BATCH_BYTES`` (at least one): each holds its march's W*K samples,
    (2 hw)^2 cells and two (W, 2 hw) tables."""
    p2 = 2 * hw
    one = width * k * SAMPLE_BYTES + p2 * p2 * RASTER_CELL_BYTES \
        + 2 * width * p2 * TABLE_BYTES
    return max(1, min(b, BATCH_BYTES // one))


def viewshed_grid(dem, params: RenderParams, *, width, nsteps,
                  cells_per_deg, surface="bilinear", out_halfwidth=None,
                  sampler="step", lat_hint_deg=45.0, znear_hint_m=100.0,
                  with_dropped=False, aligned_scene=None, out_center_ij=None,
                  method="auto", row_chunk=None, full_circle=False,
                  plain=False):
    """GIS visibility raster of the (2 hw)^2 cells around the viewer (or
    around ``out_center_ij``, float (i, j) cell coords of a fixed frame):
    (2 hw, 2 hw) bool, row 0 south, column 0 west; False nearer than znear,
    beyond zfar, outside the azimuth window or the grid.

    ``method``: "contract" (each cell's own tangent against its column's
    horizon strictly nearer, see the module docstring; it needs the float
    elevation grid), "gather" (the visibility of the polar sample nearest
    the cell) or "auto" (contract for the crossing samplers on a float
    grid, gather for the step sampler and for packed scenes, as in the JAX
    package). ``full_circle`` promises a 360-degree window: cells outside
    the quarter arcs of the JAX package's full-circle forms then read the
    empty horizon and count in the ``with_dropped`` guard (dropped +
    truncated + uncovered, int32). ``row_chunk`` is accepted for
    signature parity; a batch is chunked under ``BATCH_BYTES``.

    (B,) params give (B, 2 hw, 2 hw) rasters and (B,) guards, the batch
    marched at once per chunk. ``plain`` runs the march's plain version
    and the direct masked max."""
    return _grid(dem, params, width=width, nsteps=nsteps,
                 cells_per_deg=cells_per_deg, surface=surface,
                 out_halfwidth=out_halfwidth, sampler=sampler,
                 lat_hint_deg=lat_hint_deg, znear_hint_m=znear_hint_m,
                 with_dropped=with_dropped, aligned_scene=aligned_scene,
                 out_center_ij=out_center_ij, method=method,
                 full_circle=full_circle, plain=plain)


def _grid(dem, params, *, width, nsteps, cells_per_deg, surface,
          out_halfwidth, sampler, lat_hint_deg, znear_hint_m, with_dropped,
          aligned_scene, out_center_ij, method, full_circle, plain,
          total=None):
    """viewshed_grid; given ``total``, a count's (2 hw, 2 hw) int32 sum,
    the contract resampler adds each chunk's visible viewpoints into it
    and no raster is returned (None), while the gather resampler and
    ``plain=True`` return their rasters for the caller to sum."""
    _check_port("viewshed_grid", sampler, aligned_scene)
    if out_halfwidth is None:
        raise ValueError("out_halfwidth is required")
    if surface not in ("bilinear", "triangulated"):
        raise ValueError(f"unknown surface mode {surface!r}")
    raw_grid = (isinstance(dem, torch.Tensor) and dem.dim() == 2
                and not _is_packed(dem))
    if method == "auto":
        method = "contract" if raw_grid and sampler != "step" else "gather"
    if method not in ("contract", "gather"):
        raise ValueError(f"unknown method {method!r}")
    if method == "contract" and not raw_grid:
        raise TypeError(
            "method='contract' needs the raw 2D elevation grid (the cell "
            f"test samples terrain heights); got {type(dem).__name__} -- "
            "pass the float grid or method='gather'")
    _check_grid("viewshed_grid", dem, sampler)
    if sampler == "crossing" and not isinstance(dem, CrossingScene):
        scene = pack_scene(dem)       # once for the batch
    else:
        scene = _as_packed(dem)[0] if sampler == "step" else dem
    hw = int(out_halfwidth)
    single = broadcast_params_batch(params).viewer_cell_i.dim() == 0
    p = _lift(params)
    b = p.viewer_cell_i.shape[0]
    step = _raster_chunk(b, width, samples_per_column(dem, sampler, nsteps),
                         hw)
    vis, guard = [], []
    for s in range(0, b, step):
        q = RenderParams(*(x[s:s + step] for x in p))
        with profiling.phase("hz.viewshed.march"):
            tanel, d, half, az_cols, g = _march(
                scene, q, sampler=sampler, width=width, nsteps=nsteps,
                cells_per_deg=cells_per_deg, surface=surface,
                lat_hint_deg=lat_hint_deg, znear_hint_m=znear_hint_m,
                plain=plain)
        with profiling.phase("hz.viewshed.resample"):
            if method == "contract" and not plain:
                v, uncovered = _contract(
                    dem, tanel, d, half, az_cols, q, hw=hw,
                    center=out_center_ij, cells_per_deg=cells_per_deg,
                    surface=surface, full_circle=full_circle, total=total)
            else:
                with profiling.phase("hz.viewshed.frame"):
                    f = _frame(q, hw, out_center_ij, cells_per_deg, width)
                if method == "contract":
                    v, uncovered = _contract_raster(
                        dem, tanel, d, half, az_cols, q, f, hw=hw,
                        surface=surface, full_circle=full_circle)
                else:
                    v = _gather_raster(
                        tanel, q, f, width=width,
                        cells_per_deg=cells_per_deg,
                        step_nsteps=nsteps if sampler == "step" else None)
                    uncovered = 0
        if v is not None:
            vis.append(v)
        guard.append(g + uncovered)
    vis = torch.cat(vis) if vis else None
    guard = torch.cat(guard)
    if single:
        vis, guard = vis[0], guard[0]
    return (vis, guard) if with_dropped else vis


def horizon_sweep(dem, params_batch: RenderParams, *, width, nsteps,
                  cells_per_deg, surface="bilinear", sampler="step",
                  lat_hint_deg=45.0, znear_hint_m=100.0, aligned_scene=None,
                  plain=False):
    """(B,) stacked viewpoints -> (B, W) horizon tangents, the max of each
    column's samples, in chunks under ``BATCH_BYTES`` (``chunk_size``); the
    window sampler marches a chunk in one launch. ``dem`` as the sampler
    takes it (module docstring); ``lat_hint_deg`` sizes the window march's
    near patch: pass the viewer latitude."""
    _check_port("horizon_sweep", sampler, aligned_scene)
    _check_grid("horizon_sweep", dem, sampler)
    p = broadcast_params_batch(params_batch)
    if p.viewer_cell_i.dim() != 1:
        raise ValueError(f"horizon_sweep takes RenderParams with (B,) "
                         f"fields, got {tuple(p.viewer_cell_i.shape)}")
    if sampler == "crossing" and not isinstance(dem, CrossingScene):
        dem = pack_scene(dem)
    elif sampler == "step":
        dem = _as_packed(dem)[0]
    b = p.viewer_cell_i.shape[0]
    step = chunk_size(b, width, 0, samples_per_column(dem, sampler, nsteps))
    outs = []
    for s in range(0, b, step):
        with profiling.phase("hz.viewshed.march"):
            tanel = _march(
                dem, RenderParams(*(x[s:s + step] for x in p)),
                sampler=sampler, width=width, nsteps=nsteps,
                cells_per_deg=cells_per_deg, surface=surface,
                lat_hint_deg=lat_hint_deg, znear_hint_m=znear_hint_m,
                plain=plain)[0]
            outs.append(tanel.amax(dim=-1))
    return torch.cat(outs)


def _on_device(x, device) -> torch.Tensor:
    """``x`` (a numpy array or a tensor) on ``device``: a numpy array, or a
    tensor that crosses between the host and a card, is a copy that the
    host waits for (a sync); a tensor already on the device's kind is
    not."""
    dev = torch.device(device)
    if isinstance(x, torch.Tensor) and ((x.device.type == "cpu")
                                        == (dev.type == "cpu")):
        return x.to(dev)
    with profiling.sync():
        return (x if isinstance(x, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(x))).to(dev)


def _sweep_prep(dem, viewpoints_ij, viewer_height_m, *, nsteps,
                cells_per_deg, zfar, cos_viewer_lat, lat_deg, device,
                sampler="window"):
    """Shared prep of the viewpoint sweeps (viewshed.py:982-1035): the
    sampler's scene on ``device`` (the float32 grid for the window march,
    a CrossingScene, or the pair-packed plane for the uniform steps), the
    viewpoints, their elevations (the bilinear terrain of the 0.5 m pair
    planes + viewer_height_m), the step budget (k_cross_for, or 512
    uniform steps), the latitude hint and cos_viewer_lat (either derives
    the other)."""
    if cos_viewer_lat is None:
        cos_viewer_lat = (math.cos(math.radians(lat_deg))
                          if lat_deg is not None else 1.0)
    dem_t = _on_device(dem, device)
    if sampler != "step" and _is_packed(dem_t):
        raise TypeError("viewpoint sweeps with sampler='crossing'/'window' "
                        "need the elevation grid, not a pack_dem_pairs "
                        "plane")
    if dem_t.dim() != 2 or (dem_t.shape[0] != dem_t.shape[1]
                            and not _is_packed(dem_t)):
        raise ValueError(f"viewpoint sweeps take a square grid (the viewer "
                         f"elevations' pair plane), got "
                         f"{tuple(dem_t.shape)}")
    packed, n = _as_packed(dem_t)
    pts = _on_device(np.asarray(viewpoints_ij, np.float32).reshape(-1, 2),
                     device)
    vz = _sample_surface(packed, n, pts[:, 0], pts[:, 1],
                         "bilinear") + viewer_height_m
    lat_hint = 45.0
    if sampler == "step":
        scene = packed
        if nsteps is None:
            nsteps = 512
    else:
        if lat_deg is None:
            lat_deg = math.degrees(math.acos(min(1.0, cos_viewer_lat)))
        if nsteps is None:
            nsteps = k_cross_for(zfar, cells_per_deg, lat_deg, n=n)
        lat_hint = float(lat_deg)
        grid = dem_t.to(torch.float32)
        scene = pack_scene(grid) if sampler == "crossing" else grid
    return scene, pts, vz, nsteps, lat_hint, cos_viewer_lat


def _observer_params(pts, vz, cos_viewer_lat, znear, zfar) -> RenderParams:
    """(B,) params of full-circle observers at ``pts`` (B, 2), ``vz`` (B,)."""
    def full(v):
        return torch.full(vz.shape, v, dtype=torch.float32,
                          device=vz.device)
    return RenderParams(pts[:, 0], pts[:, 1], vz, full(cos_viewer_lat),
                        full(-math.pi), full(math.pi), full(znear),
                        full(zfar), full(znear), full(zfar), full(0.0))


def viewshed_sweep(dem, viewpoints_ij, *, viewer_height_m=2.0, width=256,
                   nsteps=None, cells_per_deg=1200, znear=50.0, zfar=20000.0,
                   cos_viewer_lat=None, batch=256, surface="bilinear",
                   sampler="crossing", lat_deg=None, mesh=None,
                   device="cuda", plain=False):
    """Horizon profiles of many viewpoints: (N, width) from (N, 2) float
    cell coords ``viewpoints_ij``, observers ``viewer_height_m`` above the
    terrain, full circles, in batches of ``batch`` (horizon_sweep). ``dem``:
    a square elevation grid (numpy or tensor, int16 accepted; the step
    sampler also takes its pack_dem_pairs plane), moved to ``device``.
    The default sampler is the crossing march, as in the JAX package;
    ``surface`` applies to the step sampler. ``mesh``: each batch splits
    over the ranks of its "batch" dim (the module docstring); the last
    batch is padded with the last viewpoint, as in the JAX package."""
    with profiling.phase("hz.ops.viewshed_sweep"):
        _check_port("viewshed_sweep", sampler)
        with profiling.phase("hz.ops.sweep_prep"):
            dem_f, pts, vz, nsteps, lat_hint, cos_lat = _sweep_prep(
                dem, viewpoints_ij, viewer_height_m, sampler=sampler,
                nsteps=nsteps, cells_per_deg=cells_per_deg, zfar=zfar,
                cos_viewer_lat=cos_viewer_lat, lat_deg=lat_deg, device=device)
        profiling.count("hz.viewpoints", pts.shape[0])
        kw = dict(width=width, nsteps=nsteps, cells_per_deg=cells_per_deg,
                  surface=surface, sampler=sampler, lat_hint_deg=lat_hint,
                  znear_hint_m=float(znear), plain=plain)
        nview = pts.shape[0]
        if mesh is None:
            return torch.cat([horizon_sweep(dem_f, _observer_params(
                pts[s:s + batch], vz[s:s + batch], cos_lat, znear, zfar), **kw)
                for s in range(0, nview, batch)])
        from ..parallel.mesh import all_gather
        mesh, n_b, idx = _batch_mesh("viewshed_sweep", mesh, batch, device)
        pts, vz = _pad_last(pts, vz, batch)
        step = batch // n_b
        outs = []
        for s in range(0, pts.shape[0], batch):
            lo = s + idx * step
            mine = horizon_sweep(dem_f, _observer_params(
                pts[lo:lo + step], vz[lo:lo + step], cos_lat, znear, zfar),
                **kw)
            outs.append(all_gather(mine, mesh, "batch", 0))
        return torch.cat(outs)[:nview]


def _pad_last(pts, vz, batch: int):
    """The viewpoints padded to a multiple of ``batch`` with the last one
    (viewshed.py:1082-1085)."""
    pad = -pts.shape[0] % batch
    return (torch.cat([pts, pts[-1:].expand(pad, 2)]),
            torch.cat([vz, vz[-1:].expand(pad)]))


def viewshed_count(dem, viewpoints_ij, *, out_center_ij, out_halfwidth,
                   viewer_height_m=2.0, width=256, nsteps=None,
                   cells_per_deg=1200, znear=50.0, zfar=20000.0,
                   cos_viewer_lat=None, lat_deg=None, batch=64,
                   sampler="window", mesh=None, device="cuda", plain=False):
    """Cumulative viewshed: (2 hw, 2 hw) int32 counts of the observers that
    see each cell of the fixed frame centred on ``out_center_ij`` (float
    cell coords), ``out_halfwidth`` cells each side. Observers as in
    viewshed_sweep, full circles; ``batch`` observers go through
    viewshed_grid(full_circle=True) at a time and accumulate on the
    device (the contract resampler adds them in, with no raster). The
    crossing and step samplers resample with "gather" (their packed
    scenes, as in the JAX package). ``mesh``: each batch splits
    over the ranks of its "batch" dim, each rank counts its share, and
    one all-reduce sums the counts; the padding observers of the last
    batch count nothing."""
    with profiling.phase("hz.ops.viewshed_count"):
        _check_port("viewshed_count", sampler)
        with profiling.phase("hz.ops.sweep_prep"):
            dem_f, pts, vz, nsteps, lat_hint, cos_lat = _sweep_prep(
                dem, viewpoints_ij, viewer_height_m, sampler=sampler,
                nsteps=nsteps, cells_per_deg=cells_per_deg, zfar=zfar,
                cos_viewer_lat=cos_viewer_lat, lat_deg=lat_deg, device=device)
        profiling.count("hz.viewpoints", pts.shape[0])
        hw = int(out_halfwidth)
        center = (float(out_center_ij[0]), float(out_center_ij[1]))
        nview = pts.shape[0]
        step, starts = batch, range(0, nview, batch)
        if mesh is not None:
            mesh, n_b, idx = _batch_mesh("viewshed_count", mesh, batch, device)
            pts, vz = _pad_last(pts, vz, batch)
            step = batch // n_b
            starts = range(idx * step, pts.shape[0], batch)
        total = torch.zeros((2 * hw, 2 * hw), dtype=torch.int32, device=device)
        for s in starts:
            n_real = min(step, nview - s)
            if n_real <= 0:
                continue
            with profiling.phase("hz.ops.viewshed_grid"):
                vis = _grid(
                    dem_f, _observer_params(pts[s:s + n_real],
                                            vz[s:s + n_real], cos_lat,
                                            znear, zfar),
                    width=width, nsteps=nsteps, cells_per_deg=cells_per_deg,
                    surface="bilinear", sampler=sampler,
                    lat_hint_deg=lat_hint, znear_hint_m=float(znear),
                    out_halfwidth=hw, with_dropped=False, aligned_scene=None,
                    out_center_ij=center, method="auto", full_circle=True,
                    plain=plain, total=total)
            if vis is not None:
                with profiling.phase("hz.ops.accumulate"):
                    total += vis.sum(dim=0, dtype=torch.int32)
        if mesh is not None:
            from ..parallel.mesh import all_reduce
            all_reduce(total, mesh, "batch", torch.distributed.ReduceOp.SUM)
        return total
