"""Many viewpoints on one device: the batch axis of the render.

Counterpart of horizonator_tpu.parallel.sharding's single-device entries.
The JAX package renders a batch as ``lax.map`` over ``render_panorama``,
one dispatch for the whole batch. Here the batch is an axis of the render
itself: RenderParams with (B,) fields go through one pass of the glue, and
each kernel launches once per chunk of viewpoints (the march with the
viewpoint on its grid's z axis, the resolve over B*W columns), so the
host's per-launch cost is paid once per chunk, not once per viewpoint.

Working memory stays bounded as under ``lax.map``: a batch runs in chunks
whose estimated working set (``chunk_bytes``, from B, W, H and the sample
count K) stays under ``BATCH_BYTES``. Each viewpoint's output is bitwise
its single render's, whatever the chunk size.

``horizon_batch`` gives the uniform-step march's horizons of a batch, in
chunks under the same budget.

Many devices (sharding.py:95-207): ``make_sharded_renderer`` and
``make_sharded_horizon`` shard a batch over a mesh's "batch" dim and each
panorama's columns over its "az" dim, in contiguous azimuth wedges
(``_wedge_params``) that are rendered independently, with the DEM
replicated. Each takes a DeviceMesh (parallel.mesh) and is called on
every rank with the same arguments; ``local`` is one rank's share, a
one-device call of ``render_batch`` / ``horizon_batch`` on its slice of
the batch and its wedge, and the call assembles every rank's share by
all-gathers, so every rank returns the whole result.
"""

from __future__ import annotations

import torch

from .. import geometry, profiling
from ..render.crossing import N_NEAR, CrossingScene, pack_scene
from ..render.raymarch import (RenderParams, _as_packed,
                               broadcast_params_batch, march_tanel,
                               render_panorama, stack_params)
from ..render.window import step_budget
from .mesh import all_gather, coord, dim_size, sum_over_mesh

# the most device memory one chunk's render is estimated to hold
BATCH_BYTES = 16 << 30
# its estimate: bytes a viewpoint holds per march sample (the samples, their
# rows, the near band's and the levels' concatenations; textured, their
# colors) and per output pixel (the resolve's idx, alpha, ok and colors, the
# tail's distances, ranges and image)
SAMPLE_BYTES, SAMPLE_BYTES_TEX = 32, 48
PIXEL_BYTES, PIXEL_BYTES_TEX = 64, 96

__all__ = ["BATCH_BYTES", "broadcast_params_batch", "chunk_bytes",
           "chunk_size", "horizon_batch", "make_sharded_horizon",
           "make_sharded_renderer", "render_batch", "render_path",
           "stack_params"]


def samples_per_column(dem, sampler: str, nsteps: int,
                       lod_plan=None) -> int:
    """K, the march samples a column of the render holds."""
    if sampler == "lod":
        return N_NEAR + sum(s.k_len for s in lod_plan)
    if sampler == "step":
        return nsteps
    if sampler == "crossing":
        return N_NEAR + nsteps
    return N_NEAR + step_budget(nsteps, dem.shape[-1])


def _chunks(params: RenderParams, step: int):
    """The batch's RenderParams in slices of ``step`` viewpoints."""
    b = params.viewer_cell_i.shape[0]
    return [RenderParams(*(x[s:s + step] for x in params))
            for s in range(0, b, step)]


def _as_batch(params: RenderParams, fn: str) -> RenderParams:
    params = broadcast_params_batch(params)
    if params.viewer_cell_i.dim() != 1 or not len(params.viewer_cell_i):
        raise ValueError(f"{fn} takes RenderParams with (B,) fields, B >= "
                         f"1; got {tuple(params.viewer_cell_i.shape)}")
    return params


def chunk_bytes(b: int, width: int, height: int, k: int,
                textured: bool = False) -> int:
    """Estimated device bytes of rendering b viewpoints at once: W*K
    samples and W*H pixels each."""
    per_sample = SAMPLE_BYTES_TEX if textured else SAMPLE_BYTES
    per_pixel = PIXEL_BYTES_TEX if textured else PIXEL_BYTES
    return b * width * (k * per_sample + height * per_pixel)


def chunk_size(b: int, width: int, height: int, k: int,
               textured: bool = False) -> int:
    """The most viewpoints of a batch of b that one chunk renders under
    ``BATCH_BYTES`` (at least one)."""
    one = chunk_bytes(1, width, height, k, textured)
    return max(1, min(b, BATCH_BYTES // one))


def render_batch(dem, params: RenderParams, *, width, height, nsteps,
                 cells_per_deg, surface="bilinear", refine=True,
                 sampler="step", lat_hint_deg=45.0, lod_plan=None,
                 textured=False, color_planes=None, znear_hint_m=100.0,
                 atlas=None, atlas_params=None, exact_near_m=None,
                 with_dropped=False, plain=False):
    """Batch render over a stacked RenderParams batch ((B,) fields; 0-d
    fields broadcast): (images (B, H, W, 3) uint8, ranges (B, H, W)
    float32), plus the (B, 2) int32 guard [dropped, truncated] per
    viewpoint under ``with_dropped``.

    The scene (a DEM, an LOD pyramid, a CrossingScene or a pack_dem_pairs
    plane, as render_panorama's ``sampler`` takes it), ``color_planes``,
    the atlas and the LOD plan are shared by the batch; the arguments are
    render_panorama's. The oracle samplers' scenes are packed here once
    for the batch. ``plain`` runs the kernels' plain PyTorch versions (for
    comparisons)."""
    with profiling.phase("hz.parallel.render_batch"):
        params = _as_batch(params, "render_batch")
        if sampler == "crossing" and not isinstance(dem, CrossingScene):
            dem = pack_scene(dem)
        elif sampler == "step":
            dem = _as_packed(dem)[0]
        b = params.viewer_cell_i.shape[0]
        profiling.count("hz.viewpoints", b)
        step = chunk_size(b, width, height,
                          samples_per_column(dem, sampler, nsteps, lod_plan),
                          textured)
        kw = dict(width=width, height=height, nsteps=nsteps,
                  cells_per_deg=cells_per_deg, surface=surface, refine=refine,
                  sampler=sampler, lat_hint_deg=lat_hint_deg,
                  lod_plan=lod_plan, textured=textured,
                  color_planes=color_planes, znear_hint_m=znear_hint_m,
                  atlas=atlas, atlas_params=atlas_params,
                  exact_near_m=exact_near_m, with_dropped=True, plain=plain)
        parts = []
        for q in _chunks(params, step):
            with profiling.phase("hz.parallel.chunk"):
                parts.append(render_panorama(dem, q, **kw))
        out = parts[0] if len(parts) == 1 else tuple(
            torch.cat(xs) for xs in zip(*parts))
        return out if with_dropped else out[:2]


def render_path(dem, params_path: RenderParams, **kw):
    """Fly-through: render a camera path (stacked RenderParams, leading
    axis = frames) as one batch. Returns (images (F, H, W, 3), ranges (F,
    H, W)); keywords as render_batch's."""
    return render_batch(dem, params_path, **kw)


def horizon_batch(dem, params: RenderParams, *, width, nsteps, cells_per_deg,
                  surface="bilinear"):
    """Horizon profiles of a batch from the uniform-step march
    (sharding.py:167-180): (az (B, W), tan_el (B, W)) from (B,) params.
    ``dem``: a float32 grid or its pack_dem_pairs plane (packed here once
    for the batch). Runs in chunks under ``BATCH_BYTES``, each viewpoint
    bitwise its single march's."""
    params = _as_batch(params, "horizon_batch")
    packed = _as_packed(dem)[0]
    step = chunk_size(params.viewer_cell_i.shape[0], width, 0, nsteps)
    parts = []
    for q in _chunks(params, step):
        tanel, _, _, az = march_tanel(packed, q, width=width, nsteps=nsteps,
                                      cells_per_deg=cells_per_deg,
                                      surface=surface)
        parts.append((az, tanel.amax(dim=-1)))
    return tuple(torch.cat(xs) for xs in zip(*parts))


def _wedge_params(p: RenderParams, az_idx: int, n_az: int) -> RenderParams:
    """The azimuth sub-window of wedge ``az_idx`` of ``n_az``
    (sharding.py:95-106): wedge k of the unwrapped window [az0, az1] is
    [az0 + span*k/n, az0 + span*(k+1)/n], whose pixel grid is global
    columns [k*W/n, (k+1)*W/n) because pixel centres are uniform in
    azimuth. One wedge is the window itself, as it is (the JAX package
    recomputes its right edge, which can move it by an ulp)."""
    if n_az == 1:
        return p
    az1u, _, _ = geometry.az_window_rad(p.az_rad0, p.az_rad1)
    span = az1u - p.az_rad0
    k = torch.full((), float(az_idx), dtype=torch.float32,
                   device=span.device)
    az0 = p.az_rad0 + span * k / n_az
    az1 = p.az_rad0 + span * (k + 1.0) / n_az
    return p._replace(az_rad0=az0, az_rad1=az1)


def _wedges(mesh, width: int):
    n_az = dim_size(mesh, "az")
    if width % n_az:
        raise ValueError(f"width {width} not divisible by az axis {n_az}")
    return n_az, width // n_az


def _batch_slice(params: RenderParams, mesh, fn: str) -> RenderParams:
    """This rank's contiguous share of a (B,) batch along "batch"."""
    params = _as_batch(params, fn)
    n_b, idx = dim_size(mesh, "batch"), coord(mesh, "batch")
    b = params.viewer_cell_i.shape[0]
    if b % n_b:
        raise ValueError(f"{fn}: batch {b} not divisible by the mesh's "
                         f"batch axis {n_b}")
    step = b // n_b
    return RenderParams(*(x[idx * step:(idx + 1) * step] for x in params))


class ShardedRenderer:
    """make_sharded_renderer's renderer: ``fn(dem, params, color_planes=
    None, atlas=None)`` -> (images (B, H, W, 3), ranges (B, H, W)) on every
    rank, plus the (B, 2) guard [dropped, truncated] (summed over the
    wedges) under ``with_dropped``."""

    def __init__(self, mesh, **kw):
        self.mesh = mesh
        self.n_az, self.w_local = _wedges(mesh, kw["width"])
        self.kw = dict(kw, width=self.w_local)

    def local(self, az_idx: int, dem, params: RenderParams,
              color_planes=None, atlas=None):
        """One rank's share: the viewpoints ``params`` (its slice of the
        batch) through wedge ``az_idx``, on one device (render_batch, in
        chunks under BATCH_BYTES): (images, ranges, guard)."""
        return render_batch(dem, _wedge_params(
            broadcast_params_batch(params), az_idx, self.n_az),
            color_planes=color_planes, atlas=atlas, with_dropped=True,
            **self.kw)

    def __call__(self, dem, params: RenderParams, color_planes=None,
                 atlas=None, with_dropped: bool = False):
        mine = _batch_slice(params, self.mesh, "make_sharded_renderer")
        img, rng, guard = self.local(coord(self.mesh, "az"), dem, mine,
                                     color_planes, atlas)
        m = self.mesh
        img = all_gather(all_gather(img, m, "az", 2), m, "batch", 0)
        rng = all_gather(all_gather(rng, m, "az", 2), m, "batch", 0)
        if not with_dropped:
            return img, rng
        guard = all_gather(sum_over_mesh(guard, m, ("az",)), m, "batch", 0)
        return img, rng, guard


def make_sharded_renderer(mesh, *, width, height, nsteps, cells_per_deg,
                          surface="bilinear", refine=True, sampler="step",
                          lat_hint_deg=45.0, lod_plan=None, textured=False,
                          znear_hint_m=100.0, atlas_params=None,
                          exact_near_m=None) -> ShardedRenderer:
    """The renderer over a DeviceMesh with dims ("batch", "az")
    (sharding.py:109-164): the batch B (a multiple of the batch dim) over
    "batch", the image's columns over "az" in azimuth wedges, the scene
    replicated. A wedge of 1/n_az of the window at 1/n_az of the width
    keeps square angular pixels, so the shards concatenate; its float32
    azimuths are the wedge's own, so a wedged render matches the one-device
    render within a tolerance (tests/test_torch_sharding.py states it).
    Keywords are render_batch's."""
    return ShardedRenderer(
        mesh, width=width, height=height, nsteps=nsteps,
        cells_per_deg=cells_per_deg, surface=surface, refine=refine,
        sampler=sampler, lat_hint_deg=lat_hint_deg, lod_plan=lod_plan,
        textured=textured, znear_hint_m=znear_hint_m,
        atlas_params=atlas_params, exact_near_m=exact_near_m)


class ShardedHorizon:
    """make_sharded_horizon's function: ``fn(dem, params)`` -> (az (B, W),
    tan_el (B, W)) on every rank."""

    def __init__(self, mesh, **kw):
        self.mesh = mesh
        self.n_az, self.w_local = _wedges(mesh, kw["width"])
        self.kw = dict(kw, width=self.w_local)

    def local(self, az_idx: int, dem, params: RenderParams):
        """One rank's share: horizon_batch of ``params`` through wedge
        ``az_idx``."""
        return horizon_batch(dem, _wedge_params(
            broadcast_params_batch(params), az_idx, self.n_az), **self.kw)

    def __call__(self, dem, params: RenderParams):
        mine = _batch_slice(params, self.mesh, "make_sharded_horizon")
        az, tan_el = self.local(coord(self.mesh, "az"), dem, mine)
        m = self.mesh
        return tuple(all_gather(all_gather(x, m, "az", 1), m, "batch", 0)
                     for x in (az, tan_el))


def make_sharded_horizon(mesh, *, width, nsteps, cells_per_deg,
                         surface="bilinear") -> ShardedHorizon:
    """Horizons of a batch over a ("batch", "az") DeviceMesh from the
    uniform-step march (sharding.py:183-207): viewpoints over "batch",
    azimuth columns over "az"."""
    return ShardedHorizon(mesh, width=width, nsteps=nsteps,
                          cells_per_deg=cells_per_deg, surface=surface)
