"""Point-to-point line of sight / intervisibility, on torch tensors.

Counterpart of horizonator_tpu.ops.los. ``viewshed_*`` answers "which cells
does one viewer see"; these ops answer the pairwise question -- can A see
B? -- for arbitrary batches of point pairs (radio-link planning, observer
siting, summit-to-summit checks).

Each sight line is sampled at K uniform interior fractions t_k =
(k+1)/(K+1); elevations come from the packed-pair bilinear lookups the
renderer uses (render.raymarch._sample_surface, 2 gathers a sample) and
everything else is elementwise broadcasting. The grid is convex, so every
interior sample of a segment between two in-grid endpoints is in the grid,
and only the endpoints need a bounds check.

Visibility model (shared with the renderer, geometry.curvature_coeff): the
apparent height of terrain at horizontal distance d from the observer is
z(d) - z_obs - curv*d^2. B is visible from A iff no interior sample's
apparent height reaches the A->B chord; the test reads the same from
either end, so with equal endpoint heights intervisibility is symmetric.

The arithmetic is the JAX package's ``sightline`` as it runs eagerly (one
rounding per operation, divisions true, a Python number rounded to
float32 where it meets a float32 tensor), so a profile is bitwise the JAX
package's. ``intervisible`` is the same computation, walked over the pair
batch in chunks whose estimated working set stays under ``LOS_BYTES``: each
pair's answer is bitwise its answer in any chunk. The JAX package jits
``intervisible``, where XLA may fuse a product into an add, so a pair may
flip only where its minimum clearance lies within a few ulps of 0.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import geometry
from ..geometry import as_f32, const
from ..render.raymarch import _as_packed, _sample_surface

DEG = math.pi / 180.0
# the most device memory one chunk of intervisible is estimated to hold,
# and its estimate per sample: the peak lies in _sample_surface (the
# positions, indices, pair lookups and lerps), measured at 69 B a sample
# on the card (chip_smoke.py phase 28), and a sixth more for margin
LOS_BYTES = 4 << 30
LOS_SAMPLE_BYTES = 80

__all__ = ["Sightline", "sightline", "intervisible", "intervisibility_matrix",
           "LOS_BYTES"]


class Sightline(NamedTuple):
    """Full profile of one (or a batch of) sight line(s). All leading dims
    broadcast from the a/b inputs; K = nsteps interior samples,
    endpoint-exclusive."""
    d: torch.Tensor          # (..., K) horizontal distance from A, meters
    z: torch.Tensor          # (..., K) terrain elevation at the samples
    los_z: torch.Tensor      # (..., K) A->B chord height, curvature-corrected
    clearance: torch.Tensor  # (..., K) los_z - apparent terrain height (m)
    visible: torch.Tensor    # (...,) bool: min interior clearance > 0
    block_d: torch.Tensor    # (...,) distance of the worst obstruction, m
                             # (argmin clearance; meaningful when not visible)


def _cells_to_en_m(di, dj, cells_per_deg, cos_lat):
    """Cell deltas -> east/north meters (vertex.glsl:128-130 scales)."""
    cell_n = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    return di * (cell_n * cos_lat), dj * cell_n


def _profile(dem_packed: torch.Tensor, n: int, ai, aj, bi, bj, *,
             cells_per_deg, cos_lat, nsteps, observer_height_m,
             target_height_m, ele_a, ele_b, surface, curvature):
    """The profile of the segments (ai, aj) -> (bi, bj) (broadcast
    tensors on the plane's device): (d, z, chord, clearance, z_obs, ok),
    with chord relative to the observer's height and ok False where an
    endpoint lies outside the grid."""
    dev = dem_packed.device
    curv = geometry.curvature_coeff(curvature)
    ok = ((ai >= 0) & (ai <= n - 1) & (aj >= 0) & (aj <= n - 1) &
          (bi >= 0) & (bi <= n - 1) & (bj >= 0) & (bj <= n - 1))

    de, dn = _cells_to_en_m(bi - ai, bj - aj, cells_per_deg, cos_lat)
    dist = torch.sqrt(de * de + dn * dn)                     # (...,)

    z_a = (_sample_surface(dem_packed, n, ai, aj, surface)
           if ele_a is None else as_f32(ele_a).to(dev))
    z_b = (_sample_surface(dem_packed, n, bi, bj, surface)
           if ele_b is None else as_f32(ele_b).to(dev))
    z_obs = z_a + observer_height_m
    z_tgt = z_b + target_height_m

    # a true division by a tensor on the device: CUDA multiplies by the
    # reciprocal of a host scalar divisor
    tk = ((torch.arange(nsteps, dtype=torch.float32, device=dev) + 1.0)
          / const(nsteps + 1.0, ai))                         # (K,)
    # the (..., K) positions are freed as soon as the terrain is sampled
    z = _sample_surface(dem_packed, n,
                        ai[..., None] + tk * (bi - ai)[..., None],
                        aj[..., None] + tk * (bj - aj)[..., None], surface)

    d = tk * dist[..., None]                                 # (..., K)
    # apparent-height space relative to the observer's horizontal plane:
    # terrain drops by curv*d^2; the chord runs from (0, 0) to
    # (D, z_tgt - z_obs - curv*D^2)
    h_app = z - z_obs[..., None] - curv * d * d
    chord = tk * (z_tgt - z_obs - curv * dist * dist)[..., None]
    return d, z, chord, chord - h_app, z_obs, ok


def sightline(dem: torch.Tensor, a_ij, b_ij, *, cells_per_deg, cos_lat,
              nsteps=512, observer_height_m=2.0, target_height_m=0.0,
              ele_a=None, ele_b=None, surface="bilinear",
              curvature="none") -> Sightline:
    """Terrain/clearance profile along the A->B segment(s), on the DEM's
    device.

    dem: (N, N) float32 grid (row 0 = south, i = east axis) or a pre-packed
    int32 plane from raymarch.pack_dem_pairs. a_ij/b_ij: (..., 2)
    fractional grid coords (i, j) (arrays or tensors); leading dims
    broadcast against each other. The observer stands observer_height_m
    above the terrain at A (or above ele_a if given); the target sits
    target_height_m above B. nsteps samples the segment interior
    uniformly: pick nsteps >= the pair distance in cells for sub-cell
    sampling (intervisibility_matrix does this automatically).

    Either endpoint outside the grid makes that pair's ``visible`` False
    (its profile values are clamped-edge values, not NaN)."""
    dem_packed, n = _as_packed(dem)
    dev = dem_packed.device
    a = as_f32(a_ij).to(dev)
    b = as_f32(b_ij).to(dev)
    ends = torch.broadcast_tensors(a[..., 0], a[..., 1], b[..., 0], b[..., 1])
    d, z, chord, clearance, z_obs, ok = _profile(
        dem_packed, n, *ends, cells_per_deg=cells_per_deg, cos_lat=cos_lat,
        nsteps=nsteps, observer_height_m=observer_height_m,
        target_height_m=target_height_m, ele_a=ele_a, ele_b=ele_b,
        surface=surface, curvature=curvature)
    # the first minimum on ties, as jnp.argmin
    min_clear, worst = torch.min(clearance, dim=-1)
    visible = (min_clear > 0.0) & ok
    block_d = torch.gather(d, -1, worst[..., None])[..., 0]
    return Sightline(d=d, z=z, los_z=chord + z_obs[..., None],
                     clearance=clearance, visible=visible, block_d=block_d)


def intervisible(dem: torch.Tensor, a_ij, b_ij, *, cells_per_deg, cos_lat,
                 nsteps=512, observer_height_m=2.0, target_height_m=0.0,
                 ele_a=None, ele_b=None, surface="bilinear",
                 curvature="none") -> torch.Tensor:
    """Boolean intervisibility for (batches of) point pairs: ``sightline``'s
    arguments, its broadcast ``visible`` on the DEM's device. The pairs run
    in chunks under ``LOS_BYTES``."""
    dem_packed, n = _as_packed(dem)
    dev = dem_packed.device
    a = as_f32(a_ij).to(dev)
    b = as_f32(b_ij).to(dev)
    ends = [a[..., 0], a[..., 1], b[..., 0], b[..., 1]]
    eles = [e if e is None else as_f32(e).to(dev) for e in (ele_a, ele_b)]
    shape = torch.broadcast_shapes(*(x.shape for x in ends + eles
                                     if x is not None))
    flat = [x if x is None else x.expand(shape).reshape(-1)
            for x in ends + eles]
    pairs = flat[0].numel()
    chunk = max(1, LOS_BYTES // (nsteps * LOS_SAMPLE_BYTES))
    out = []
    for s in range(0, pairs, chunk):
        ai, aj, bi, bj, ea, eb = (x if x is None else x[s:s + chunk]
                                  for x in flat)
        _, _, _, clearance, _, ok = _profile(
            dem_packed, n, ai, aj, bi, bj, cells_per_deg=cells_per_deg,
            cos_lat=cos_lat, nsteps=nsteps,
            observer_height_m=observer_height_m,
            target_height_m=target_height_m, ele_a=ea, ele_b=eb,
            surface=surface, curvature=curvature)
        out.append((clearance.amin(dim=-1) > 0.0) & ok)
    if not out:
        return torch.zeros(shape, dtype=torch.bool, device=dev)
    return torch.cat(out).reshape(shape)


def auto_nsteps(pts_ij) -> int:
    """intervisibility_matrix's sample count: the longest pair at 1.5
    samples a cell, rounded up to a multiple of 128, clamped to [64,
    8192]."""
    p = np.asarray(pts_ij, np.float32)
    span = np.hypot(p[:, None, 0] - p[None, :, 0],
                    p[:, None, 1] - p[None, :, 1]).max()
    return int(min(8192, max(64, -(-span * 1.5 // 128) * 128)))


def intervisibility_matrix(dem: torch.Tensor, pts_ij, *, cells_per_deg,
                           cos_lat, nsteps=None, observer_height_m=2.0,
                           target_height_m=None, surface="bilinear",
                           curvature="none") -> torch.Tensor:
    """(N, N) bool on the DEM's device: [r, c] = "the target at point c is
    visible from an observer at point r".

    pts_ij: (N, 2) fractional grid coords. target_height_m defaults to
    observer_height_m, which makes the matrix symmetric; the diagonal is
    True by construction. nsteps=None auto-sizes to the longest pair
    (``auto_nsteps``)."""
    dem_packed, _ = _as_packed(dem)
    pts = as_f32(pts_ij).to(dem_packed.device)
    if target_height_m is None:
        target_height_m = observer_height_m
    if nsteps is None:
        nsteps = auto_nsteps(pts.cpu().numpy())
    vis = intervisible(
        dem_packed, pts[:, None, :], pts[None, :, :],
        cells_per_deg=cells_per_deg, cos_lat=cos_lat, nsteps=nsteps,
        observer_height_m=observer_height_m,
        target_height_m=target_height_m, surface=surface,
        curvature=curvature)
    n = pts.shape[0]
    return vis | torch.eye(n, dtype=torch.bool, device=vis.device)
