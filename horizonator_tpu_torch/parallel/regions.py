"""DEM-region sharding: grids larger than one device's memory.

Counterpart of horizonator_tpu.parallel.regions. The elevation grid is
split into R row bands over a mesh's "region" dim, each rank holding one
band of nb rows plus a one-row halo, the next band's first row, which it
receives over a ring (``mesh.ring_halo``): the overlap convention of the
reference's tile mosaic (dem.c:161-171, 285-291). The last band's halo
lies past the grid's north edge: it is a zero row, masked through the
band march's ``j_hi``, as the whole grid's march masks rows past n - 1.

Why the combine is exact: each band marches the whole crossing budget
with the global geometry and an integer row offset (render.window's
bands), so its samples are the whole grid's march's samples, valid only
where their two-tap stencil lies in the band and its halo. Every sample
is valid in exactly one band, or in two with equal values on a shared
boundary row; the MAX over the bands of the tangents is therefore
bitwise the single march, and so is the image resolved from it. Colors
combine by a MAX in which each band's invalid lanes carry -1.

Each entry has two parts. ``local`` is one rank's march, given its
coordinates and its band with the halo it received; ``combine`` and
``resolve`` are what the collectives assemble. Calling the entry on every
rank of a mesh runs the halo exchange, the local march and the
collectives (``all_reduce`` MAX over "region"; with an ``az_axis``,
azimuth wedges gathered over it); ``run`` does the same on bands whose
halo ``exchange_halo`` received already. One process can instead drive
``local`` for every coordinate of a larger mesh and combine the parts
itself.

A rank's inputs are its own band's rows, on its device: ``band_of`` takes
them from the host array, so no device ever holds the whole grid. The
entries take a DeviceMesh, or a mesh shape {dim: size} for ``local``
alone.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..render.crossing import (CrossingDists, NEG_BIG, crossing_geometry,
                               march_crossing, pack_scene)
from ..render.raymarch import (RenderParams, broadcast_params_batch,
                               resolve_to_image)
from ..render.texture import ColorPlanes2x
from ..render.window import march_from_geometry
from .mesh import (all_gather, all_reduce, coord, dim_size, ring_halo,
                   sum_over_mesh)
from .sharding import _wedge_params

__all__ = ["BandMarch", "band_bounds", "band_of", "exchange_halo",
           "local_band", "make_region_sharded_horizon",
           "make_region_sharded_renderer"]


def band_bounds(idx: int, r: int, nb: int, n_valid=None):
    """(j_offset, j_hi) of band ``idx`` of ``r`` bands of ``nb`` rows: its
    first global row, and the last band-local row that holds a valid row
    (nb, the halo, for every band but the last; fewer where the grid was
    padded to a band multiple, ``n_valid`` its true height; below 0 for a
    band of padding alone)."""
    n_valid = r * nb if n_valid is None else n_valid
    return idx * nb, float(min(nb, n_valid - 1 - idx * nb))


def _rows_per_band_row(x) -> int:
    """Rows of ``x`` per DEM row: 2 for a half-cell plane."""
    return 2 if isinstance(x, ColorPlanes2x) else 1


def _rows(x):
    return x.full_packed if isinstance(x, ColorPlanes2x) else x


def _with_rows(x, rows):
    return ColorPlanes2x(rows) if isinstance(x, ColorPlanes2x) else rows


def band_of(x, idx: int, r: int, device, scale: int = 1):
    """Band ``idx`` of ``r`` of ``x`` (numpy; rows on the second-last axis,
    ``scale`` rows per DEM row) as a tensor on ``device``: the rank's own
    share, copied from the host alone."""
    nb = x.shape[-2] // (scale * r)
    band = x[..., scale * idx * nb:scale * (idx + 1) * nb, :]
    return torch.from_numpy(np.ascontiguousarray(band)).to(device)


def local_band(x, idx: int, r: int):
    """Band ``idx`` of ``r`` of a whole array ``x`` (a tensor or a
    ColorPlanes2x; rows on the second-last axis) with its halo, the next
    band's first rows or zeros past the last band: what the ring exchange
    gives the rank, made in one process (for tests and for driving every
    rank's ``local`` on one device)."""
    s = _rows_per_band_row(x)
    t = _rows(x)
    nb = t.shape[-2] // (s * r)
    lo, hi = s * idx * nb, s * (idx + 1) * nb
    halo = (t[..., hi:hi + s, :] if idx < r - 1
            else torch.zeros_like(t[..., :s, :]))
    return _with_rows(x, torch.cat([t[..., lo:hi, :], halo], dim=-2))


def exchange_halo(band_arrays, mesh, axis="region"):
    """Each array's band (a rank's rows, a tensor or a ColorPlanes2x) with
    the halo received over the ring, one batch of sends for all of them:
    what an entry's ``run`` takes. A caller whose bands do not change (the
    API's scene) exchanges them once."""
    firsts = [_rows(a)[..., :_rows_per_band_row(a), :]
              for a in band_arrays]
    halos = ring_halo(firsts, mesh, axis)
    return [_with_rows(a, torch.cat([_rows(a), h], dim=-2))
            for a, h in zip(band_arrays, halos)]


class BandMarch(NamedTuple):
    """One band's march: tanel (W, K) with only this band's samples valid,
    tex (W, K) int32 or None, its distances, the column azimuths and the
    (wedge's) params."""
    tanel: torch.Tensor
    tex: torch.Tensor | None
    dists: CrossingDists
    az: torch.Tensor
    params: RenderParams


def _band_march(local, params: RenderParams, *, idx, r, n_valid, az_idx,
                n_az, width, k_cross, cells_per_deg, sampler, lat_hint_deg,
                colors=None, atlas=None, atlas_params=None,
                exact_near_m=None) -> BandMarch:
    """regions.py:89-191: the band-local march of band ``idx`` of ``r``
    (``local``: its (nb + 1, n) rows with the halo) through wedge
    ``az_idx`` of ``n_az``, at global geometry and row offset idx * nb."""
    nb = local.shape[-2] - 1
    j_offset, j_hi = band_bounds(idx, r, nb, n_valid)
    p = _wedge_params(broadcast_params_batch(params), az_idx, n_az)
    tex = None
    if sampler == "window":
        # march_window's march without its running max, which the resolve
        # takes itself
        geo = crossing_geometry(p, width=width, cells_per_deg=cells_per_deg)
        out = march_from_geometry(
            local, p, geo, k_cross=k_cross, cells_per_deg=cells_per_deg,
            lat_hint_deg=lat_hint_deg, j_hi=j_hi, j_offset=j_offset,
            color_planes=colors, atlas=atlas, atlas_params=atlas_params,
            exact_near_m=exact_near_m)
        tanel, dists, az = out[0], out[1], geo.az
        if colors is not None:
            tex = out[2]
    elif sampler == "crossing":
        if colors is not None:
            raise ValueError("textured region sharding needs the 'window' "
                             "sampler")
        tanel, _, dists, az = march_crossing(
            pack_scene(local), p, width=width, k_cross=k_cross,
            cells_per_deg=cells_per_deg, j_hi=j_hi, j_offset=j_offset)
    else:
        raise ValueError(f"region sharding takes the 'window' or 'crossing' "
                         f"sampler, got {sampler!r}")
    return BandMarch(tanel, tex, dists, az, p)


def _guard(dists: CrossingDists, like: torch.Tensor) -> torch.Tensor:
    z = torch.zeros((), dtype=torch.int32, device=like.device)
    return torch.stack([z if g is None else g.to(torch.int32)
                        for g in (dists.dropped, dists.truncated)])


class _Banded:
    def __init__(self, mesh, *, width, k_cross, cells_per_deg, axis,
                 az_axis, sampler, lat_hint_deg, n_valid_rows):
        self.mesh, self.axis, self.az_axis = mesh, axis, az_axis
        self.r = dim_size(mesh, axis)
        self.n_az = dim_size(mesh, az_axis)
        if width % self.n_az:
            raise ValueError(f"width {width} not divisible by az axis "
                             f"{self.n_az}")
        self.w_local = width // self.n_az
        self.mkw = dict(width=self.w_local, k_cross=k_cross,
                        cells_per_deg=cells_per_deg, sampler=sampler,
                        lat_hint_deg=lat_hint_deg, n_valid=n_valid_rows)

    def march(self, idx: int, az_idx: int, local, params: RenderParams,
              **kw) -> BandMarch:
        return _band_march(local, params, idx=idx, r=self.r, az_idx=az_idx,
                           n_az=self.n_az, **self.mkw, **kw)

    def coords(self):
        return coord(self.mesh, self.axis), coord(self.mesh, self.az_axis)

    def gather_wedges(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        if self.az_axis is None:
            return x
        return all_gather(x, self.mesh, self.az_axis, axis)


class RegionHorizon(_Banded):
    """make_region_sharded_horizon's function: ``fn(dem_band, params)`` ->
    (az (W,), tan_el (W,)) on every rank."""

    def local(self, idx: int, az_idx: int, local, params: RenderParams):
        """Band ``idx``'s horizon through wedge ``az_idx``: (az, its
        samples' max per column)."""
        bm = self.march(idx, az_idx, local, params)
        return bm.az, bm.tanel.amax(dim=-1)

    def __call__(self, dem_band, params: RenderParams):
        return self.run(*exchange_halo([dem_band], self.mesh, self.axis),
                        params)

    def run(self, local, params: RenderParams):
        """The entry on a band that already carries its halo."""
        az, h = self.local(*self.coords(), local, params)
        h = all_reduce(h, self.mesh, self.axis)
        return self.gather_wedges(az, 0), self.gather_wedges(h, 0)


def make_region_sharded_horizon(mesh, *, width, k_cross, cells_per_deg,
                                axis="region", az_axis=None,
                                sampler="window", lat_hint_deg=45.0,
                                n_valid_rows=None):
    """regions.py:47-86: ``fn(dem_band, params)`` -> (az (W,), tan_el (W,)),
    the horizon of a grid row-sharded over the mesh dim ``axis`` (each
    rank's (nb, n) band on its device), combined by a MAX over the bands;
    with ``az_axis`` the columns shard into azimuth wedges over that dim.
    Both samplers ("window", "crossing") are bitwise the whole grid's
    march. ``n_valid_rows``: the true grid height when its rows were
    zero-padded to a band multiple."""
    return RegionHorizon(mesh, width=width, k_cross=k_cross,
                         cells_per_deg=cells_per_deg, axis=axis,
                         az_axis=az_axis, sampler=sampler,
                         lat_hint_deg=lat_hint_deg,
                         n_valid_rows=n_valid_rows)


class RegionRenderer(_Banded):
    """make_region_sharded_renderer's renderer: ``fn(dem_band, params)``,
    or textured ``fn(dem_band, colors_band, params, atlas=None)`` ->
    (image (H, W, 3), ranges (H, W)) on every rank, plus the (2,) guard
    [dropped, truncated] summed over the mesh under ``with_guard``."""

    def __init__(self, mesh, *, height, refine, textured, with_guard,
                 exact_near_m, atlas_params, **kw):
        super().__init__(mesh, **kw)
        self.height, self.refine = height, refine
        self.textured, self.with_guard = textured, with_guard
        self.tkw = dict(atlas_params=atlas_params, exact_near_m=exact_near_m)

    def local(self, idx: int, az_idx: int, local, params: RenderParams,
              colors=None, atlas=None) -> BandMarch:
        """Band ``idx``'s march through wedge ``az_idx``; ``local`` and
        ``colors`` are the band's rows with their halo (local_band)."""
        return self.march(idx, az_idx, local, params, colors=colors,
                          atlas=atlas, **self.tkw)

    @staticmethod
    def masked_tex(bm: BandMarch):
        """The band's colors with its invalid lanes at -1: a MAX over the
        bands then takes each sample's color from the band where it is
        valid (regions.py:244-249)."""
        return torch.where(bm.tanel > NEG_BIG, bm.tex,
                           torch.full_like(bm.tex, -1))

    @classmethod
    def combine(cls, parts):
        """(tanel, tex) of the bands' marches of one wedge, combined in one
        process as the collectives combine them."""
        tanel = torch.stack([bm.tanel for bm in parts]).amax(dim=0)
        tex = None
        if parts[0].tex is not None:
            tex = torch.stack([cls.masked_tex(bm) for bm in parts]).amax(
                dim=0)
        return tanel, tex

    def resolve(self, tanel, tex, bm: BandMarch):
        """The combined march resolved to the wedge's (image, ranges):
        render.raymarch.resolve_to_image, the resolve kernel included."""
        return resolve_to_image(
            tanel, bm.dists.d_of, bm.az, bm.params, width=self.w_local,
            height=self.height, cells_per_deg=self.mkw["cells_per_deg"],
            refine=self.refine, textured=tex is not None, tex_samples=tex)

    def __call__(self, dem_band, *args, atlas=None):
        if self.textured:
            colors_band, params = args[0], args[1]
            if len(args) > 2:
                atlas = args[2]
            local, colors = exchange_halo([dem_band, colors_band],
                                          self.mesh, self.axis)
        else:
            (params,), colors = args, None
            local, = exchange_halo([dem_band], self.mesh, self.axis)
        return self.run(local, params, colors, atlas)

    def run(self, local, params: RenderParams, colors=None, atlas=None):
        """The entry on bands (``local``, ``colors``) that already carry
        their halo."""
        bm = self.local(*self.coords(), local, params, colors, atlas)
        tex = None
        if bm.tex is not None:       # masked by this band's own tangents
            tex = all_reduce(self.masked_tex(bm), self.mesh, self.axis)
        tanel = all_reduce(bm.tanel, self.mesh, self.axis)
        image, ranges = self.resolve(tanel, tex, bm)
        out = self.gather_wedges(image, 1), self.gather_wedges(ranges, 1)
        if not self.with_guard:
            return out
        dims = (self.axis,) + ((self.az_axis,) if self.az_axis else ())
        return out + (sum_over_mesh(_guard(bm.dists, tanel), self.mesh,
                                    dims),)


def make_region_sharded_renderer(mesh, *, width, height, k_cross,
                                 cells_per_deg, refine=True, axis="region",
                                 az_axis=None, sampler="window",
                                 lat_hint_deg=45.0, textured=False,
                                 texture_scale=1, n_valid_rows=None,
                                 atlas_params=None, exact_near_m=None,
                                 with_guard=False):
    """regions.py:194-289: the full (image, ranges) render of a grid
    row-sharded over the mesh dim ``axis``, bitwise the whole grid's
    render on one device. The combined march is resolved on every region
    rank, on 1/n_az of the columns each when ``az_axis`` names a second
    dim (whose wedges gather into the image).

    ``textured`` ('window' sampler): the renderer takes (dem_band,
    colors_band, params, atlas=None), the colors row-sharded like the
    elevation: ``texture_scale`` 1, cell planes, (3, nb, n) float or (nb,
    n) packed int32; 2, a band-local half-cell ColorPlanes2x of (2 nb, 2 n)
    packed rows, whose halo is two rows (the hat at 2*pos reaches row
    2*j_hi + 1). ``atlas`` (replicated), ``atlas_params`` and
    ``exact_near_m`` add the hybrid near field. ``with_guard`` adds the
    (2,) int32 [dropped, truncated] summed over the mesh. The port's
    resolve takes its running max itself, so no run_max is computed
    here."""
    if textured and texture_scale not in (1, 2):
        raise ValueError(f"texture_scale must be 1 or 2, got "
                         f"{texture_scale}")
    return RegionRenderer(
        mesh, width=width, height=height, k_cross=k_cross,
        cells_per_deg=cells_per_deg, refine=refine, axis=axis,
        az_axis=az_axis, sampler=sampler, lat_hint_deg=lat_hint_deg,
        textured=textured, n_valid_rows=n_valid_rows,
        atlas_params=atlas_params, exact_near_m=exact_near_m,
        with_guard=with_guard)

