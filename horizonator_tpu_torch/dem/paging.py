"""Device window paging: fly-throughs over terrain larger than the card
should hold.

Counterpart of horizonator_tpu.dem.paging. A camera path can cross far
more terrain than one render needs resident (a continent of SRTM1 is
~100 GB). ``PagedWindow`` keeps a fixed-shape square window of the
host-side grid on the device and re-centres it only when the viewer comes
within a guard margin of its edge:

- the window's shape never changes, so every render of the flight has the
  same shapes; re-centring changes the data and the viewer's
  window-relative cell, nothing else;
- an upload is window_cells^2 * 4 bytes host-to-device (2048^2 = 16 MB)
  and happens only after ``margin_cells`` of travel;
- renders between re-centres are device work only; the RenderParams are
  always window-relative.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class PagedWindow:
    """A device-resident square window over a big host elevation grid."""

    def __init__(self, host_grid: np.ndarray, window_cells: int = 2048,
                 margin_cells: int = 256, device="cuda"):
        if window_cells > min(host_grid.shape):
            window_cells = min(host_grid.shape)
        self.host = host_grid
        self.wc = int(window_cells)
        self.margin = int(margin_cells)
        self.device = torch.device(device)
        self.origin = (-(10 ** 9), -(10 ** 9))   # (j0, i0), forces first load
        self.dem = None
        self.uploads = 0

    def _load(self, j0: int, i0: int):
        nj, ni = self.host.shape
        j0 = max(0, min(j0, nj - self.wc))
        i0 = max(0, min(i0, ni - self.wc))
        if self.dem is not None and (j0, i0) == self.origin:
            # a viewer hugging the host grid's edge: the clamped origin
            # cannot move, and the block on the device is the same
            return
        self.origin = (j0, i0)
        block = np.ascontiguousarray(
            self.host[j0:j0 + self.wc, i0:i0 + self.wc], np.float32)
        self.dem = torch.from_numpy(block).to(self.device)
        self.uploads += 1

    def ensure(self, viewer_cell_i: float, viewer_cell_j: float) -> None:
        """Re-centre the window if the viewer (host-grid cell coords) is
        within ``margin`` of its edge (or it is not loaded yet)."""
        j0, i0 = self.origin
        m = self.margin
        inside = (viewer_cell_j - j0 >= m and viewer_cell_i - i0 >= m
                  and j0 + self.wc - viewer_cell_j >= m
                  and i0 + self.wc - viewer_cell_i >= m)
        if self.dem is None or not inside:
            self._load(int(viewer_cell_j) - self.wc // 2,
                       int(viewer_cell_i) - self.wc // 2)

    def local_cell(self, viewer_cell_i: float, viewer_cell_j: float):
        """Host-grid -> window-relative viewer cell coords."""
        j0, i0 = self.origin
        return viewer_cell_i - i0, viewer_cell_j - j0


def fly(host_grid, path_cells, *, width, height, zfar_m, cells_per_deg,
        lat_deg, window_cells=2048, margin_cells=256, znear_m=100.0,
        az_deg=(-60.0, 60.0), chunk=16, viewer_agl_m=50.0, device="cuda"):
    """Fly a camera path over a big host grid with device window paging.

    path_cells: (F, 2) host-grid (i, j) viewer positions. Renders in
    ``chunk``-frame segments, each one batch (render_path); the window
    re-centres between segments when needed, and a segment that outruns
    the window raises. Returns (images (F, H, W, 3), ranges (F, H, W),
    uploads) as numpy, uploads = the number of window loads."""
    from ..parallel.sharding import render_path
    from ..render.crossing import k_cross_for
    from ..render.raymarch import make_params

    win = PagedWindow(host_grid, window_cells, margin_cells, device)
    k = k_cross_for(zfar_m, cells_per_deg, lat_deg, n=win.wc)
    cos_lat = math.cos(math.radians(lat_deg))

    imgs = []
    rngs = []
    path = np.asarray(path_cells, np.float64)
    npad = -(-len(path) // chunk) * chunk
    path_p = np.concatenate([path, np.repeat(path[-1:], npad - len(path), 0)])
    for s in range(0, npad, chunk):
        seg = path_p[s:s + chunk]
        # one window covers the whole segment (re-centred on its middle)
        mid = seg[len(seg) // 2]
        win.ensure(mid[0], mid[1])
        # checked after ensure against the window as it now stands, so a
        # window that holds the whole grid, or was just re-centred, never
        # raises falsely: a viewer off the window would render wrong
        j0w, i0w = win.origin
        ci_lo, cj_lo = seg.min(axis=0)
        ci_hi, cj_hi = seg.max(axis=0)
        if (ci_lo < i0w or cj_lo < j0w or ci_hi > i0w + win.wc - 1
                or cj_hi > j0w + win.wc - 1):
            raise ValueError(
                f"path segment [{ci_lo:.0f}..{ci_hi:.0f}] x "
                f"[{cj_lo:.0f}..{cj_hi:.0f}] leaves the resident "
                f"{win.wc}-cell window at ({i0w}, {j0w}): lower chunk= "
                f"or raise window_cells=/margin_cells=")
        fields = {"viewer_cell_i": [], "viewer_cell_j": [], "viewer_z": []}
        nj_h, ni_h = win.host.shape
        for (ci, cj) in seg:
            li, lj = win.local_cell(ci, cj)
            # auto elevation: ground at the viewer + AGL margin; floor and
            # clamp to the last full 2x2 stencil of the host grid
            j0i = min(max(int(math.floor(lj)) + win.origin[0], 0), nj_h - 2)
            i0i = min(max(int(math.floor(li)) + win.origin[1], 0), ni_h - 2)
            ground = float(np.max(win.host[j0i: j0i + 2, i0i: i0i + 2]))
            fields["viewer_cell_i"].append(li)
            fields["viewer_cell_j"].append(lj)
            fields["viewer_z"].append(ground + viewer_agl_m)
        params = make_params(
            device=win.device, cos_viewer_lat=cos_lat,
            az_rad0=math.radians(az_deg[0]), az_rad1=math.radians(az_deg[1]),
            znear=znear_m, zfar=zfar_m, znear_color=znear_m,
            zfar_color=zfar_m, **fields)
        out = render_path(win.dem, params, width=width, height=height,
                          nsteps=k, cells_per_deg=cells_per_deg,
                          sampler="window", lat_hint_deg=lat_deg)
        imgs.append(out[0].cpu().numpy())
        rngs.append(out[1].cpu().numpy())
    images = np.concatenate(imgs)[:len(path)]
    ranges = np.concatenate(rngs)[:len(path)]
    return images, ranges, win.uploads
