"""Port parity for dem/paging.py: the device window over a big host grid
and the paged fly-through, against horizonator_tpu's.

Tolerances: the window's origins and upload counts are equal (host
logic); each frame of ``fly`` against the JAX package's within
test_torch_render's ``_compare`` (the single render's tolerance), and
bitwise against the port's own render on a window placed at the same
origin.
"""

import numpy as np
import pytest
import torch

from horizonator_tpu.dem.paging import PagedWindow as JWindow
from horizonator_tpu.dem.paging import fly as j_fly
from horizonator_tpu_torch.dem.paging import PagedWindow, fly
from horizonator_tpu_torch.render import make_params, render_panorama
from horizonator_tpu_torch.render.crossing import k_cross_for
from tests.test_torch_geometry import CPD, make_dem
from tests.test_torch_render import _compare

FLY = dict(width=128, height=64, zfar_m=6000.0, cells_per_deg=CPD,
           lat_deg=34.0, window_cells=256, margin_cells=64, chunk=4,
           viewer_agl_m=30.0)


def test_window_recenters_only_past_margin():
    host = make_dem(512, rough=3.0)
    win = PagedWindow(host, window_cells=256, margin_cells=64, device="cpu")
    jwin = JWindow(host, window_cells=256, margin_cells=64)
    moves = [(256.0, 256.0), (280.0, 260.0), (256 + 128 - 32, 256.0),
             (300.0, 300.0)]
    uploads = []
    for vi, vj in moves:
        win.ensure(vi, vj)
        jwin.ensure(vi, vj)
        assert win.origin == jwin.origin and win.uploads == jwin.uploads
        uploads.append(win.uploads)
    assert uploads == [1, 1, 2, 2]
    assert win.dem.shape == (256, 256) and win.dem.dtype == torch.float32
    j0, i0 = win.origin
    np.testing.assert_array_equal(win.dem.numpy(),
                                  host[j0:j0 + 256, i0:i0 + 256])
    assert win.local_cell(300.0, 301.5) == (300.0 - i0, 301.5 - j0)


def test_clamped_edge_origin_does_not_reupload():
    """A viewer hugging the grid's edge re-centres to the same clamped
    origin: the window is not sent again."""
    host = make_dem(512, rough=3.0)
    win = PagedWindow(host, window_cells=256, margin_cells=64, device="cpu")
    win.ensure(500.0, 500.0)
    assert win.origin == (256, 256) and win.uploads == 1
    for v in (505.0, 510.5, 511.0):
        win.ensure(v, v)                    # within the margin of the edge
        assert win.origin == (256, 256) and win.uploads == 1
    big = PagedWindow(host, window_cells=4096, device="cpu")
    assert big.wc == 512
    big.ensure(10.0, 10.0)
    big.ensure(500.0, 3.0)
    assert big.uploads == 1


def _path(frames=12):
    """A path that leaves two windows behind: three uploads."""
    return np.stack([np.linspace(150, 390, frames),
                     np.linspace(200, 260, frames)], axis=1)


def test_fly_matches_jax_and_window_renders():
    host = make_dem(512, rough=3.0)
    path = _path()
    imgs, rngs, uploads = fly(host, path, device="cpu", **FLY)
    jimgs, jrngs, juploads = j_fly(host, path, **FLY)
    assert imgs.shape == (len(path), 64, 128, 3) and rngs.dtype == np.float32
    assert uploads == juploads >= 2
    for f in range(len(path)):
        _compare(np.asarray(jimgs[f]), np.asarray(jrngs[f]), imgs[f],
                 rngs[f])
    # each frame bitwise the port's render on a window at the same origin
    win = PagedWindow(host, FLY["window_cells"], FLY["margin_cells"],
                      device="cpu")
    k = k_cross_for(FLY["zfar_m"], CPD, FLY["lat_deg"], n=win.wc)
    for s in range(0, len(path), FLY["chunk"]):
        win.ensure(*path[s + FLY["chunk"] // 2])
        for f in range(s, s + FLY["chunk"]):
            li, lj = win.local_cell(*path[f])
            j0i, i0i = (int(np.floor(v)) + o for v, o in
                        zip((lj, li), win.origin))
            p = make_params(
                device="cpu", viewer_cell_i=li, viewer_cell_j=lj,
                viewer_z=float(host[j0i:j0i + 2, i0i:i0i + 2].max()) + 30.0,
                cos_viewer_lat=np.cos(np.radians(34.0)),
                az_rad0=np.radians(-60.0), az_rad1=np.radians(60.0),
                znear=100.0, zfar=FLY["zfar_m"], znear_color=100.0,
                zfar_color=FLY["zfar_m"])
            img, rng = render_panorama(
                win.dem, p, width=128, height=64, nsteps=k,
                cells_per_deg=CPD, lat_hint_deg=34.0)
            np.testing.assert_array_equal(imgs[f], img.numpy())
            np.testing.assert_array_equal(rngs[f], rng.numpy())
    assert win.uploads == uploads


def test_fly_pads_the_last_segment():
    host = make_dem(512, rough=3.0)
    path = _path(6)
    imgs, rngs, uploads = fly(host, path, device="cpu", **FLY)
    jimgs, jrngs, juploads = j_fly(host, path, **FLY)
    assert imgs.shape[0] == 6 and uploads == juploads
    _compare(np.asarray(jimgs[5]), np.asarray(jrngs[5]), imgs[5], rngs[5])


def test_fly_outrunning_the_window_raises():
    host = make_dem(512, rough=3.0)
    fast = np.stack([np.linspace(100, 420, 8), np.full(8, 256.0)], axis=1)
    kw = dict(FLY, window_cells=192, margin_cells=32, chunk=8)
    with pytest.raises(ValueError, match="leaves the resident"):
        fly(host, fast, device="cpu", **kw)
    with pytest.raises(ValueError, match="leaves the resident"):
        j_fly(host, fast, **kw)
