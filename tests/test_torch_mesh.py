"""Port parity for the mesh rasterizer: render.mesh.render_mesh and
render_mesh_tiled against horizonator_tpu.render.mesh on tests/
test_mesh.py's 192^2 scene (JAX on the CPU, jitted), and the port's own
mesh against its ray-march renders as tests/test_mesh.py holds the JAX
one.

Tolerances, and why:
- overflow counts: equal;
- coverage (which pixels hold terrain): equal at >= 99.9% of pixels
  (measured: all). A pixel is covered where some triangle's barycentric
  weights pass -1e-6, and the projected vertices take hypot, atan2 and
  atan, which differ from XLA's by an ulp;
- ranges: within 1e-5 relative where both are terrain (measured <= 1e-6,
  a few ulps of the slant range); images: test_torch_render's ``_compare``
  rule, at most 0.1% of pixels differing, by at most 1 where both are
  terrain (measured: equal);
- render_mesh_tiled against render_mesh, and any chunking against any
  other: bitwise. Each fragment's arithmetic depends on its triangle
  alone, and a minimum does not depend on the order of its terms.
"""

import numpy as np
import pytest
import torch

from horizonator_tpu.render import mesh as jmesh
from horizonator_tpu_torch.render import crossing as tcross
from horizonator_tpu_torch.render import mesh as tmesh
from horizonator_tpu_torch.render import params_from_jax, render_panorama
from tests.test_crossing import CPD
from tests.test_mesh import _setup


def _both(fn, w=256, h=128, setup=None, **kw):
    dem, p = _setup(**(setup or {}))
    ji, jr, jo = getattr(jmesh, fn)(dem, p, width=w, height=h,
                                    cells_per_deg=CPD, **kw)
    ti, tr, to = getattr(tmesh, fn)(torch.from_numpy(np.asarray(dem)),
                                    params_from_jax(p, "cpu"), width=w,
                                    height=h, cells_per_deg=CPD, **kw)
    return ((np.asarray(ji), np.asarray(jr), int(jo)),
            (ti.numpy(), tr.numpy(), int(to)))


def check_mesh(j, t):
    (ji, jr, jo), (ti, tr, to) = j, t
    assert to == jo
    assert ti.shape == ji.shape and ti.dtype == np.uint8
    assert tr.shape == jr.shape and tr.dtype == np.float32
    assert ((jr > 0) == (tr > 0)).mean() >= 0.999
    both = (jr > 0) & (tr > 0)
    np.testing.assert_allclose(tr[both], jr[both], rtol=1e-5)
    diff = np.abs(ji.astype(int) - ti.astype(int))
    assert (diff.max(axis=-1) > 0).mean() <= 0.001
    assert diff[both].max(initial=0) <= 1


def test_render_mesh_matches_jax():
    j, t = _both("render_mesh", max_bbox=32)
    check_mesh(j, t)
    img, rng, ovf = t
    assert ovf == 0 and (rng > 0).any() and (rng < 0).any()
    vis = rng > 0
    assert rng[vis].min() >= 800.0 * 0.95 and rng[vis].max() <= 8000 * 1.05
    assert np.all(img[rng < 0] == np.array([255, 0, 0], np.uint8))


def test_render_mesh_tiled_matches_jax_and_render_mesh():
    j, t = _both("render_mesh_tiled")
    check_mesh(j, t)
    _, direct = _both("render_mesh", max_bbox=32)
    for a, b in zip(t, direct):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fn,kw", [
    ("render_mesh", dict(max_bbox=6)),
    ("render_mesh_tiled", dict(bbox_classes=(6, 12)))],
    ids=["render_mesh", "render_mesh_tiled"])
def test_overflow_counts_match_jax(fn, kw):
    """Boxes too small for the near triangles: the same overflow count as
    the JAX package's, the rest rasterized alike."""
    j, t = _both(fn, **kw)
    assert t[2] > 0
    check_mesh(j, t)


def test_seam_cull_rule():
    """tests/test_mesh.py:74 on the port: a 360-degree render culls the
    triangles that span the +-180 seam and leaves no wider hole; as the
    JAX package's."""
    j, t = _both("render_mesh", max_bbox=32,
                 setup=dict(az0=-180.0, az1=180.0, zfar=5000.0))
    check_mesh(j, t)
    assert (t[1] > 0).any(axis=0).mean() > 0.95


def test_znear_clip():
    """tests/test_mesh.py:86 on the port: no fragment nearer than znear."""
    j, t = _both("render_mesh", w=128, h=64, max_bbox=48,
                 setup=dict(zfar=4000.0))
    check_mesh(j, t)
    r = t[1]
    assert (r[r > 0] >= 800.0 * 0.9).all()


def test_chunking_is_bitwise(monkeypatch):
    dem, p = _setup()
    td, tp = torch.from_numpy(np.asarray(dem)), params_from_jax(p, "cpu")
    kw = dict(width=256, height=128, cells_per_deg=CPD)
    whole = tmesh.render_mesh(td, tp, max_bbox=32, **kw)
    monkeypatch.setattr(tmesh, "FRAGMENT_BUDGET", 1000 * 32 * 32)
    for a, b in zip(whole, tmesh.render_mesh(td, tp, max_bbox=32, **kw)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    tiled = tmesh.render_mesh_tiled(td, tp, fragment_budget=20000, **kw)
    for a, b in zip(whole, tiled):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.parametrize("sampler", ["window", "step"])
def test_mesh_matches_raymarch_horizon(sampler):
    """tests/test_mesh.py:43's bounds on the port, against the window
    render and the step render of the triangulated surface: the first
    visible row per column within a pixel (median), 2 at the 95th
    percentile, ranges within 3% (median) on pixels both see."""
    dem, p = _setup()
    td, tp = torch.from_numpy(np.asarray(dem)), params_from_jax(p, "cpu")
    w, h = 256, 128
    _, rm, ovf = tmesh.render_mesh(td, tp, width=w, height=h,
                                   cells_per_deg=CPD, max_bbox=32)
    assert int(ovf) == 0
    k = (tcross.k_cross_for(8000.0, CPD, 34.0, n=td.shape[0])
         if sampler == "window" else 768)
    _, rr = render_panorama(td, tp, width=w, height=h, nsteps=k,
                            cells_per_deg=CPD, sampler=sampler,
                            surface="triangulated", lat_hint_deg=34.0)
    rm, rr = rm.numpy(), rr.numpy()

    def first(r):
        vis = r > 0
        return np.where(vis.any(axis=0), vis.argmax(axis=0), r.shape[0])
    hm, hr = first(rm), first(rr)
    both = (hm < h) & (hr < h)
    assert both.mean() > 0.97
    d = np.abs(hm[both] - hr[both])
    assert np.median(d) <= 1 and np.percentile(d, 95) <= 2
    mv = (rm > 0) & (rr > 0)
    assert np.median(np.abs(rm[mv] - rr[mv]) / np.maximum(rr[mv], 200.0)) \
        < 0.03
