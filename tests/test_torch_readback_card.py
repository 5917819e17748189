"""The API's readback on the card, at the benchmark's pano view (4096x1024,
360 degrees, zfar 40 km, a 1000-cell window on 3 x 3 seeded SRTM3
tiles): render() and render_batch() bitwise the pageable ``.cpu()``
copies of the same device tensors, each array a view of its own
page-locked block (a later render leaves an earlier one's arrays as they
were), ``strict_coverage`` still raising on a guard that reports
truncated columns, and two syncs a render by CUDA's sync debug mode.
Skips without a card. The module imports no JAX, so it runs on a machine
with a card and without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_readback_card.py
"""

import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from horizonator_tpu_torch import api, profiling
from horizonator_tpu_torch.dem import hgt

pytestmark = pytest.mark.card
W, H = 4096, 1024
VIEW = (34.2884, -117.7134)
KW = dict(znear=100.0, zfar=40000.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def dems(tmp_path):
    """3 x 3 SRTM3 tiles (N33-N35, W119-W117) of smooth hills with seeded
    noise, row 0 north."""
    d = tmp_path / "dems"
    d.mkdir()
    rng = np.random.default_rng(11)
    edge = hgt.SRTM3_EDGE
    for tlat in (33, 34, 35):
        for tlon in (-119, -118, -117):
            lat = (tlat + 1.0 - np.arange(edge) / (edge - 1))[:, None]
            lon = (tlon + np.arange(edge) / (edge - 1))[None, :]
            z = (900 + 700 * np.sin(lat * 23.0) * np.cos(lon * 19.0)
                 + 300 * np.sin(lat * 71.0 + 1.3) * np.cos(lon * 57.0)
                 + 20.0 * rng.standard_normal((edge, edge)))
            hgt.write_hgt(d / hgt.hgt_filename(tlat, tlon),
                          np.round(np.maximum(z, 0)).astype(np.int16))
    return str(d)


def _api(dems, card, **kw):
    return api.horizonator(*VIEW, W, H, dir_dems=dems,
                           render_radius_cells=1000, device=str(card), **kw)


@pytest.fixture
def pageable(monkeypatch):
    """Each readback's tensors also copied as before (``.cpu().numpy()``,
    pageable), a list a call."""
    seen = []
    real = api._to_host

    def spy(*tensors):
        seen.append([t.cpu().numpy() for t in tensors])
        return real(*tensors)

    monkeypatch.setattr(api, "_to_host", spy)
    return seen


def _pinned(a):
    return isinstance(a.base, torch.Tensor) and a.base.is_pinned()


def test_render_bitwise_pinned_own(card, dems, pageable):
    """Two renders from two viewpoints: each one's image and ranges equal
    the pageable copies bitwise, in page-locked memory of their own; the
    first's arrays are unchanged by the second render."""
    h = _api(dems, card, strict_coverage=True)
    img1, rng1 = h.render(-180, 180, lat=VIEW[0], lon=VIEW[1], **KW)
    keep = img1.copy(), rng1.copy()
    img2, rng2 = h.render(-180, 180, lat=VIEW[0] + 0.01,
                          lon=VIEW[1] - 0.01, **KW)
    assert len(pageable) == 2
    for (img, rng), (pimg, prng, guard) in zip(((img1, rng1), (img2, rng2)),
                                                pageable):
        assert img.shape == (H, W, 3) and img.dtype == np.uint8
        assert rng.shape == (H, W) and rng.dtype == np.float32
        np.testing.assert_array_equal(img, pimg)
        np.testing.assert_array_equal(rng, prng)
        assert not guard.any()
        assert _pinned(img) and _pinned(rng)
    np.testing.assert_array_equal(img1, keep[0])
    np.testing.assert_array_equal(rng1, keep[1])
    assert not np.array_equal(rng1, rng2)
    for a in (img1, rng1):
        for b in (img2, rng2):
            assert not np.shares_memory(a, b)
    assert h._last["ranges"] is rng2
    ranges_only = h.render(-180, 180, return_image=False, **KW)
    np.testing.assert_array_equal(ranges_only, rng2)
    assert _pinned(ranges_only)


def test_strict_coverage_raises(card, dems):
    """A manual nsteps below the budget truncates columns: the render
    warns, and raises under strict_coverage, as before."""
    with pytest.warns(RuntimeWarning, match="columns stopped marching"):
        _api(dems, card, nsteps=64).render(-180, 180, **KW)
    with pytest.raises(RuntimeError, match=r"^render\(\): .*columns stopped "
                                           r"marching short of zfar"):
        _api(dems, card, nsteps=64, strict_coverage=True).render(
            -180, 180, **KW)


def _cuda_syncs(call) -> int:
    """Synchronizing CUDA operations in ``call()``, by the sync debug
    mode's warnings."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing CUDA operation" in str(w.message)
               for w in seen)


def test_render_two_syncs(card, dems):
    """A warm render: 2 syncs by CUDA's sync debug mode (the params'
    upload and the readback), as the recorder counts them, and one
    pinned readback."""
    h = _api(dems, card, strict_coverage=True)
    h.render(-180, 180, **KW)
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        n_cuda = _cuda_syncs(lambda: h.render(-180, 180, lat=VIEW[0] + 0.002,
                                              lon=VIEW[1], **KW))
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    print(f"CUDA sync debug {n_cuda}, recorder {counters}; "
          f"{torch.cuda.get_device_name(card)}")
    assert n_cuda == 2
    assert counters["hz.host_syncs"] == (2, 2)
    assert counters["hz.api.pinned_readback"] == (1, 1)


def test_render_batch_bitwise(card, dems, pageable):
    """render_batch of 3 viewpoints: images, ranges and the guard's counts
    equal the pageable copies bitwise, pinned, and each viewpoint equals
    its single render."""
    h = _api(dems, card, strict_coverage=True)
    lats = [VIEW[0], VIEW[0] + 0.01, VIEW[0] - 0.005]
    lons = [VIEW[1], VIEW[1] - 0.01, VIEW[1] + 0.007]
    imgs, rngs = h.render_batch(-180, 180, lats, lons, **KW)
    (pimgs, prngs, guard), = pageable
    assert imgs.shape == (3, H, W, 3) and rngs.shape == (3, H, W)
    np.testing.assert_array_equal(imgs, pimgs)
    np.testing.assert_array_equal(rngs, prngs)
    assert guard.shape == (3, 2) and not guard.any()
    assert _pinned(imgs) and _pinned(rngs)
    for b in range(3):
        img, rng = h.render(-180, 180, lat=lats[b], lon=lons[b], **KW)
        np.testing.assert_array_equal(imgs[b], img)
        np.testing.assert_array_equal(rngs[b], rng)
