"""Port parity: render/texture.py, tiles/ and sun_position vs the JAX package.

The same inputs, made with numpy from a seed, go through horizonator_tpu
(JAX on the CPU) and horizonator_tpu_torch (CPU). Tolerances, and why:
- integer work is bitwise: slippy-tile indices, every packing and
  unpacking (pack_cell_colors, prepare_color_planes().full_packed,
  pack_atlas, unpack_color_planes), the tile cache and the atlas;
- atlas pixel coordinates, against the jitted JAX functions (the form
  the render path runs): x bitwise (the port repeats XLA's constant
  folding and FMAs), y within 0.0625 px, two float32 ulps of a tile
  coordinate near 2^11 times 256 (torch.sin/cos/log differ from XLA's by
  an ulp; measured 0.031);
- atlas samples (sample_atlas_bgr, atlas_to_grid_colors) on a random
  atlas: >= 90% bitwise (measured 93-96%), all within 16 of 255, that
  0.0625 px times the steepest texel step (measured <= 8);
- hillshade planes within 1e-3 of 255 (measured <= 5e-5): the same
  operations, with XLA free to fuse the shade's multiply-adds;
- sun_position: the same host-side double-precision formulas, equal.
"""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from horizonator_tpu import geometry as jgeom
from horizonator_tpu import tiles as jtiles
from horizonator_tpu.render import texture as jtex
from horizonator_tpu_torch import geometry as tgeom
from horizonator_tpu_torch import tiles as ttiles
from horizonator_tpu_torch.render import texture as ttex
from tests.test_torch_geometry import CPD, make_dem

REPO = Path(__file__).resolve().parent.parent
AP = ttex.AtlasParams(-117.6, 34.2, 705, 1630, 6, 6)


def _t(x):
    return torch.from_numpy(np.array(np.asarray(x)))


@pytest.mark.parametrize("lat,lon,zoom", [(34.2884, -117.7134, 12),
                                          (-33.9, 151.2, 12), (0.0, 0.0, 5),
                                          (71.3, -156.8, 14)])
def test_tile_xy_equal(lat, lon, zoom):
    assert (ttex.tile_xy_from_latlon(lat, lon, zoom)
            == jtex.tile_xy_from_latlon(lat, lon, zoom))


def test_packing_bitwise():
    rng = np.random.default_rng(0)
    # off-grid values: rounding half to even, and the clip to u8
    planes = np.concatenate([
        rng.integers(0, 256, (3, 32, 40)).astype(np.float32),
        rng.uniform(-20.0, 280.0, (3, 32, 40)).astype(np.float32),
        np.full((3, 2, 40), 2.5, np.float32)], axis=1)
    np.testing.assert_array_equal(
        ttex.pack_cell_colors(torch.from_numpy(planes)).numpy(),
        np.asarray(jtex.pack_cell_colors(jnp.asarray(planes))))
    two = planes[:, :64, :40].repeat(2, axis=2)[:, :, :64]
    full = ttex.prepare_color_planes(torch.from_numpy(two)).full_packed
    want = jtex.prepare_color_planes(jnp.asarray(two)).full_packed
    np.testing.assert_array_equal(full.numpy(), np.asarray(want))
    assert ttex.prepare_color_planes(torch.from_numpy(two)).n == 32
    np.testing.assert_array_equal(
        ttex.unpack_color_planes(full).numpy(),
        np.asarray(jtex.unpack_color_planes(want)))
    atlas = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        ttex.pack_atlas(torch.from_numpy(atlas)).numpy(),
        np.asarray(jtex.pack_atlas(jnp.asarray(atlas))))


def _grid_positions(seed, shape=(40, 50)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-5.0, 300.0, shape).astype(np.float32),
            rng.uniform(-5.0, 300.0, shape).astype(np.float32))


def _close_samples(got, want):
    d = np.abs(got - np.asarray(want))
    assert got.shape == want.shape
    assert (d == 0).mean() >= 0.9 and d.max() <= 16.0


def test_atlas_px_and_samples():
    ii, jj = _grid_positions(1)
    jap = jtex.AtlasParams(*AP)
    pxj, pyj = jax.jit(functools.partial(
        jtex.atlas_px_from_grid, ap=jap, cells_per_deg=CPD))(
        jnp.asarray(ii), jnp.asarray(jj))
    pxt, pyt = ttex.atlas_px_from_grid(_t(ii), _t(jj), AP, CPD)
    np.testing.assert_array_equal(pxt.numpy(), np.asarray(pxj))
    assert np.abs(pyt.numpy() - np.asarray(pyj)).max() <= 0.0625
    rng = np.random.default_rng(2)
    atlas = rng.integers(0, 256, (6 * 256, 6 * 256, 3)).astype(np.uint8)
    packed = jtex.pack_atlas(jnp.asarray(atlas))
    sample = jax.jit(functools.partial(jtex.sample_atlas_bgr, ap=jap,
                                       cells_per_deg=CPD))
    for a_j, a_t in ((packed, _t(packed)), (jnp.asarray(atlas), _t(atlas))):
        sj = sample(a_j, i_pos=jnp.asarray(ii), j_pos=jnp.asarray(jj))
        st = ttex.sample_atlas_bgr(a_t, AP, _t(ii), _t(jj), CPD).numpy()
        assert st.shape == ii.shape + (3,)
        _close_samples(st, sj)


@pytest.mark.parametrize("scale", [1, 2])
def test_atlas_to_grid_colors(scale):
    rng = np.random.default_rng(4)
    atlas = rng.integers(0, 1 << 24, (6 * 256, 6 * 256)).astype(np.int32)
    n = 96
    cj = jax.jit(functools.partial(
        jtex.atlas_to_grid_colors, ap=jtex.AtlasParams(*AP), n=n,
        cells_per_deg=CPD, scale=scale))(jnp.asarray(atlas))
    ct = ttex.atlas_to_grid_colors(_t(atlas), AP, n, CPD, scale=scale)
    assert ct.shape == (3, scale * n, scale * n)
    _close_samples(ct.numpy(), cj)


@pytest.mark.parametrize("scale", [1, 2])
@pytest.mark.parametrize("az,alt,lat", [(315.0, 45.0, 34.0),
                                        (120.0, 12.0, -51.0)])
def test_hillshade_planes(scale, az, alt, lat):
    dem = make_dem(97, rough=40.0)
    kw = dict(sun_az_deg=az, sun_alt_deg=alt, scale=scale)
    hj = np.asarray(jtex.hillshade_planes(jnp.asarray(dem), CPD, lat, **kw))
    ht = ttex.hillshade_planes(torch.from_numpy(dem), CPD, lat, **kw)
    assert ht.shape == hj.shape == (3, scale * 97, scale * 97)
    assert np.abs(ht.numpy() - hj).max() <= 1e-3
    assert hj.std() > 5.0                       # real relief, not flat


def test_hillshade_guards():
    dem = torch.from_numpy(make_dem(16))
    # cast shadows only darken (tests/test_torch_shadows.py holds them
    # against the JAX package)
    base = ttex.hillshade_planes(dem, CPD, 34.0)
    shad = ttex.hillshade_planes(dem, CPD, 34.0, cast_shadows=True)
    assert shad.shape == base.shape and bool((shad <= base).all())
    with pytest.raises(ValueError):
        ttex.hillshade_planes(dem, CPD, 34.0, scale=3)


def test_scene_from_jax():
    rng = np.random.default_rng(5)
    c2 = rng.integers(0, 256, (3, 32, 32)).astype(np.float32)
    cp = jtex.prepare_color_planes(jnp.asarray(c2))
    atlas = jtex.pack_atlas(jnp.asarray(
        rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)))
    cpt, at, apt = ttex.scene_from_jax(cp, atlas, jtex.AtlasParams(*AP),
                                        device="cpu")
    assert isinstance(cpt, ttex.ColorPlanes2x) and cpt.n == 16
    np.testing.assert_array_equal(cpt.full_packed.numpy(),
                                  np.asarray(cp.full_packed))
    np.testing.assert_array_equal(at.numpy(), np.asarray(atlas))
    assert apt == AP and isinstance(apt, ttex.AtlasParams)
    cells, _, _ = ttex.scene_from_jax(jnp.asarray(c2), device="cpu")
    np.testing.assert_array_equal(cells.numpy(), c2)


@pytest.mark.parametrize("when", ["2024-06-21T19:30:00", "2019-12-01T03:00:00",
                                  "2031-03-20T12:00:00+02:00"])
def test_sun_position_equal(when):
    assert (tgeom.sun_position(34.4, -117.6, when)
            == jgeom.sun_position(34.4, -117.6, when))


def _fill_cache(root, x_range, y_range, seed):
    rng = np.random.default_rng(seed)
    for x in x_range:
        for y in y_range:
            p = ttiles.tile_path(str(root), "mapnik", 12, x, y)
            p.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(rng.integers(0, 256, (256, 256, 3)).astype(
                np.uint8)).save(p)


def test_tiles_atlas_equal(tmp_path):
    lat, lon, radius = 34.40, -117.45, 200
    x_lo, y_lo = ttex.tile_xy_from_latlon(lat + radius / CPD,
                                          lon - radius / CPD, 12)
    x_hi, y_hi = ttex.tile_xy_from_latlon(lat - radius / CPD,
                                          lon + radius / CPD, 12)
    _fill_cache(tmp_path, range(x_lo, x_hi + 1), range(y_lo, y_hi + 1), 6)
    kw = dict(dir_tiles=str(tmp_path), allow_downloads=False)
    at, apt = ttiles.build_atlas(lat, lon, radius, CPD, -117.6, 34.2, **kw)
    aj, apj = jtiles.build_atlas(lat, lon, radius, CPD, -117.6, 34.2, **kw)
    np.testing.assert_array_equal(at, aj)
    assert tuple(apt) == tuple(apj) and at.shape[0] > 256
    assert (ttiles.tile_path("/d", "m", 12, 3, 4)
            == jtiles.tile_path("/d", "m", 12, 3, 4))
    with pytest.raises(FileNotFoundError):
        ttiles.build_atlas(lat + 1.0, lon, radius, CPD, -117.6, 35.2, **kw)
    # a missing tile under on_error="placeholder": flat gray, no raise
    a2, _ = ttiles.build_atlas(lat + 1.0, lon, 8, CPD, -117.6, 35.2,
                               on_error="placeholder", **kw)
    assert (a2 == 200).all()


def test_cached_tile_needs_neither_pil_nor_requests(tmp_path):
    p = ttiles.tile_path(str(tmp_path), "mapnik", 12, 708, 1632)
    p.parent.mkdir(parents=True)
    p.write_bytes(b"not decoded here")
    code = f"""
import sys
from horizonator_tpu_torch import tiles
p = tiles.fetch_tile({str(tmp_path)!r}, "mapnik", "http://x/%d/%d/%d.png",
                     12, 708, 1632, allow_downloads=False)
assert p.name == "1632.png"
try:
    tiles.fetch_tile({str(tmp_path)!r}, "mapnik", "http://x/%d/%d/%d.png",
                     12, 708, 1633, allow_downloads=False)
except FileNotFoundError:
    pass
else:
    raise AssertionError("missing tile without downloads must raise")
assert "PIL" not in sys.modules and "requests" not in sys.modules
assert "jax" not in sys.modules
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                            "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")
