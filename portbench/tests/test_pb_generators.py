"""The seeded inputs: terrain and traffic repeat by seed and keep their
sizes; tiles join."""

import numpy as np
import pytest

from portbench import harness, terrain
from portbench.traffic import Requests, kind

SEEDS = [0, 7, 2 ** 31 + 11, 2 ** 40 + 3, -5]


def _reqs(cell, seed, n=5):
    f = harness.resolve(cell, harness.manifest())
    gen = Requests(f["mix"], f["config"], seed)
    return [gen.next() for _ in range(n)], f


def _same(a, b):
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


@pytest.mark.parametrize("seed", SEEDS)
def test_terrain_by_seed(seed):
    a = terrain.mosaic(seed, 1, 2, 1200)
    assert a.dtype == np.int16 and a.shape == (1201, 2401)
    assert np.array_equal(a, terrain.mosaic(seed, 1, 2, 1200))
    assert not np.array_equal(a, terrain.mosaic(seed + 1, 1, 2, 1200))
    assert a.min() >= 0 and 100 < a.mean() < 1500


def test_tiles_join(tmp_path):
    grid = terrain.mosaic(3, 2, 2, 1200)
    paths = terrain.write_tiles(grid, 33, -119, 1200, tmp_path)
    assert sorted(p.name for p in paths) == ["N33W118.hgt", "N33W119.hgt",
                                             "N34W118.hgt", "N34W119.hgt"]
    sw = np.fromfile(tmp_path / "N33W119.hgt", ">i2").reshape(1201, 1201)
    se = np.fromfile(tmp_path / "N33W118.hgt", ">i2").reshape(1201, 1201)
    assert np.array_equal(sw[::-1], grid[:1201, :1201])
    assert np.array_equal(sw[:, -1], se[:, 0])


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.manifest()["workloads"]])
@pytest.mark.parametrize("seed", SEEDS)
def test_traffic_by_seed(cell, seed):
    a, f = _reqs(cell, seed)
    b, _ = _reqs(cell, seed)
    c, _ = _reqs(cell, seed + 1)
    assert all(_same(x, y) for x, y in zip(a, b))
    assert not all(_same(x, y) for x, y in zip(a, c))
    valid = kind(f["mix"]).valid
    assert all(valid(f["mix"]["viewpoints"], f["config"], r) for r in a)


def test_walk_steps():
    a, f = _reqs("srtm3-40km.pano-single", 9, 200)
    lat0, lon0 = f["config"]["view_latlon"]
    prev = (lat0, lon0)
    for r in a:
        dn = (r["lat"] - prev[0]) * 111194.93
        de = (r["lon"] - prev[1]) * 111194.93 * np.cos(np.radians(prev[0]))
        assert 29.9 <= np.hypot(dn, de) <= 300.1
        prev = (r["lat"], r["lon"])
