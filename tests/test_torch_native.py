"""Port parity for the native DEM loader (``_native``, hgt_native.cpp built
with g++ on first use): the cases of tests/test_native.py, each through
both packages, with the mosaic grids bitwise equal to horizonator_tpu's on
the native and the numpy path; and the port's build (stale rebuild, an
atomic publish that leaves no temporary behind).
"""

import ctypes
import os

import numpy as np
import pytest

from horizonator_tpu import _native as j_native
from horizonator_tpu.dem import load_mosaic as j_load_mosaic
from horizonator_tpu_torch import _native as t_native
from horizonator_tpu_torch.dem import hgt
from horizonator_tpu_torch.dem import load_mosaic as t_load_mosaic

NATIVES = ((j_native, j_load_mosaic), (t_native, t_load_mosaic))


@pytest.fixture(scope="module")
def libs():
    lj, lt = j_native.get_lib(), t_native.get_lib()
    if lj is None or lt is None:
        pytest.skip("native toolchain unavailable")
    return lj, lt


def _numpy_path(monkeypatch):
    """Force both packages onto the numpy loader, as
    HORIZONATOR_TPU_NO_NATIVE does for a fresh process."""
    monkeypatch.setenv("HORIZONATOR_TPU_NO_NATIVE", "1")
    for mod, _ in NATIVES:
        monkeypatch.setattr(mod, "_tried", False)
        monkeypatch.setattr(mod, "_lib", None)


def test_native_decode_matches_numpy(tmp_path, libs):
    edge = hgt.SRTM3_EDGE
    grid = np.random.default_rng(3).integers(-500, 4000, (edge, edge),
                                             dtype=np.int16)
    p = tmp_path / "N10E020.hgt"
    hgt.write_hgt(p, grid)
    for lib in libs:
        out = np.zeros((edge, edge), np.int16)
        assert lib.hgt_decode(str(p).encode(), edge,
                              out.ctypes.data_as(ctypes.c_void_p)) == 0
        np.testing.assert_array_equal(out, grid)
    assert libs[1].hgt_decode(str(tmp_path / "none.hgt").encode(), edge,
                              out.ctypes.data_as(ctypes.c_void_p)) == 1


@pytest.mark.parametrize("at,radius", [((35.0, -117.0), 300),
                                       ((34.63, -117.81), 150)],
                         ids=["corner of four", "inside one"])
def test_mosaic_native_vs_numpy_paths(tmp_path, monkeypatch, libs, at,
                                      radius):
    edge = hgt.SRTM3_EDGE

    def f(lat, lon):
        return np.round(800 + 600 * np.sin(lat * 5) * np.cos(lon * 3)
                        - 400 * np.sin(lon * 7)).astype(np.int16)

    d = tmp_path / "dems"
    for t in [(34, -118), (34, -117), (35, -118), (35, -117)]:
        lat = t[0] + 1.0 - np.arange(edge) / (edge - 1)
        lon = t[1] + np.arange(edge) / (edge - 1)
        hgt.write_hgt(d / hgt.hgt_filename(*t),
                      f(lat[:, None], lon[None, :]))
    kw = dict(render_radius_cells=radius, datadir=str(d))
    native = [load(*at, **kw) for _, load in NATIVES]
    _numpy_path(monkeypatch)
    plain = [load(*at, **kw) for _, load in NATIVES]
    assert t_native.get_lib() is None
    ref = native[0]
    for m in native[1:] + plain:
        np.testing.assert_array_equal(m.grid, ref.grid)
        assert m.origin_dem_lon_lat == ref.origin_dem_lon_lat
        assert m.origin_dem_cellij == ref.origin_dem_cellij
    assert ref.grid.max() > ref.grid.min() + 300      # real relief


def test_native_missing_and_empty(tmp_path, libs):
    # empty file -> silent sea; missing -> warning path handled in python
    d = tmp_path / "dems"
    d.mkdir()
    (d / "N34W118.hgt").touch()
    for _, load in NATIVES:
        m = load(34.5, -117.5, render_radius_cells=100, datadir=str(d))
        assert m.grid.max() == 0
        assert len(m.missing_tiles) == 0   # empty file is not "missing"


def test_native_open_failure_distinct_from_empty(tmp_path, libs):
    # rc=4 (open failure) vs rc=1 (zero-size) vs rc=2 (size mismatch)
    edge = hgt.SRTM3_EDGE
    grid = np.zeros((64, 64), np.int16)
    dangling = tmp_path / "N34W118.hgt"
    dangling.symlink_to(tmp_path / "nonexistent-target.hgt")
    empty = tmp_path / "N34W117.hgt"
    empty.touch()
    short = tmp_path / "N34W116.hgt"
    short.write_bytes(b"\0" * 10)
    for mod, _ in NATIVES:
        assert mod.blit_window(dangling, edge, grid, 0, 0) == 4
        assert mod.blit_window(empty, edge, grid, 0, 0) == 1
        assert mod.blit_window(short, edge, grid, 0, 0) == 2
    with pytest.raises(ValueError):
        t_native.blit_window(empty, edge, grid.astype(np.int32), 0, 0)


def test_mosaic_short_tile_raises(tmp_path, libs):
    d = tmp_path / "dems"
    d.mkdir()
    (d / "N34W118.hgt").write_bytes(b"\0" * 100)
    for _, load in NATIVES:
        with pytest.raises(ValueError, match="unexpected size"):
            load(34.5, -117.5, render_radius_cells=100, datadir=str(d))


def test_mosaic_unreadable_tile_warns_as_sea(tmp_path, monkeypatch, capsys,
                                             libs):
    # an existing-but-unreadable tile (rc=4 from the native blit) WARNS and
    # renders as sea, like the reference's couldn't-open path (dem.c:199-208)
    d = tmp_path / "dems"
    d.mkdir()
    (d / "N34W118.hgt").touch()   # exists() passes
    for mod, load in NATIVES:
        monkeypatch.setattr(mod, "blit_window", lambda *a, **k: 4)
        m = load(34.5, -117.5, render_radius_cells=100, datadir=str(d))
        monkeypatch.undo()
        assert m.grid.max() == 0
        assert len(m.missing_tiles) == 1
        assert "couldn't open DEM file" in capsys.readouterr().err


def test_native_negative_clamp(tmp_path, libs):
    edge = hgt.SRTM3_EDGE
    grid = np.full((edge, edge), -100, np.int16)   # Death Valley everywhere
    grid[:600] = 1234
    d = tmp_path / "dems"
    hgt.write_hgt(d / "N34W118.hgt", grid)
    got = [load(34.5, -117.5, render_radius_cells=50, datadir=str(d)).grid
           for _, load in NATIVES]
    np.testing.assert_array_equal(got[1], got[0])
    assert got[1].min() == 0 and set(np.unique(got[1])) == {0, 1234}


def test_native_stale_library_rebuilt(tmp_path, monkeypatch, libs):
    """A library older than its source is rebuilt on the next get_lib(),
    through a per-process temporary published with os.replace; a library
    newer than the source is loaded as it is."""
    lib = tmp_path / "_build" / "libhgt_native.so"
    lib.parent.mkdir()
    lib.write_bytes(b"not a library")
    old = os.stat(t_native._SRC).st_mtime - 100
    os.utime(lib, (old, old))
    monkeypatch.setattr(t_native, "_LIB", lib)
    monkeypatch.setattr(t_native, "_tried", False)
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.delenv("HORIZONATOR_TPU_NO_NATIVE", raising=False)
    assert t_native.get_lib() is not None
    assert lib.read_bytes()[:4] == b"\x7fELF"
    assert sorted(p.name for p in lib.parent.iterdir()) == [lib.name]
    # fresh and newer than the source: loaded, not rebuilt
    mtime = lib.stat().st_mtime_ns
    monkeypatch.setattr(t_native, "_tried", False)
    assert t_native.get_lib() is not None
    assert lib.stat().st_mtime_ns == mtime
