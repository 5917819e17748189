"""Port parity for geotiff.py and the CLI's --viewshed against
horizonator_tpu on the same inputs.

- write_geotiff: files byte for byte the JAX package's, for every dtype,
  both row orders, with and without nodata; the same errors;
- cell_bounds over the port's mosaic: equal to the JAX package's over its;
- --viewshed through both CLIs on synthetic SRTM3 tiles: the TIFFs' tags
  (size, format, pixel scale, tiepoint, geokeys) equal, so the bounds are
  equal; the rasters within test_torch_viewshed's SHARE, every differing
  cell on a visibility boundary of the JAX raster or the znear / zfar ring
  (the CLI's viewers sit at fractional cells, off the grid-line ties of
  test_torch_viewshed's scenes).
"""

import subprocess
import sys

import numpy as np
import pytest

from horizonator_tpu import cli as jcli
from horizonator_tpu.dem import load_mosaic as j_load_mosaic
from horizonator_tpu.geotiff import cell_bounds as j_cell_bounds
from horizonator_tpu.geotiff import write_geotiff as j_write_geotiff
from horizonator_tpu_torch import cli as tcli
from horizonator_tpu_torch.dem import load_mosaic
from horizonator_tpu_torch.geotiff import cell_bounds, write_geotiff
from tests.test_geotiff import BOUNDS, parse_tiff
from tests.test_torch_render import REPO, VIEW
from tests.test_torch_render import dem_dir  # noqa: F401 (fixture)
from tests.test_torch_viewshed import CELL_M, SHARE, _edge

CLI_ZFAR = 6000.0


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16,
                                   np.float32, bool])
def test_write_geotiff_bytes_match_jax(tmp_path, dtype):
    rng = np.random.default_rng(48)
    a = rng.uniform(-100, 3000, (37, 53))
    if np.dtype(dtype) == np.uint8:
        a = np.clip(a, 0, 255)
    if np.dtype(dtype) == np.uint16:
        a = np.clip(a, 0, 65535)
    a = (a > 1000) if dtype is bool else a.astype(dtype)
    for row0, nodata in (("south", -1), ("north", None), ("south", 0.5)):
        j_write_geotiff(tmp_path / "j.tif", a, bounds=BOUNDS, row0=row0,
                        nodata=nodata)
        write_geotiff(tmp_path / "t.tif", a, bounds=BOUNDS, row0=row0,
                      nodata=nodata)
        assert ((tmp_path / "t.tif").read_bytes()
                == (tmp_path / "j.tif").read_bytes())


@pytest.mark.parametrize("array,kw,match", [
    (np.zeros((4, 4, 3), np.uint8), {}, "2D"),
    (np.zeros((4, 4), np.float64), {}, "dtype"),
    (np.zeros((4, 4), np.uint8), dict(bounds=(35.0, -118.0, 34.0, -117.0)),
     "degenerate"),
    (np.zeros((4, 4), np.uint8), dict(row0="west"), "row0"),
], ids=["2D", "dtype", "degenerate", "row0"])
def test_write_geotiff_errors_match_jax(tmp_path, array, kw, match):
    kw = dict(dict(bounds=BOUNDS), **kw)
    for write in (j_write_geotiff, write_geotiff):
        with pytest.raises(ValueError, match=match):
            write(tmp_path / "bad.tif", array, **kw)


def test_cell_bounds_matches_jax(dem_dir):
    jm = j_load_mosaic(VIEW["lat"], VIEW["lon"], render_radius_m=20000.0,
                       datadir=dem_dir)
    tm = load_mosaic(VIEW["lat"], VIEW["lon"], render_radius_m=20000.0,
                     datadir=dem_dir)
    for lo, hi in ((None, None), ((3, 7), (3, 7)), ((10, 20), (200, 150))):
        assert cell_bounds(tm, lo, hi) == j_cell_bounds(jm, lo, hi)


def _cli_viewshed(cli, out, dem_dir, extra, prefix=()):
    rc = cli.main([*prefix, "--dirdems", dem_dir, "--zfar", str(CLI_ZFAR),
                   "--viewshed", str(out), *extra])
    assert rc == 0
    tags, pix = parse_tiff(out)
    h, w = tags[257][0], tags[256][0]
    return tags, np.frombuffer(pix, np.uint8).reshape(h, w)[::-1]


@pytest.mark.parametrize("extra", [
    ["34.40", "-117.45", "0", "180"],
    ["--viewshed-halfwidth", "40", "--znear", "300", "34.97", "-117.03",
     "30", "60"],
], ids=["full circle", "sector, half-width 40"])
def test_cli_viewshed_matches_jax(dem_dir, tmp_path, extra):
    jt, jv = _cli_viewshed(jcli, tmp_path / "j.tif", dem_dir, extra)
    tt, tv = _cli_viewshed(tcli, tmp_path / "t.tif", dem_dir, extra,
                           ("--device", "cpu"))
    assert tt == jt and tv.shape == jv.shape
    assert tv.any() and not tv.all()
    bad = tv != jv
    assert bad.mean() <= SHARE
    # the znear / zfar ring around the viewer (cell centres off the
    # viewer's fractional position, as the CLI frames them)
    lat = float(extra[-4])
    znear = float(extra[extra.index("--znear") + 1]) if "--znear" in extra \
        else 100.0
    hw = tv.shape[0] // 2
    off = np.arange(2 * hw) - hw + 0.5
    d = np.hypot(off[None, :] * CELL_M * np.cos(np.radians(lat)),
                 off[:, None] * CELL_M)
    ring = ((np.abs(d - znear) < 1.5 * CELL_M)
            | (np.abs(d - CLI_ZFAR) < 1.5 * CELL_M))
    assert not (bad & ~_edge(jv) & ~ring).any()


def test_cli_viewshed_composes_and_imports_no_jax(dem_dir, tmp_path):
    """--viewshed with --horizon-out writes both, in a process that imports
    neither jax nor horizonator_tpu."""
    code = f"""
import sys
from horizonator_tpu_torch import cli
rc = cli.main(["--device", "cpu", "--dirdems", {dem_dir!r}, "--zfar",
               "6000", "--viewshed", {str(tmp_path / "v.tif")!r},
               "--horizon-out", {str(tmp_path / "h.csv")!r}, "--width", "64",
               "34.40", "-117.45", "0", "180"])
assert rc == 0
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert not any(m.startswith("horizonator_tpu.") or m == "horizonator_tpu"
               for m in sys.modules)
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(REPO),
                            "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")
    assert (tmp_path / "v.tif").stat().st_size > 0
    assert len((tmp_path / "h.csv").read_text().splitlines()) == 65
