"""Port parity for the DEM downloader: dem/mosaic.py's ``_fetch_dem``, the
API's ``allow_dem_downloads`` / ``dem_url_fmt`` and the CLI's
``--allow-dem-downloads`` / ``--dem-url``, against horizonator_tpu.

Every download comes from a loopback HTTP server on 127.0.0.1 (the cases of
tests/test_dem.py's TestDemAutoDownload). Tolerances: mosaic grids, the
fetched files and ``bounds_latlon_deg`` are equal; renders through the
downloaded tiles are within tests/test_torch_render.py's ``_compare`` of
the JAX package's.
"""

import gzip
import io
import threading
import zipfile
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest
from PIL import Image

from horizonator_tpu import cli as jcli
from horizonator_tpu import horizonator as JHorizonator
from horizonator_tpu.dem import hgt as jhgt
from horizonator_tpu.dem import load_mosaic as j_load_mosaic
from horizonator_tpu_torch import cli as tcli
from horizonator_tpu_torch import horizonator as THorizonator
from horizonator_tpu_torch.dem import hgt
from horizonator_tpu_torch.dem import load_mosaic as t_load_mosaic
from tests.conftest import make_synthetic_dem_dir
from tests.test_torch_render import _compare

LOADERS = (("jax", j_load_mosaic), ("torch", t_load_mosaic))


class Served:
    """A loopback HTTP server of ``payloads`` (url path -> bytes) that
    counts its hits; 404 for any other path."""

    def __init__(self, payloads):
        self.payloads = dict(payloads)
        self.hits = []
        served = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                served.hits.append(self.path)
                body = served.payloads.get(self.path)
                if body is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.srv = HTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()


def tile_bytes(fill):
    """One SRTM3 tile of constant elevation, as the file's bytes."""
    return np.full((hgt.SRTM3_EDGE, hgt.SRTM3_EDGE), fill, ">i2").tobytes()


def zip_bytes(members):
    zb = io.BytesIO()
    with zipfile.ZipFile(zb, "w") as z:
        for name, data in members.items():
            z.writestr(name, data)
    return zb.getvalue()


def _load_both(tmp_path, fmt, **kw):
    """The same fetch through both loaders, each into its own cache dir;
    {side: (mosaic, cache dir)}."""
    out = {}
    for side, load in LOADERS:
        d = tmp_path / side / "dems"
        out[side] = (load(34.4, -117.5, render_radius_cells=100,
                          datadir=str(d), dem_url_fmt=fmt, **kw), d)
    return out


@pytest.mark.parametrize("wrap", ["raw", "gz", "zip"])
def test_fetch_unwrap_and_cache(tmp_path, wrap):
    raw = tile_bytes(321)
    body, suffix = {"raw": (raw, ""), "gz": (gzip.compress(raw), ".gz"),
                    "zip": (zip_bytes({"N34W118.hgt": raw}), ".zip")}[wrap]
    with Served({f"/dem/N34W118.hgt{suffix}": body}) as s:
        fmt = f"{s.url}/dem/{{name}}{suffix}"
        got = _load_both(tmp_path, fmt)
        n_first = len(s.hits)
        for side, (m, d) in got.items():
            assert m.missing_tiles == [] and (m.grid == 321).all(), side
            assert (d / "N34W118.hgt").read_bytes() == raw
            assert not list(d.glob("*.part"))
        np.testing.assert_array_equal(got["torch"][0].grid,
                                      got["jax"][0].grid)
        assert n_first == 2             # one fetch a package
        # second load: cached, no refetch
        m2 = t_load_mosaic(34.4, -117.5, render_radius_cells=100,
                           datadir=str(got["torch"][1]), dem_url_fmt=fmt)
        assert (m2.grid == 321).all() and len(s.hits) == n_first


def test_fetch_multi_member_zip_picks_named_tile(tmp_path):
    """A region zip (viewfinderpanoramas style) yields the member named for
    THIS tile, never namelist()[0]."""
    body = zip_bytes({"L11/N35W118.hgt": tile_bytes(999),    # decoy first
                      "L11/N34W118.hgt": tile_bytes(321),
                      "L11/N34W119.hgt": tile_bytes(555)})
    with Served({"/dem/N34W118.hgt.zip": body}) as s:
        got = _load_both(tmp_path, s.url + "/dem/{name}.zip")
    for side, (m, _) in got.items():
        assert m.missing_tiles == [] and (m.grid == 321).all(), side


def test_fetch_multi_member_zip_without_match_fails_loudly(tmp_path, capsys):
    body = zip_bytes({"N35W118.hgt": tile_bytes(999),
                      "N35W119.hgt": tile_bytes(888)})
    with Served({"/dem/N34W118.hgt.zip": body}) as s:
        for side, load in LOADERS:
            m = load(34.4, -117.5, render_radius_cells=100,
                     datadir=str(tmp_path / side),
                     dem_url_fmt=s.url + "/dem/{name}.zip")
            assert len(m.missing_tiles) == 1 and (m.grid == 0).all(), side
            assert "none named N34W118.hgt" in capsys.readouterr().err
            assert not (tmp_path / side / "N34W118.hgt").exists()


def test_fetch_failure_degrades_to_sea(tmp_path, capsys):
    with Served({}) as s:                               # 404 everything
        for side, load in LOADERS:
            m = load(34.4, -117.5, render_radius_cells=100,
                     datadir=str(tmp_path / side),
                     dem_url_fmt=s.url + "/x/%s")
            assert len(m.missing_tiles) == 1 and (m.grid == 0).all(), side
            err = capsys.readouterr().err
            assert "download failed" in err and "sea" in err
            assert "/x/N34W118.hgt" in err
        assert s.hits == ["/x/N34W118.hgt"] * 2


def test_fetch_ns_field_and_silent_when_not_warning(tmp_path, capsys):
    """``{ns}`` is the tile's latitude part, as in DEM_URL_FMT_SRTM1's
    layout; warn_missing=False fetches and fails without a word."""
    with Served({"/N34/N34W118.hgt": tile_bytes(77)}) as s:
        got = _load_both(tmp_path, s.url + "/{ns}/{name}")
        for side, (m, _) in got.items():
            assert (m.grid == 77).all(), side
        capsys.readouterr()
        m = t_load_mosaic(34.4, -117.5, render_radius_cells=100,
                          datadir=str(tmp_path / "quiet"),
                          dem_url_fmt=s.url + "/none/{name}",
                          warn_missing=False)
    assert (m.grid == 0).all() and capsys.readouterr().err == ""


def test_api_srtm3_requires_url(tmp_path):
    for cls in (JHorizonator, THorizonator):
        kw = {} if cls is JHorizonator else {"device": "cpu"}
        with pytest.raises(ValueError, match="dem_url_fmt"):
            cls(34.4, -117.5, 32, 16, dir_dems=str(tmp_path / "dems"),
                render_radius_cells=64, allow_dem_downloads=True, **kw)


def test_api_srtm1_defaults_to_skadi(monkeypatch, tmp_path):
    """SRTM1 without a URL takes DEM_URL_FMT_SRTM1 in both packages (the
    loader is stubbed: no request leaves the process)."""
    from horizonator_tpu import api as japi
    from horizonator_tpu.dem.mosaic import DEM_URL_FMT_SRTM1 as JURL
    from horizonator_tpu_torch import api as tapi
    from horizonator_tpu_torch.dem.mosaic import DEM_URL_FMT_SRTM1 as TURL
    assert TURL == JURL
    seen = {}

    class Stop(Exception):
        pass

    for side, mod in (("jax", japi), ("torch", tapi)):
        def stub(*a, dem_url_fmt=None, _side=side, **kw):
            seen[_side] = dem_url_fmt
            raise Stop
        monkeypatch.setattr(mod, "load_mosaic", stub)
    for side, cls, kw in (("jax", JHorizonator, {}),
                          ("torch", THorizonator, {"device": "cpu"})):
        with pytest.raises(Stop):
            cls(34.4, -117.5, 32, 16, SRTM1=True, dir_dems=str(tmp_path),
                render_radius_cells=64, allow_dem_downloads=True, **kw)
    assert seen == {"jax": JURL, "torch": JURL}


def test_bounds_latlon_matches_jax(tmp_path):
    d = make_synthetic_dem_dir(tmp_path, {
        (34, -118): np.zeros((hgt.SRTM3_EDGE,) * 2, np.int16)})
    for at, r in (((34.5, -117.5), 100), ((34.97, -117.03), 128),
                  ((34.0, -118.0), 7)):
        mj = j_load_mosaic(*at, render_radius_cells=r, datadir=d,
                           warn_missing=False)
        mt = t_load_mosaic(*at, render_radius_cells=r, datadir=d,
                           warn_missing=False)
        assert mt.bounds_latlon_deg() == mj.bounds_latlon_deg()
        lat0, lon0, lat1, lon1 = mt.bounds_latlon_deg()
        assert lat1 - lat0 == pytest.approx((2 * r - 1) / 1200)
        assert lat0 < at[0] < lat1 and lon0 < at[1] < lon1


def _peak(lat, lon):
    z = 250.0 + 1900.0 * np.exp(-((lat - 34.47) ** 2 + (lon + 117.41) ** 2)
                                / (2 * 0.02 ** 2))
    return np.round(z).astype(np.int16)


@pytest.fixture(scope="module")
def served_tiles(tmp_path_factory):
    """One SRTM3 tile with a peak, served raw, and its bytes."""
    d = make_synthetic_dem_dir(tmp_path_factory.mktemp("src"),
                               {(34, -118): _peak})
    raw = (jhgt.hgt_path(d, 34, -118)).read_bytes()
    with Served({"/srtm/N34W118.hgt.gz": gzip.compress(raw)}) as s:
        yield s, raw, d


def test_api_downloads_render_matches_jax(served_tiles, tmp_path):
    """The API with allow_dem_downloads renders the downloaded tile as the
    JAX API does, and as a render from the local tile."""
    s, raw, local = served_tiles
    fmt = s.url + "/srtm/{name}.gz"
    out = {}
    for side, cls, kw in (("jax", JHorizonator, {}),
                          ("torch", THorizonator, {"device": "cpu"})):
        d = tmp_path / side
        h = cls(34.40, -117.45, 200, 80, dir_dems=str(d),
                render_radius_m=20000.0, allow_dem_downloads=True,
                dem_url_fmt=fmt, **kw)
        assert (d / "N34W118.hgt").read_bytes() == raw
        out[side] = h.render(-60, 60, znear=100.0, zfar=20000.0)
    _compare(*out["jax"], *out["torch"])
    h = THorizonator(34.40, -117.45, 200, 80, dir_dems=local,
                     render_radius_m=20000.0, device="cpu")
    img, rng = h.render(-60, 60, znear=100.0, zfar=20000.0)
    np.testing.assert_array_equal(out["torch"][0], img)
    np.testing.assert_array_equal(out["torch"][1], rng)


def test_cli_dem_downloads_match_jax(served_tiles, tmp_path):
    """--allow-dem-downloads --dem-url through both CLIs: the same tile
    lands in each --dirdems, and the PNG and ranges agree."""
    s, raw, _ = served_tiles
    got = {}
    for side, cli, extra in (("jax", jcli, []),
                             ("torch", tcli, ["--device", "cpu"])):
        d = tmp_path / side
        rc = cli.main([*extra, "--width", "200", "--height", "80",
                       "--image", str(tmp_path / f"{side}.png"),
                       "--ranges", str(tmp_path / f"{side}.npy"),
                       "--dirdems", str(d), "--zfar", "20000",
                       "--allow-dem-downloads", "--dem-url",
                       s.url + "/srtm/{name}.gz",
                       "34.40", "-117.45", "0", "60"])
        assert rc == 0
        assert (d / "N34W118.hgt").read_bytes() == raw
        got[side] = (np.asarray(Image.open(tmp_path / f"{side}.png"))
                     [:, :, ::-1], np.load(tmp_path / f"{side}.npy"))
    _compare(*got["jax"], *got["torch"])
