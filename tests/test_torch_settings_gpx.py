"""Port parity for settings.py (florb settings.xml) and gpx.py, and the
texture path's settings.xml tile-server lookup, against horizonator_tpu.

The cases of tests/test_settings_gpx.py run through both packages; files
written by one package read back equal through the other. Tile fetches go
to loopback servers only: the default URL formats are pointed at a port
that refuses at once, so a lookup that misses the settings cannot leave
the machine.
"""

import os

import numpy as np
import pytest
from PIL import Image

from horizonator_tpu import settings as jsettings
from horizonator_tpu import tiles as jtiles
from horizonator_tpu.gpx import load_gpx as j_load_gpx
from horizonator_tpu_torch import settings as tsettings
from horizonator_tpu_torch import tiles as ttiles
from horizonator_tpu_torch.gpx import load_gpx as t_load_gpx
from tests.test_settings_gpx import GPX
from tests.test_torch_dem_fetch import Served

SETTINGS = (jsettings, tsettings)


def test_settings_defaults_and_roundtrip(tmp_path):
    assert tsettings.DEFAULTS == jsettings.DEFAULTS
    for mod, other in (SETTINGS, SETTINGS[::-1]):
        p = str(tmp_path / f"{mod.__name__}.xml")
        s = mod.Settings(p)
        assert s.get("osm::tileserver") == mod.DEFAULTS["osm::tileserver"]
        assert s.get("osm::zoommax", type=int) == 18
        s.set("osm::tileserver", "https://example.com/tiles/")
        s.set("viewer::last_lat", 34.2884)
        s.save()
        assert os.path.exists(p) and not os.path.exists(p + ".tmp")
        for reader in (mod, other):          # each package reads the other's
            s2 = reader.Settings(p)
            assert s2.get("osm::tileserver") == "https://example.com/tiles/"
            assert abs(s2.get("viewer::last_lat", type=float)
                       - 34.2884) < 1e-9
            assert s2.get("nope", default="d") == "d"
            assert s2.get("osm::zoommin", type=int) == 0
            assert s2.get("viewer::last_lat", type=bool) is False
            assert s2.get("osm::tileserver", default=-1, type=int) == -1
            assert "osm::zoommax" in s2 and "nope" not in s2
    assert (tmp_path / f"{jsettings.__name__}.xml").read_text() == \
        (tmp_path / f"{tsettings.__name__}.xml").read_text()


def test_settings_bad_file_ignored(tmp_path):
    p = tmp_path / "settings.xml"
    p.write_text("<not-even-xml")
    for mod in SETTINGS:
        s = mod.Settings(str(p))
        assert s.get("osm::zoommax", type=int) == 18
        assert s._kv == mod.DEFAULTS


def test_gpx_tracks_and_routes(tmp_path):
    p = tmp_path / "t.gpx"
    p.write_text(GPX)
    segs = t_load_gpx(str(p))
    assert segs == j_load_gpx(str(p))
    assert len(segs) == 3
    assert segs[0][0] == (34.1, -117.5)
    assert len(segs[0]) == 3 and len(segs[1]) == 2 and len(segs[2]) == 2


@pytest.fixture
def user_settings(tmp_path, monkeypatch):
    """Point both packages' settings singletons at one settings.xml and
    both default tile URLs at a port that refuses at once."""
    def use(tileserver):
        p = tmp_path / "settings.xml"
        s = tsettings.Settings(str(p))
        if tileserver is not None:
            s.set("osm::tileserver", tileserver)
        s.save()
        for mod in SETTINGS:
            monkeypatch.setattr(mod, "_instance", mod.Settings(str(p)))
    for mod in (jtiles, ttiles):
        monkeypatch.setattr(mod, "DEFAULT_TILES_URL_FMT",
                            "http://127.0.0.1:9/%d/%d/%d.png")
    return use


@pytest.mark.parametrize("server,want", [
    (None, None),
    ("https://tile.openstreetmap.org/", None),
    ("http://127.0.0.1:9/custom/", "http://127.0.0.1:9/custom/%d/%d/%d.png"),
    ("http://127.0.0.1:9/custom", "http://127.0.0.1:9/custom/%d/%d/%d.png"),
], ids=["unset", "default server", "custom", "custom no slash"])
def test_settings_url_fmt_matches_jax(user_settings, server, want):
    user_settings(server)
    assert ttiles._settings_url_fmt() == jtiles._settings_url_fmt() == want


def test_build_atlas_uses_settings_tileserver(user_settings, tmp_path):
    """With no URL format given, the atlas fetches from the user's
    osm::tileserver, as the JAX package's does: the same tiles, the same
    atlas."""
    tile = np.random.default_rng(5).integers(0, 256, (256, 256, 3),
                                             dtype=np.uint8)
    p = tmp_path / "t.png"
    Image.fromarray(tile).save(p)
    body = p.read_bytes()
    lat, lon, r, cpd = 34.4, -117.45, 40, 1200
    x, y = ttiles.tile_xy_from_latlon(lat, lon, 12)
    # every tile of the atlas's range, so no fetch falls through
    paths = {f"/srv/12/{i}/{j}.png": body
             for i in range(x - 2, x + 3) for j in range(y - 2, y + 3)}
    with Served(paths) as s:
        user_settings(s.url + "/srv/")
        got = {}
        for side, mod in (("jax", jtiles), ("torch", ttiles)):
            got[side] = mod.build_atlas(
                lat, lon, r, cpd, lon - r / cpd, lat - r / cpd,
                dir_tiles=str(tmp_path / side), allow_downloads=True)
        assert s.hits and all(h in paths for h in s.hits)
    (aj, pj), (at, pt) = got["jax"], got["torch"]
    np.testing.assert_array_equal(at, aj)
    assert pt == pj
    assert (at[:256, :256] == tile[:, :, ::-1]).all()
