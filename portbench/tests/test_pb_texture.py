"""The textured cells' own pieces: the seeded tile cache decodes, through
the program's tile decoder, to the pixels the writer says it encoded, in
both PNG forms and every row filter; the tile range is the program's; the
textured roofline counts PERF.md's kernel-table bytes; the reference and
the writer import nothing of the program; and a run whose atlas or hybrid
near field is broken underneath comes out not correct, at tiny sizes on
the CPU and, on a card, at the cell's own."""

import copy
import json
import subprocess
import sys
import zlib

import numpy as np
import pytest

from portbench import harness, roofline_tex, tiles

MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def _faults(cell):
    return harness.load_module(
        harness.resolve(cell, MAN)["driver"]).planted_faults()


def _rows(png: bytes):
    """(colour type, each row's filter type) of a PNG of one IDAT."""
    ctype = png[25]
    at = png.index(b"IDAT")
    n = int.from_bytes(png[at - 4:at], "big")
    raw = np.frombuffer(zlib.decompress(png[at + 4:at + 4 + n]), np.uint8)
    stride = 256 * (1 if ctype == 3 else 3)
    return ctype, raw.reshape(256, 1 + stride)[:, 0]


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 11])
def test_tiles_decode_as_written(seed, tmp_path):
    from horizonator_tpu_torch.tiles import _decode_tile_bgr
    rng_xy = (700, 1630, 703, 1632)
    cache = tiles.write_cache(seed, tmp_path, "mapnik", 12, rng_xy)
    assert sorted(cache.pixels) == [(x, y) for x in range(700, 704)
                                    for y in range(1630, 1633)]
    forms = set()
    for (x, y), px in cache.pixels.items():
        path = tiles.tile_path(tmp_path, "mapnik", 12, x, y)
        ctype, filters = _rows(path.read_bytes())
        forms.add(ctype)
        assert ctype == (3 if (x + y) % 2 else 2)
        assert set(filters.tolist()) == {0, 1, 2, 3, 4}
        assert 15_000 < path.stat().st_size < 60_000
        assert np.array_equal(_decode_tile_bgr(path)[:, :, ::-1], px)
    assert forms == {2, 3}
    again = tiles.write_cache(seed, tmp_path / "b", "mapnik", 12, rng_xy)
    assert all(np.array_equal(again.pixels[k], v)
               for k, v in cache.pixels.items())
    other = tiles.write_cache(seed + 1, tmp_path / "c", "mapnik", 12, rng_xy)
    assert not np.array_equal(other.pixels[(700, 1630)],
                              cache.pixels[(700, 1630)])


def test_tiles_join(tmp_path):
    """Regions and roads run on across tile edges: neighbouring edge
    columns share their colour (less a textured region's shades) far more
    often than two unrelated columns do."""
    cache = tiles.write_cache(3, tmp_path, "mapnik", 12, (700, 1630, 701,
                                                          1630))
    a, b = cache.pixels[(700, 1630)], cache.pixels[(701, 1630)]
    near = (np.abs(a[:, -1].astype(int) - b[:, 0]).max(-1) <= 9).mean()
    far = (np.abs(a[:, 0].astype(int) - b[:, -1]).max(-1) <= 9).mean()
    assert near > 0.7 and far < 0.3


def test_tile_range_is_the_programs():
    from horizonator_tpu_torch.render.texture import tile_xy_from_latlon
    for lat, lon in [(34.2884, -117.7134), (-33.9, 151.2), (60.1, 10.7)]:
        assert tiles.tile_xy(lat, lon, 12) == tile_xy_from_latlon(lat, lon,
                                                                  12)
    x_lo, y_lo, x_hi, y_hi = tiles.tile_range(34.2884, -117.7134, 1000,
                                              1200, 12)
    assert (x_hi - x_lo + 1) * (y_hi - y_lo + 1) == 480


def test_textured_bench_shape_bytes():
    """At the bench shape of PERF.md's kernel table: a textured march of
    27.51 MB, the untextured march's 12.40 MB + two half-cell texels of
    each of its 708,651 cells + (4096, 576) int32 colours, and a textured
    resolve of 73.53 MB, the table's."""
    kw = dict(width=4096, zfar_m=40000.0, cpd=1200, lat_deg=34.3)
    march, _ = roofline_tex.march_work(3400, [1700.0], [1700.0], **kw)
    assert march == pytest.approx(12.40e6 + 8 * 708_651 + 4 * 4096 * 576,
                                  abs=5e3)
    assert march == pytest.approx(27.51e6, abs=5e3)
    resolve, _ = roofline_tex.resolve_work(3400, 1, height=1024, **kw)
    assert resolve == pytest.approx(73.53e6, abs=5e3)


def test_imports_nothing_of_the_program():
    code = ("import sys; import portbench.reference.render_tex, "
            "portbench.tiles, portbench.roofline_tex; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO,
                       capture_output=True, text=True, check=True)
    top = set(json.loads(r.stdout.replace("'", '"')))
    assert not top & {"jax", "jaxlib", "flax", "horizonator_tpu",
                      "horizonator_tpu_torch"}


@pytest.mark.parametrize("fault", ["atlas_shift", "hybrid_off"])
@pytest.mark.parametrize(
    "cell", [c for c in CELLS if "hybrid_off" in _faults(c)])
def test_texture_faults(cell, fault, tiny, monkeypatch):
    plant = _faults(cell)[fault]
    out, _ = harness.run_cell(
        cell, 23, 0.2, False, device="cpu", files=tiny(cell),
        setup_hook=lambda ctx, state: plant(monkeypatch))
    assert not out["correct"], out["check"]


@pytest.mark.card
@pytest.mark.parametrize("fault", [None, "atlas_shift", "hybrid_off"])
@pytest.mark.parametrize(
    "cell", [c for c in CELLS if "hybrid_off" in _faults(c)])
def test_texture_faults_at_size(cell, fault, card, monkeypatch):
    """The cell's own window, atlas and image, its checked requests: the
    sound program agrees to the bit, and each texture fault, which only
    the pixels within ``exact_near_m`` show, reads past the limit."""
    f = copy.deepcopy(harness.resolve(cell, MAN))
    f["mix"].update(warm_requests=2, warm_seconds=0.0)
    hook = None
    if fault is not None:
        plant = _faults(cell)[fault]
        hook = lambda ctx, state: plant(monkeypatch)     # noqa: E731
    out, _ = harness.run_cell(cell, 2 ** 31 + 77, 1.0, False, device=card,
                              files=f, setup_hook=hook)
    v = out["check"]["px_off_pct"]
    print(f"{cell} {fault}: px_off_pct {v['value']!r} (limit "
          f"{v['limit']!r}) on {harness.power_limit()}")
    assert out["correct"] == (fault is None), out["check"]
