"""The port's PNG decoder (``_png.decode_png``) against PIL's
``Image.open(f).convert("RGB")``, which the JAX package's tile decoder
runs: bitwise, for every colour type and bit depth, at 37 x 5 (rows whose
bits end inside a byte) and 256 x 256 (a map tile).

Files come two ways: PIL writes each form it can write (its own filter
choice), and ``write_png`` below writes every form, plain or Adam7, with
row filters cycling 0-4, three IDAT chunks, ancillary chunks, tRNS, and
palette indices past the palette. The native row unfilter (g++) is held
bitwise to the plain one; each malformed file raises ValueError.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from horizonator_tpu_torch import _native, _png

FORMS = [(ctype, depth) for ctype, depths in sorted(_png._DEPTHS.items())
         for depth in depths]
SIZES = [(37, 5), (256, 256)]


def chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _filter_rows(rows, bpp):
    """Rows (uint8 arrays) -> the filtered stream, row r taking filter
    r % 5."""
    out, prev = [], np.zeros_like(rows[0], np.int32)
    for r, row in enumerate(rows):
        cur = row.astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur])[:cur.size]
        ul = np.concatenate([np.zeros(bpp, np.int32), prev])[:cur.size]
        f = r % 5
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            est = left + prev - ul
            pa, pb, pc = abs(est - left), abs(est - prev), abs(est - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        out.append(bytes([f]) + ((cur - pred) & 255).astype(np.uint8)
                   .tobytes())
        prev = cur
    return b"".join(out)


def _pack_row(samples, depth):
    if depth == 16:
        return np.asarray(samples, ">u2").view(np.uint8)
    if depth == 8:
        return np.asarray(samples, np.uint8)
    per = 8 // depth
    s = np.zeros(-(-len(samples) // per) * per, np.int64)
    s[:len(samples)] = samples
    s = s.reshape(-1, per) << (depth * np.arange(per - 1, -1, -1))
    return s.sum(1).astype(np.uint8)


def write_png(img, ctype, depth, interlace=0, palette=None, trns=False):
    """``img`` (h, w, channels) samples -> PNG bytes, rows filtered 0-4 in
    turn, the stream split over three IDAT chunks."""
    h, w, ch = img.shape
    bpp = max(1, depth * ch // 8)
    passes = _png._ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = img[y0::dy, x0::dx]
        if sub.size:
            raw += _filter_rows([_pack_row(r.reshape(-1), depth)
                                 for r in sub], bpp)
    z = zlib.compress(raw, 9)
    k = len(z) // 3
    s = (_png._SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
        + chunk(b"tEXt", b"Comment\x00seeded") + chunk(b"gAMA",
                                                      b"\x00\x00\xb1\x8f"))
    if palette is not None:
        s += chunk(b"PLTE", palette.tobytes())
    if trns:
        s += chunk(b"tRNS", {0: b"\x00\x01", 2: b"\x00\x01" * 3,
                             3: b"\x00\x80\xff"}[ctype])
    s += b"".join(chunk(b"IDAT", z[i:j]) for i, j in
                  ((0, k), (k, 2 * k), (2 * k, len(z))))
    return s + chunk(b"prIv", b"private") + chunk(b"IEND", b"")


def seeded_form(ctype, depth, w, h, seed=0):
    """Samples of one form from a seed: palette images index past their
    palette (5 entries below depth 8, 200 at 8)."""
    rng = np.random.default_rng(seed + 17 * ctype + depth)
    ch = _png._CHANNELS[ctype]
    img = rng.integers(0, 1 << depth, (h, w, ch))
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (5 if depth < 8 else 200, 3)).astype(
            np.uint8)
    return img, palette


def pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.fixture
def plain_unfilter(monkeypatch):
    """The decoder on its plain unfilter, as on a machine without g++."""
    monkeypatch.setattr(_native, "get_lib", lambda: None)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("form", FORMS, ids=lambda f: f"type{f[0]}-{f[1]}")
def test_decode_equals_pil(form, interlace, size):
    (ctype, depth), (w, h) = form, size
    img, palette = seeded_form(ctype, depth, w, h)
    data = write_png(img, ctype, depth, interlace, palette,
                     trns=ctype in (0, 2, 3))
    want = pil_rgb(data)
    got = _png.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("form", FORMS, ids=lambda f: f"type{f[0]}-{f[1]}")
def test_decode_plain_unfilter_equals_pil(form, interlace, plain_unfilter):
    ctype, depth = form
    img, palette = seeded_form(ctype, depth, 37, 5, seed=1)
    data = write_png(img, ctype, depth, interlace, palette)
    np.testing.assert_array_equal(_png.decode_png(data), pil_rgb(data))


def _pil_written(mode, w, h, seed):
    rng = np.random.default_rng(seed)
    kw = {}
    if mode == "P":
        im = Image.frombytes("P", (w, h), rng.integers(
            0, 256, (h, w)).astype(np.uint8).tobytes())
        im.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tobytes())
    elif mode.startswith("P;"):             # a sub-byte palette file
        bits = int(mode[2:])
        im = Image.frombytes("P", (w, h), rng.integers(
            0, 1 << bits, (h, w)).astype(np.uint8).tobytes())
        im.putpalette(rng.integers(0, 256, 3 << bits).astype(np.uint8)
                      .tobytes())
        kw["bits"] = bits
    elif mode == "1":
        im = Image.fromarray(rng.integers(0, 2, (h, w)).astype(bool))
    elif mode == "I;16":
        im = Image.frombytes("I;16", (w, h), rng.integers(
            0, 600, (h, w)).astype("<u2").tobytes())
    else:
        ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        a = rng.integers(0, 256, (h, w, ch)).astype(np.uint8)
        im = Image.fromarray(a[:, :, 0] if ch == 1 else a)
        assert im.mode == mode
    buf = io.BytesIO()
    im.save(buf, format="PNG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["1", "L", "LA", "RGB", "RGBA", "P", "P;1",
                                  "P;2", "P;4", "I;16"])
def test_pil_written_equals_pil(mode, size):
    data = _pil_written(mode, *size, seed=len(mode))
    np.testing.assert_array_equal(_png.decode_png(data), pil_rgb(data))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_native_unfilter_equals_plain(bpp):
    if _native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(bpp)
    rows, stride = 41, 7 * bpp * 5
    buf = rng.integers(0, 256, rows * (1 + stride)).astype(np.uint8)
    buf[::1 + stride] = rng.permutation(np.arange(rows) % 5)
    native, plain = buf.copy(), buf.copy()
    assert _native.png_unfilter(native, rows, stride, bpp) == 0
    assert _png.unfilter_plain(plain, rows, stride, bpp) == 0
    np.testing.assert_array_equal(native, plain)
    assert not np.array_equal(native, buf)
    # a bad filter type: 1 + its row, from both
    bad_n, bad_p = buf.copy(), buf.copy()
    bad_n[9 * (1 + stride)] = bad_p[9 * (1 + stride)] = 5
    assert _native.png_unfilter(bad_n, rows, stride, bpp) == 10
    assert _png.unfilter_plain(bad_p, rows, stride, bpp) == 10
    with pytest.raises(ValueError):
        _native.png_unfilter(buf[:-1], rows, stride, bpp)


@pytest.mark.parametrize("shape", [(5, 37), (256, 256), (1, 1)])
def test_round_trip(shape):
    x = np.random.default_rng(2).integers(0, 256, shape + (3,)).astype(
        np.uint8)
    np.testing.assert_array_equal(_png.decode_png(_png.encode_png(x)), x)


def _rgb_file():
    img, _ = seeded_form(2, 8, 37, 5)
    return write_png(img, 2, 8)


def _resigned(data, at, body):
    """``data`` with the chunk at offset ``at`` replaced by ``body``'s
    (kind + data) under a fresh CRC."""
    n = struct.unpack(">I", data[at:at + 4])[0]
    return data[:at] + chunk(body[:4], body[4:]) + data[at + 12 + n:]


def _refusals():
    good = _rgb_file()
    ihdr = good[12:29]                         # kind + 13 bytes
    idat_at = good.index(b"IDAT") - 4
    flipped = bytearray(good)
    flipped[idat_at + 10] ^= 1                 # IDAT data, CRC unchanged
    short_z = zlib.compress(b"\x00" * 10)
    bad_filter = zlib.compress(b"\x07" + b"\x00" * 111 + b"\x00" * 448)
    return {
        "signature": (b"\x89PNG\r\n\x1a\x0b" + good[8:], "signature"),
        "crc": (bytes(flipped), "CRC"),
        "ihdr length": (_resigned(good, 8, ihdr[:-1]), "IHDR"),
        "ihdr depth": (_resigned(good, 8, ihdr[:12] + b"\x03" + ihdr[13:]),
                       "bit depth"),
        "ihdr colour type": (_resigned(good, 8, ihdr[:13] + b"\x05"
                                       + ihdr[14:]), "colour type"),
        "ihdr interlace": (_resigned(good, 8, ihdr[:-1] + b"\x02"),
                           "interlace"),
        "ihdr zero width": (_resigned(good, 8, b"IHDR\0\0\0\0"
                                      + ihdr[8:]), "size"),
        "ihdr not first": (good[:8] + chunk(b"gAMA", b"\0\0\0\1")
                           + good[8:], "IHDR"),
        "cut mid-chunk": (good[:idat_at + 20], "truncated"),
        "no IEND": (good[:-12], "IEND"),
        "short image data": (_resigned(good, idat_at, b"IDAT" + short_z),
                             "truncated"),
        "not zlib": (_resigned(good, idat_at, b"IDAT" + b"\x00" * 9),
                     "inflate"),
        "filter type": (_resigned(good, idat_at, b"IDAT" + bad_filter),
                        "filter type 7"),
        "plte length": (_png._SIGNATURE + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 1, 1, 8, 3, 0, 0, 0)) + chunk(b"PLTE", b"\0" * 7)
            + chunk(b"IDAT", zlib.compress(b"\0\0")) + chunk(b"IEND", b""),
            "PLTE"),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_refusals(case):
    data, match = _refusals()[case]
    with pytest.raises(ValueError, match=match):
        _png.decode_png(data)
