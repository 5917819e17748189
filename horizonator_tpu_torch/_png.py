"""PNG with the standard library: how the port writes the PNGs that the JAX
package writes through PIL, and decodes the map tiles that it decodes
through PIL, on machines that have no PIL.

``encode_png``: one 8-bit RGB image, filter 0 on every row, ``zlib`` at
level 6 (PIL's default). The bytes need not equal PIL's; the decoded pixels
do.

``decode_png``: any PNG of the standard's colour types and depths,
interlaced or not, to the pixels that ``PIL.Image.open(f).convert("RGB")``
gives: alpha and transparency dropped, 16-bit samples cut to their high
byte (16-bit grey clamped at 255, as PIL's "I;16" conversion does), sub-byte
grey scaled to 0..255, palette indices past the palette black. The row
filters are undone by the native library (``_native``, g++) when it builds,
else by ``unfilter_plain``, which gives the same bits.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import _native

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}                        # colour type -> bit depths
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(rgb: np.ndarray) -> bytes:
    """uint8 (H, W, 3) RGB -> the bytes of a PNG file."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png wants uint8 (H, W, 3), got "
                         f"{rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)     # filter byte 0 a row
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)   # 8-bit RGB
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def unfilter_plain(buf: np.ndarray, rows: int, stride: int, bpp: int) -> int:
    """The plain version of ``_native.png_unfilter``, bit for bit: undo the
    row filters of ``buf`` (rows * (1 + stride) uint8, each row's filter
    type first) in place. Returns 0, or 1 + the first row whose filter type
    is not 0-4. None (0), Sub (1) and Up (2) are numpy; Average (3) and
    Paeth (4) are a byte-serial Python loop."""
    a = buf.reshape(rows, 1 + stride)
    zeros = [0] * stride
    for r in range(rows):
        f, cur = int(a[r, 0]), a[r, 1:]
        if f == 0:
            continue
        if f == 1:          # a wrapping running sum along each byte lane
            cur[:] = np.cumsum(cur.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif f == 2:
            if r:
                cur += a[r - 1, 1:]
        elif f in (3, 4):
            c = cur.tolist()
            p = a[r - 1, 1:].tolist() if r else zeros
            for i in range(stride):
                left = c[i - bpp] if i >= bpp else 0
                if f == 3:
                    c[i] = (c[i] + ((left + p[i]) >> 1)) & 255
                    continue
                up, ul = p[i], (p[i - bpp] if i >= bpp else 0)
                est = left + up - ul
                pa, pb, pc = abs(est - left), abs(est - up), abs(est - ul)
                pred = left if pa <= pb and pa <= pc else (
                    up if pb <= pc else ul)
                c[i] = (c[i] + pred) & 255
            cur[:] = c
        else:
            return r + 1
    return 0


def _ihdr(body: bytes):
    if len(body) != 13:
        raise ValueError(f"bad PNG: IHDR of {len(body)} bytes, want 13")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              body)
    if not (0 < w < 2 ** 31 and 0 < h < 2 ** 31):
        raise ValueError(f"bad PNG: IHDR size {w}x{h}")
    if depth not in _DEPTHS.get(ctype, ()):
        raise ValueError(f"bad PNG: IHDR colour type {ctype} at bit depth "
                         f"{depth}")
    if comp != 0 or filt != 0 or interlace not in (0, 1):
        raise ValueError(f"bad PNG: IHDR compression {comp}, filter "
                         f"method {filt}, interlace {interlace}")
    return w, h, depth, ctype, interlace


def _samples(rows: np.ndarray, width: int, depth: int, ch: int):
    """The unfiltered rows' samples: (rows, width, ch) integers."""
    if depth == 16:
        s = (rows[:, 0::2].astype(np.uint16) << 8) | rows[:, 1::2]
    elif depth == 8:
        s = rows
    else:                                     # packed from the high bits
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        s = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(
            rows.shape[0], -1)[:, :width * ch]
    return s.reshape(rows.shape[0], width, ch)


def _to_rgb(s: np.ndarray, depth: int, ctype: int,
            palette: np.ndarray) -> np.ndarray:
    if ctype == 3:
        return palette[s[:, :, 0]]
    if ctype == 0 and depth < 8:
        v = s * (255 // ((1 << depth) - 1))
    elif ctype == 0 and depth == 16:
        v = np.minimum(s, 255)
    elif depth == 16:
        v = s >> 8
    else:
        v = s
    v = v[:, :, :1] if ctype in (0, 4) else v[:, :, :3]
    return np.broadcast_to(v, v.shape[:2] + (3,)).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """The bytes of a PNG file -> uint8 (H, W, 3) RGB, the pixels of
    ``PIL.Image.open(f).convert("RGB")``. A bad signature, chunk CRC or
    IHDR, a missing IEND, a bad filter type, or image data that ends short
    raise ValueError: no partial image is returned."""
    data = memoryview(data).cast("B")
    if bytes(data[:8]) != _SIGNATURE:
        raise ValueError("not a PNG: bad signature")
    pos, hdr, plte, idat = 8, None, b"", []
    while True:
        if pos + 12 > len(data):
            raise ValueError("truncated PNG: no IEND chunk")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + n
        if end > len(data):
            raise ValueError(f"truncated PNG: the {kind!r} chunk runs past "
                             f"the end")
        body = bytes(data[pos + 8:end - 4])
        if struct.unpack(">I", data[end - 4:end])[0] != zlib.crc32(
                kind + body):
            raise ValueError(f"bad PNG: CRC of the {kind!r} chunk")
        if (kind == b"IHDR") != (hdr is None):
            raise ValueError(f"bad PNG: {kind!r} where IHDR must be first "
                             f"and once")
        if kind == b"IHDR":
            hdr = _ihdr(body)
        elif kind == b"PLTE":
            if len(body) % 3 or len(body) > 768:
                raise ValueError(f"bad PNG: PLTE of {len(body)} bytes")
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        # tRNS and every other chunk: nothing that convert("RGB") keeps
        pos = end
    w, h, depth, ctype, interlace = hdr
    ch = _CHANNELS[ctype]
    bits = depth * ch                         # a pixel's bits
    bpp = max(1, bits // 8)
    passes = []                               # (x0, y0, dx, dy, pw, ph)
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:
            passes.append((x0, y0, dx, dy, pw, ph))
    need = sum(ph * (1 + (pw * bits + 7) // 8)
               for *_, pw, ph in passes)
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat), need)
    except zlib.error as e:
        raise ValueError(f"bad PNG: image data does not inflate ({e})") \
            from None
    if len(raw) < need:
        raise ValueError(f"truncated PNG: {len(raw)} bytes of image data, "
                         f"want {need}")
    raw = np.frombuffer(raw, np.uint8).copy()
    palette = np.zeros((256, 3), np.uint8)    # indices past PLTE: black
    palette[:len(plte) // 3] = np.frombuffer(plte, np.uint8).reshape(-1, 3)
    unfilter = (_native.png_unfilter if _native.get_lib() is not None
                else unfilter_plain)
    out = np.empty((h, w, 3), np.uint8)
    off = 0
    for x0, y0, dx, dy, pw, ph in passes:
        stride = (pw * bits + 7) // 8
        buf = raw[off:off + ph * (1 + stride)]
        off += buf.size
        bad = unfilter(buf, ph, stride, bpp)
        if bad:
            raise ValueError(f"bad PNG: filter type "
                             f"{buf[(bad - 1) * (1 + stride)]} on row "
                             f"{bad - 1}")
        rows = buf.reshape(ph, 1 + stride)[:, 1:]
        out[y0::dy, x0::dx] = _to_rgb(_samples(rows, pw, depth, ch), depth,
                                      ctype, palette)
    return out
