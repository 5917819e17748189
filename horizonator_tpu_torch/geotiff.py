"""Minimal dependency-free GeoTIFF writer for the GIS rasters.

Host copy of horizonator_tpu.geotiff (numpy and struct only; the port
imports nothing of the JAX package): a single-IFD little-endian TIFF with
the three GeoTIFF tags QGIS/GDAL need to place a WGS84 (EPSG:4326)
geographic raster (ModelPixelScale + ModelTiepoint + GeoKeyDirectory,
GeoTIFF spec section 2.6). Uncompressed, one strip per image; uint8/int16/
uint16/float32 arrays. Its files are byte for byte the JAX package's.
"""

from __future__ import annotations

import os
import struct

import numpy as np

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259           # 1 = none
_PHOTOMETRIC = 262           # 1 = BlackIsZero
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_SAMPLE_FORMAT = 339         # 1 = unsigned, 2 = signed, 3 = float
_MODEL_PIXEL_SCALE = 33550
_MODEL_TIEPOINT = 33922
_GEO_KEY_DIRECTORY = 34735
_GDAL_NODATA = 42113

# TIFF field types
_T_SHORT, _T_LONG, _T_DOUBLE, _T_ASCII = 3, 4, 12, 2

_FORMATS = {
    np.dtype(np.uint8): (8, 1),
    np.dtype(np.uint16): (16, 1),
    np.dtype(np.int16): (16, 2),
    np.dtype(np.float32): (32, 3),
}


def write_geotiff(path, array, *, bounds, row0="south", nodata=None):
    """Write a single-band WGS84 geographic GeoTIFF.

    array: (H, W) uint8/uint16/int16/float32 (bool is widened to uint8).
    bounds: (lat_s, lon_w, lat_n, lon_e) of the OUTER pixel edges, e.g.
    cell_bounds() of a mosaic, or any explicit extent. row0: 'south' (the
    grids' convention) or 'north'; the file is always written north-up, so
    'south' input is flipped.
    """
    a = np.asarray(array)
    if a.dtype == bool:
        a = a.astype(np.uint8)
    if a.ndim != 2:
        raise ValueError(f"expected a 2D single-band raster, got {a.shape}")
    if a.dtype not in _FORMATS:
        raise ValueError(f"unsupported dtype {a.dtype}: use uint8/uint16/"
                         "int16/float32 (or bool)")
    if row0 == "south":
        a = a[::-1]
    elif row0 != "north":
        raise ValueError("row0 must be 'south' or 'north'")
    a = np.ascontiguousarray(a)
    if a.dtype.itemsize > 1:
        a = a.astype(a.dtype.newbyteorder("<"))
    h, w = a.shape
    bits, fmt = _FORMATS[np.dtype(a.dtype.newbyteorder("="))]

    lat_s, lon_w, lat_n, lon_e = (float(v) for v in bounds)
    sx = (lon_e - lon_w) / w
    sy = (lat_n - lat_s) / h
    if sx <= 0 or sy <= 0:
        raise ValueError(f"degenerate bounds {bounds}")

    # GeoKeys: geographic model, PixelIsArea, EPSG:4326
    geokeys = [1, 1, 0, 3,           # version 1.1.0, 3 keys follow
               1024, 0, 1, 2,        # GTModelTypeGeoKey = geographic
               1025, 0, 1, 1,        # GTRasterTypeGeoKey = PixelIsArea
               2048, 0, 1, 4326]     # GeographicTypeGeoKey = WGS84

    entries = []   # (tag, type, count, packed-value-or-payload-bytes)

    def entry(tag, typ, values):
        size = {_T_SHORT: 2, _T_LONG: 4, _T_DOUBLE: 8, _T_ASCII: 1}[typ]
        pat = {_T_SHORT: "H", _T_LONG: "I", _T_DOUBLE: "d"}.get(typ)
        if typ == _T_ASCII:
            payload = values  # bytes incl. trailing NUL
            count = len(payload)
        else:
            count = len(values)
            payload = struct.pack(f"<{count}{pat}", *values)
        entries.append([tag, typ, count, payload, size * count <= 4])

    entry(_IMAGE_WIDTH, _T_LONG, [w])
    entry(_IMAGE_LENGTH, _T_LONG, [h])
    entry(_BITS_PER_SAMPLE, _T_SHORT, [bits])
    entry(_COMPRESSION, _T_SHORT, [1])
    entry(_PHOTOMETRIC, _T_SHORT, [1])
    entry(_STRIP_OFFSETS, _T_LONG, [0])          # patched below
    entry(_SAMPLES_PER_PIXEL, _T_SHORT, [1])
    entry(_ROWS_PER_STRIP, _T_LONG, [h])
    entry(_STRIP_BYTE_COUNTS, _T_LONG, [a.nbytes])
    entry(_SAMPLE_FORMAT, _T_SHORT, [fmt])
    entry(_MODEL_PIXEL_SCALE, _T_DOUBLE, [sx, sy, 0.0])
    # tiepoint: raster (0,0, 0) -> model (lon_w, lat_n, 0): the NW corner
    entry(_MODEL_TIEPOINT, _T_DOUBLE, [0.0, 0.0, 0.0, lon_w, lat_n, 0.0])
    entry(_GEO_KEY_DIRECTORY, _T_SHORT, geokeys)
    if nodata is not None:
        s = (f"{nodata}").encode() + b"\x00"
        entry(_GDAL_NODATA, _T_ASCII, s)
    entries.sort(key=lambda e: e[0])

    # layout: header(8) | IFD | out-of-line payloads | pixel data
    ifd_off = 8
    ifd_size = 2 + 12 * len(entries) + 4
    payload_off = ifd_off + ifd_size
    blobs = []
    for e in entries:
        if not e[4]:
            if payload_off % 2:                  # word-align payloads
                blobs.append(b"\x00")
                payload_off += 1
            e.append(payload_off)                # offset of this payload
            blobs.append(e[3])
            payload_off += len(e[3])
        else:
            e.append(None)
    data_off = payload_off + (payload_off % 2)
    for e in entries:
        if e[0] == _STRIP_OFFSETS:
            e[3] = struct.pack("<I", data_off)

    out = [struct.pack("<2sHI", b"II", 42, ifd_off),
           struct.pack("<H", len(entries))]
    for tag, typ, count, payload, inline, off in entries:
        if inline:
            out.append(struct.pack("<HHI", tag, typ, count)
                       + payload.ljust(4, b"\x00"))
        else:
            out.append(struct.pack("<HHII", tag, typ, count, off))
    out.append(struct.pack("<I", 0))             # no next IFD
    out.extend(blobs)
    if payload_off % 2:
        out.append(b"\x00")
    out.append(a.tobytes())

    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(b"".join(out))
    os.replace(tmp, path)                        # atomic


def cell_bounds(mosaic, lo=None, hi=None):
    """Outer-edge (lat_s, lon_w, lat_n, lon_e) of a cell-index window of a
    dem.mosaic.DemMosaic: the ``bounds=`` argument for write_geotiff.

    lo/hi: inclusive (i, j) cell corners of the sub-window (default the
    whole grid). Cell centers sit half a cell inside the returned edges
    (GeoTIFF PixelIsArea semantics)."""
    cpd = mosaic.cells_per_deg
    n = mosaic.grid.shape[0]
    i0, j0 = (0, 0) if lo is None else (int(lo[0]), int(lo[1]))
    i1, j1 = (n - 1, n - 1) if hi is None else (int(hi[0]), int(hi[1]))
    lon0 = (mosaic.origin_dem_lon_lat[0]
            + (mosaic.origin_dem_cellij[0] + i0 - 0.5) / cpd)
    lat0 = (mosaic.origin_dem_lon_lat[1]
            + (mosaic.origin_dem_cellij[1] + j0 - 0.5) / cpd)
    return (lat0, lon0,
            lat0 + (j1 - j0 + 1) / cpd, lon0 + (i1 - i0 + 1) / cpd)
