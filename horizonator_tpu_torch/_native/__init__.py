"""ctypes bindings for the native DEM loader, with build-on-first-use.

The shared library is compiled from hgt_native.cpp with g++ on the first
``get_lib()`` call (never at import) into ``horizonator_tpu_torch/_build/``,
and rebuilt when the source is newer. Without a compiler the package works
anyway: mosaic loading falls back to the numpy path, which gives the same
bits. Set HORIZONATOR_TPU_NO_NATIVE=1 to force the fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

_SRC = Path(__file__).parent / "hgt_native.cpp"
_LIB = Path(__file__).parent.parent / "_build" / "libhgt_native.so"

_lib = None
_tried = False


def _msg(fmt, *args):
    print("horizonator_tpu_torch:", fmt % args if args else fmt,
          file=sys.stderr)


def _build() -> bool:
    # compile to a per-process temp name and publish atomically: two
    # processes building concurrently (pytest -n, a CLI beside the viewer)
    # must never dlopen a half-written .so, and a crashed build must not
    # poison the cache
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_name(f".{_LIB.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        _msg("native build unavailable (%s); using the numpy loader", e)
        tmp.unlink(missing_ok=True)
        return False
    if r.returncode != 0:
        _msg("native build failed:\n%s", r.stderr)
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, _LIB)
    return True


def get_lib():
    """The loaded native library, or None when unavailable/disabled."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("HORIZONATOR_TPU_NO_NATIVE"):
        return None
    try:
        if (not _LIB.exists()
                or _LIB.stat().st_mtime < _SRC.stat().st_mtime):
            if not _build():
                return None
        lib = ctypes.CDLL(str(_LIB))
        lib.hgt_blit_window.restype = ctypes.c_int
        lib.hgt_blit_window.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_long, ctypes.c_long]
        lib.hgt_decode.restype = ctypes.c_int
        lib.hgt_decode.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_void_p]
        _lib = lib
    except OSError as e:
        _msg("native lib load failed: %s", e)
        _lib = None
    return _lib


def blit_window(path, edge, grid, dst_i0, dst_j0) -> int:
    """Blit one tile into the mosaic window (see hgt_native.cpp). grid must
    be a C-contiguous int16 (n, n) ndarray. Returns the native status code:
    0 done, 1 zero-size file, 2 size mismatch, 3 I/O error, 4 open failure.
    Raises if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    import numpy as np
    if grid.dtype != np.int16 or not grid.flags.c_contiguous \
            or grid.ndim != 2 or grid.shape[0] != grid.shape[1]:
        raise ValueError("grid must be a C-contiguous square int16 array")
    n = grid.shape[0]
    return lib.hgt_blit_window(
        str(path).encode(), edge,
        grid.ctypes.data_as(ctypes.c_void_p), n,
        int(dst_i0), int(dst_j0))
