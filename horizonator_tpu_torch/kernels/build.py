"""Build and load the package's CUDA kernels (nvcc by hand + ctypes).

All ``csrc/*.cu`` files compile into ONE shared library with a plain C
interface, on first use, into ``horizonator_tpu_torch/_build/``: one nvcc
per source, all started together, then one link. The file name carries a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the library already built. The build writes temporary
files and renames the library into place, so a crashed or concurrent build
never leaves a half-written library behind.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).parent / "csrc"
_BUILD = Path(__file__).parent.parent / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v"]


class Scalars(ctypes.Structure):
    """The near band's per-viewpoint scalars (csrc/near_band.cu): a
    pointer to each and its stride in elements between viewpoints (0: one
    value for the batch)."""
    _fields_ = [("ptr", ctypes.c_void_p * 8), ("stride", ctypes.c_longlong * 8)]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD / f"libhz_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the library if it is not built yet. Returns (path, seconds
    spent compiling, compiler output); 0 s and '' when it was built."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [_BUILD / f".{tag}.{src.stem}.o" for src in sources()]
    tmp = out.with_name(f".{tag}.so.tmp")
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [lg for p, lg in zip(procs, logs) if p.returncode]
        if not failed:
            r = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                                *map(str, objs)], capture_output=True,
                               text=True)
            logs.append(r.stdout + r.stderr)
            if r.returncode:
                failed.append(logs[-1])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return out, time.perf_counter() - t0, "".join(logs)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    cll = ctypes.c_longlong
    lib.hz_window_march.argtypes = [vp, ci, cll, vp, vp, ci, ci, ci, vp, cll,
                                    vp]
    lib.hz_window_march.restype = ci
    lib.hz_window_march_tex.argtypes = [vp, ci, cll, vp, ci, cll, vp, vp, ci,
                                        ci, ci, vp, vp, cll, vp]
    lib.hz_window_march_tex.restype = ci
    lib.hz_window_march_band.argtypes = [vp, ci, ci, ci, cf, cll, vp, vp, ci,
                                         ci, ci, vp, cll, vp]
    lib.hz_window_march_band.restype = ci
    lib.hz_window_march_band_tex.argtypes = [vp, ci, ci, ci, cf, cll, vp, ci,
                                             cll, vp, vp, ci, ci, ci, vp, vp,
                                             cll, vp]
    lib.hz_window_march_band_tex.restype = ci
    lib.hz_resolve.argtypes = [vp, ci, ci, ci, cf, cf, ci, vp, vp, vp, vp]
    lib.hz_resolve.restype = ci
    lib.hz_resolve_tex.argtypes = [vp, vp, ci, ci, ci, cf, cf, ci, vp, vp,
                                   vp, vp, vp]
    lib.hz_resolve_tex.restype = ci
    for name in ("hz_roll_minmax", "hz_roll_minmax_smem"):
        getattr(lib, name).argtypes = [vp, vp, ci, ci, ci, vp]
        getattr(lib, name).restype = ci
    for name in ("hz_roll_kv", "hz_roll_kv_smem"):
        getattr(lib, name).argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
        getattr(lib, name).restype = ci
    lib.hz_roll_regs.argtypes = [ci]
    lib.hz_roll_regs.restype = ci
    lib.hz_viewshed_columns.argtypes = [vp, vp, ci, ci, ci, ci, ci, vp, vp,
                                        vp]
    lib.hz_viewshed_columns.restype = ci
    lib.hz_viewshed_cells.argtypes = [vp, ci, ci, vp, vp, vp, vp, ci, ci, ci,
                                      ci, ci, cf, ci, cf, cf, cf, ci, ci, vp,
                                      vp, vp, vp]
    lib.hz_viewshed_cells.restype = ci
    lib.hz_near_band.argtypes = [vp, ci, ci, cll, ci, ci, ci, cf, ci, vp, vp,
                                 vp, Scalars, ci, ci, ci, cf, vp, cll, vp, vp,
                                 vp, vp, vp, vp]
    lib.hz_near_band.restype = ci
    return lib

