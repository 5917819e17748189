"""Build and load the package's CUDA kernels (nvcc by hand + ctypes).

All ``csrc/*.cu`` files compile into ONE shared library with a plain C
interface, on first use, into ``horizonator_tpu_torch/_build/``. The file
name carries a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads the library already built. The compile writes a
temporary file and renames it into place, so a crashed or concurrent build
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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


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
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, out)
    return out, secs, r.stdout + r.stderr


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hz_window_march.argtypes = [vp, ci, vp, vp, ci, ci, vp, vp]
    lib.hz_window_march.restype = ci
    lib.hz_resolve.argtypes = [vp, ci, ci, ci, cf, cf, ci, vp, vp, vp, vp]
    lib.hz_resolve.restype = ci
    return lib

