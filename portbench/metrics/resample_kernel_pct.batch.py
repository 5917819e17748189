"""resample_kernel_pct.batch: the share of the viewshed resampler's calls
(``hz.viewshed.resample`` spans) that went through its CUDA kernels
(counter ``hz.kernels.resample``), in %, from the program's own recorder.
None where nothing resampled; 0 where no call took the kernels."""

from portbench.recorder import snapshot


def read(t):
    s = snapshot()
    n = s and s["spans"].get("hz.viewshed.resample", (0,))[0]
    if not n:
        return None
    return 100.0 * s["counters"].get("hz.kernels.resample", (0, 0))[0] / n
