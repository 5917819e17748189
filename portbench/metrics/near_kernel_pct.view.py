"""near_kernel_pct.view: the share of the renders' near bands
(``hz.render.near_band`` spans) that went through the near band's CUDA
kernel (counter ``hz.kernels.near_band``), in %, from the program's own
recorder. None where nothing ran the near band or the program has no
such counter (an older program, whose near band is torch passes)."""

from portbench.recorder import snapshot


def read(t):
    s = snapshot()
    n = s and s["spans"].get("hz.render.near_band", (0,))[0]
    launched = s["counters"].get("hz.kernels.near_band") if s else None
    if not n or launched is None:
        return None
    return 100.0 * launched[0] / n
