"""glue_device_ms.view: device time of every operation but the window
march, the resolve and the copies, ms a viewpoint: the torch glue."""

KERNELS = ("window_march", "resolve_kernel", "Memcpy", "Memset")


def read(t):
    s = t.device_s(None, exclude=KERNELS)
    return 1e3 * s / t.viewpoints if s > 0 else None
