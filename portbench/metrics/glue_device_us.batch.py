"""glue_device_us.batch: device time of every operation but the window
march, the resolve and the copies, us a viewpoint: the torch glue (in a
cumulative viewshed, its resampler)."""

KERNELS = ("window_march", "resolve_kernel", "Memcpy", "Memset")


def read(t):
    s = t.device_s(None, exclude=KERNELS)
    return 1e6 * s / t.viewpoints if s > 0 else None
