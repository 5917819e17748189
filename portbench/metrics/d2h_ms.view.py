"""d2h_ms.view: device-to-host copy time of the traced window, ms a
viewpoint (the API's readback of the image and the ranges)."""


def read(t):
    s = t.device_s("Memcpy DtoH")
    return 1e3 * s / t.viewpoints if s > 0 else None
