"""march_roofline.batch: the window march's least time (portbench/roofline.py,
from the traced requests' own shapes and geometry) over its device time in
the traced window, in %."""


def read(t):
    s = t.device_s("window_march")
    if s <= 0 or not t.work.get("march"):
        return None
    return 100.0 * t.work["march"] / s
