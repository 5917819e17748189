"""resolve_roofline.view: the resolve's least time (portbench/roofline.py,
from the traced requests' own shapes) over its device time in the traced
window, in %."""


def read(t):
    s = t.device_s("resolve_kernel")
    if s <= 0 or not t.work.get("resolve"):
        return None
    return 100.0 * t.work["resolve"] / s
