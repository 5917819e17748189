"""lod_host_ms.view: the host's time a view in the LOD march, ms:
``hz.lod.march`` total / renders, from the program's own recorder
(portbench/recorder.py: the traced window and the one traced warm-up
request before it). None where the program records no such span."""

from portbench.recorder import per_render, snapshot, span_s


def read(t):
    s = snapshot()
    n = s and per_render(s)
    if not n or "hz.lod.march" not in s["spans"]:
        return None
    return 1e3 * span_s(s, "hz.lod.march") / n
