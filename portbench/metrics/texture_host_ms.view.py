"""texture_host_ms.view: the host's time a view in the textured stages of
the march, ms: (``hz.render.near_colors`` + ``hz.render.hybrid``) totals /
renders, from the program's own recorder (portbench/recorder.py: the
traced window and the one traced warm-up request before it). None where
the program records neither span."""

from portbench.recorder import per_render, snapshot, span_s

SPANS = ("hz.render.near_colors", "hz.render.hybrid")


def read(t):
    s = snapshot()
    n = s and per_render(s)
    if not n or not any(k in s["spans"] for k in SPANS):
        return None
    return 1e3 * sum(span_s(s, k) for k in SPANS) / n
