"""enqueue_host_ms.view: the host's time a view in the API's render
outside its blocking syncs, ms: (``hz.api.render`` total - ``hz.sync``
total) / renders, from the program's own recorder (portbench/recorder.py:
the traced window and the one traced warm-up request before it)."""

from portbench.recorder import per_render, snapshot, span_s


def read(t):
    s = snapshot()
    n = s and per_render(s)
    if not n:
        return None
    return 1e3 * (span_s(s, "hz.api.render") - span_s(s, "hz.sync")) / n
