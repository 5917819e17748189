"""host_syncs.view: the places a view's host waits for the device, a
view: ``hz.host_syncs`` / renders, from the program's own recorder
(portbench/recorder.py: the traced window and the one traced warm-up
request before it)."""

from portbench.recorder import per_render, snapshot


def read(t):
    s = snapshot()
    n = s and per_render(s)
    if not n:
        return None
    return s["counters"].get("hz.host_syncs", (0, 0))[0] / n
