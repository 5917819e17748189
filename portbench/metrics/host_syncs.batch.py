"""host_syncs.batch: the places an entry call's host waits for the
device, a call: ``hz.host_syncs`` / the calls that counted
``hz.viewpoints``, from the program's own recorder (portbench/recorder.py:
the traced window and the one traced warm-up request before it)."""

from portbench.recorder import snapshot, viewpoints


def read(t):
    s = snapshot()
    v = s and viewpoints(s)
    if not v:
        return None
    return s["counters"].get("hz.host_syncs", (0, 0))[0] / v[1]
