"""enqueue_host_us.batch: the host's time a viewpoint in the program's
entry calls outside their blocking syncs, us: (root spans' total -
``hz.sync`` total) / ``hz.viewpoints``, from the program's own recorder
(portbench/recorder.py: the traced window and the one traced warm-up
request before it)."""

from portbench.recorder import snapshot, span_s, viewpoints


def read(t):
    s = snapshot()
    v = s and viewpoints(s)
    if not v:
        return None
    return 1e6 * (s["roots"][1] - span_s(s, "hz.sync")) / v[0]
