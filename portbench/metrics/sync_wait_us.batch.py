"""sync_wait_us.batch: the host's time a viewpoint blocked at the
program's syncs (the viewpoints' and parameters' uploads, the full-circle
cover's table), us: ``hz.sync`` total / ``hz.viewpoints``, from the
program's own recorder (portbench/recorder.py: the traced window and the
one traced warm-up request before it)."""

from portbench.recorder import snapshot, span_s, viewpoints


def read(t):
    s = snapshot()
    v = s and viewpoints(s)
    if not v:
        return None
    return 1e6 * span_s(s, "hz.sync") / v[0]
