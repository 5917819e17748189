"""sync_wait_ms.view: the host's time a view blocked at the API's syncs
(readbacks, the coverage guard's copy, the params' upload), ms:
``hz.sync`` total / renders, from the program's own recorder
(portbench/recorder.py: the traced window and the one traced warm-up
request before it)."""

from portbench.recorder import per_render, snapshot, span_s


def read(t):
    s = snapshot()
    n = s and per_render(s)
    if not n:
        return None
    return 1e3 * span_s(s, "hz.sync") / n
