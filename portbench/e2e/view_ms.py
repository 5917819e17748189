"""view_ms: the window over the requests completed in it, ms a request:
an interactive user's time per move, stalls included."""


def read(w):
    return 1e3 * w.window_s / max(w.requests - w.failed, 1)
