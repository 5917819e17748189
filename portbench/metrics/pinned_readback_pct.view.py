"""pinned_readback_pct.view: the share of the API's renders whose outputs
came back through page-locked host memory, in %: counter
``hz.api.pinned_readback`` / ``hz.api.render`` spans, from the program's
own recorder (portbench/recorder.py). None where nothing rendered; 0
where no render took that route (a program that does not count it)."""

from portbench.recorder import per_render, snapshot


def read(t):
    s = snapshot()
    n = s and per_render(s)
    if not n:
        return None
    return 100.0 * s["counters"].get("hz.api.pinned_readback", (0, 0))[0] / n
