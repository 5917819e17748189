"""lod_pct.view: the share of the API's renders that took the LOD march,
in %: counter ``hz.lod.renders`` / renders, from the program's own
recorder (portbench/recorder.py). None where nothing rendered or the
program has no such counter (an older program); a guard, not a lever: a
sound run of an SRTM1 cell reads 100."""

from portbench.recorder import per_render, snapshot


def read(t):
    s = snapshot()
    n = s and per_render(s)
    lod = s["counters"].get("hz.lod.renders") if s else None
    if not n or lod is None:
        return None
    return 100.0 * lod[0] / n
