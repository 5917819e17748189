"""hybrid_pct.view: the share of the API's renders whose near field took
the z12 atlas's own texels, in %: ``hz.texture.hybrid`` / renders, from
the program's own recorder (portbench/recorder.py). None where nothing
rendered or the program counts neither the hybrid nor its fallback
(``hz.texture.hybrid_fallback``); 0 where every render fell back."""

from portbench.recorder import per_render, snapshot


def read(t):
    s = snapshot()
    n = s and per_render(s)
    c = s["counters"] if s else {}
    if not n or not ({"hz.texture.hybrid", "hz.texture.hybrid_fallback"}
                     & set(c)):
        return None
    return 100.0 * c.get("hz.texture.hybrid", (0, 0))[0] / n
