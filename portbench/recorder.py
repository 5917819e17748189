"""The program's own spans and counters, as the per-layer metrics read
them: ``horizonator_tpu_torch.profiling.snapshot()``.

The program records only while torch.profiler runs, so in a traced run
(``--trace 1``) the recorder holds the harness's one traced warm-up
request as well as the traced window: one call more than the window's, in
about 38 (count256) to 370 (sweep1024). An untraced run records nothing.
"""

from __future__ import annotations


def snapshot() -> dict | None:
    """The program's snapshot, or None where it has no recorder (an older
    program) or the recorder holds nothing."""
    from horizonator_tpu_torch import profiling
    snap = getattr(profiling, "snapshot", None)
    if snap is None:
        return None
    s = snap()
    return s if s["spans"] or s["counters"] else None


def span_s(s: dict, name: str) -> float:
    """Seconds in span ``name`` in all."""
    return s["spans"].get(name, (0, 0.0, 0.0))[1]


def per_render(s: dict) -> int | None:
    """The API's renders (``hz.api.render`` spans), None for none."""
    return s["spans"].get("hz.api.render", (0,))[0] or None


def viewpoints(s: dict) -> tuple[int, int] | None:
    """(viewpoints, entry calls) that the batch entries counted, None for
    none."""
    v = s["counters"].get("hz.viewpoints")
    return v if v and v[0] else None
