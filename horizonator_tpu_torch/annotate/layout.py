"""Label placement: x-sort + overlap-group staggering (annotator.c:350-389)
and Helvetica text metrics for width estimates (the reference asks cairo;
we carry the standard Helvetica AFM widths)."""

from __future__ import annotations

FONT_HEIGHT = 20        # annotator.c:33
TEXT_MARGIN = 2         # annotator.c:27
FONT_SIZE = FONT_HEIGHT - TEXT_MARGIN
LABEL_CROSSHAIR_R = 3   # annotator.c:26

# Standard Helvetica character widths, 1/1000 em, ASCII 32..126.
_HELV = [
    278, 278, 355, 556, 556, 889, 667, 191, 333, 333, 389, 584, 278, 333,
    278, 278, 556, 556, 556, 556, 556, 556, 556, 556, 556, 556, 278, 278,
    584, 584, 584, 556, 1015, 667, 667, 722, 722, 667, 611, 778, 722, 278,
    500, 667, 556, 833, 722, 778, 667, 778, 722, 667, 611, 722, 667, 944,
    667, 667, 611, 278, 278, 278, 469, 556, 333, 556, 556, 500, 556, 556,
    278, 556, 556, 222, 222, 500, 222, 833, 556, 556, 556, 556, 333, 500,
    278, 556, 500, 722, 500, 500, 500, 334, 260, 334, 584,
]


def string_width(s: str, font_size: float = FONT_SIZE) -> float:
    """Approximate rendered width in pixels (Helvetica metrics; non-ASCII
    chars counted as an em/2)."""
    total = 0
    for ch in s:
        o = ord(ch)
        total += _HELV[o - 32] if 32 <= o <= 126 else 500
    return total * font_size / 1000.0


def stagger_labels(pois, xs, ys, height_out: int,
                   font_height: int = FONT_HEIGHT):
    """Assign a label-top y to each kept POI.

    Port of the algorithm at annotator.c:350-389: sort by crosshair x; walk
    left to right tracking the right edge of the current overlapping group;
    a non-overlapping label (or one that would fall off the bottom) restarts
    at the top, otherwise it steps one line down.

    Args: pois: sequence with .name; xs, ys: crosshair positions (kept only).
    Returns a list of (poi, x, y, y_label_top) in draw order.
    """
    order = sorted(range(len(pois)), key=lambda i: xs[i])
    out = []
    overlap_right = -1.0
    current_y = 0.0
    for i in order:
        left = xs[i]
        right = xs[i] + string_width(pois[i].name)
        if left > overlap_right or current_y + font_height >= height_out:
            current_y = 0.0
            overlap_right = right
        else:
            if overlap_right < right:
                overlap_right = right
        out.append((pois[i], xs[i], ys[i], current_y))
        current_y += font_height
    return out
