"""Backend-independent annotation scene: the drawing-primitive list that the
SVG and PDF writers both consume.

Geometry convention: all coordinates are render-image pixels, origin top-left,
y down. Output pages are scaled by POINTS_PER_INCH/PIXELS_PER_INCH = 72/300
like the reference (annotator.c:29-31).
"""

from __future__ import annotations

from dataclasses import dataclass, field

POINTS_PER_INCH = 72.0    # annotator.c:29
PIXELS_PER_INCH = 300.0   # annotator.c:30
SCALE = POINTS_PER_INCH / PIXELS_PER_INCH

YELLOW = (1.0, 1.0, 0.0)  # annotator.c:276


@dataclass
class LinkRect:
    x: float
    y: float
    w: float
    h: float
    url: str


@dataclass
class Line:
    x0: float
    y0: float
    x1: float
    y1: float
    color: tuple = YELLOW
    width: float = 1.0


@dataclass
class Text:
    x: float          # left edge (or center when centered=True)
    y_baseline: float
    s: str
    size: float
    color: tuple = YELLOW
    url: str | None = None
    centered: bool = False


@dataclass
class AnnotationScene:
    width: int            # pixels
    height: int           # pixels (already cut)
    image_rgb: "object"   # (height, width, 3) uint8 RGB numpy array
    link_rects: list[LinkRect] = field(default_factory=list)
    lines: list[Line] = field(default_factory=list)
    texts: list[Text] = field(default_factory=list)

    @property
    def page_w_pt(self) -> float:
        return self.width * SCALE

    @property
    def page_h_pt(self) -> float:
        return self.height * SCALE


def caltopo_url(lat: float, lon: float) -> str:
    """The map-link URL scheme (annotator.c:90-91, 253-255)."""
    return f"https://caltopo.com/map.html#ll={lat:f},{lon:f}&z=15&b=mbt"
