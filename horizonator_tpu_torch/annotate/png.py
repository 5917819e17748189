"""PNG annotation backend: rasterize the AnnotationScene with PIL.

Beyond the reference (annotator.c emits only cairo PDF/SVG,
annotator.c:184-205): `--image pano.png --pois peaks.json` writes labeled
bitmaps directly. Same scene (crosshairs, leaders, staggered names,
bearing ticks) as the vector backends; the link grid's invisible
hyperlink rectangles have no bitmap equivalent and are skipped.

Coordinates are render-image pixels (scene.py convention), drawn 1:1 --
no 72/300 page scaling.
"""

from __future__ import annotations

from .scene import AnnotationScene

_FONT_PATHS = (
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    "/usr/share/fonts/dejavu/DejaVuSans.ttf",
    "/usr/share/fonts/TTF/DejaVuSans.ttf",
)


def _u8(color):
    return tuple(int(round(255.0 * c)) for c in color)


def _font(size: float):
    from PIL import ImageFont
    for path in _FONT_PATHS:
        try:
            return ImageFont.truetype(path, int(round(size)))
        except OSError:
            continue
    return ImageFont.load_default()


def write_png(scene: AnnotationScene, filename: str) -> None:
    from PIL import Image, ImageDraw
    im = Image.fromarray(scene.image_rgb)
    draw = ImageDraw.Draw(im)
    for ln in scene.lines:
        draw.line([(ln.x0, ln.y0), (ln.x1, ln.y1)],
                  fill=_u8(ln.color), width=max(1, int(round(ln.width))))
    fonts: dict[int, object] = {}
    for t in scene.texts:
        key = int(round(t.size))
        if key not in fonts:
            fonts[key] = _font(t.size)
        f = fonts[key]
        # scene text y is the BASELINE; PIL anchors: ls = left-baseline,
        # ms = middle-baseline (anchor needs a truetype font -- the
        # load_default() bitmap fallback approximates with a raised xy)
        anchor = "ms" if t.centered else "ls"
        try:
            draw.text((t.x, t.y_baseline), t.s, font=f,
                      fill=_u8(t.color), anchor=anchor)
        except (ValueError, TypeError):
            w = draw.textlength(t.s, font=f) if t.centered else 0.0
            draw.text((t.x - w / 2.0, t.y_baseline - t.size), t.s,
                      font=f, fill=_u8(t.color))
    im.save(filename)
