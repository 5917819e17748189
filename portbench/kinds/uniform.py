"""``count`` cell positions (i, j) a request, uniform in ``box_cells``."""

import numpy as np


def make(spec, config, rng):
    lo, hi = spec["box_cells"]

    def draw():
        pts = rng.uniform(lo, hi, (spec["count"], 2)).astype(np.float32)
        return {"pts": pts}
    return draw


def valid(spec, config, req) -> bool:
    lo, hi = spec["box_cells"]
    pts = req["pts"]
    return (pts.shape == (spec["count"], 2) and pts.dtype == np.float32
            and lo <= pts.min() and pts.max() <= hi)
