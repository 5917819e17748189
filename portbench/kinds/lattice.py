"""A ``side`` x ``side`` lattice over ``box_cells`` a request, each point
moved by a uniform jitter of up to ``jitter_cells``."""

import numpy as np


def make(spec, config, rng):
    lo, hi = spec["box_cells"]
    g = np.linspace(lo, hi, spec["side"])
    ii, jj = np.meshgrid(g, g)
    grid = np.stack([ii.ravel(), jj.ravel()], axis=1)

    def draw():
        j = spec["jitter_cells"]
        pts = grid + rng.uniform(-j, j, grid.shape)
        return {"pts": pts.astype(np.float32)}
    return draw


def valid(spec, config, req) -> bool:
    lo, hi = spec["box_cells"]
    pad, pts = spec["jitter_cells"], req["pts"]
    return (pts.shape == (spec["side"] ** 2, 2) and pts.dtype == np.float32
            and lo - pad <= pts.min() and pts.max() <= hi + pad)
