"""A camera path a request: ``frames`` viewpoints from a start uniform
within ``start_cells`` of the view's cell, moving ``step_cells`` (i, j) a
frame, with an azimuth window ``az_span_deg`` wide that turns ``turn_deg``
a frame from a uniform first bearing."""

import numpy as np


def make(spec, config, rng):
    f = np.arange(spec["frames"], dtype=np.float64)
    di, dj = spec["step_cells"]
    half = spec["az_span_deg"] / 2.0

    def draw():
        start = rng.uniform(-spec["start_cells"], spec["start_cells"], 2)
        az = rng.uniform(-180.0, 180.0)
        return {"start": start, "di": start[0] + di * f,
                "dj": start[1] + dj * f,
                "az0": az - half + spec["turn_deg"] * f,
                "az1": az + half + spec["turn_deg"] * f}
    return draw


def valid(spec, config, req) -> bool:
    return (len(req["di"]) == spec["frames"]
            and np.abs(req["start"]).max() <= spec["start_cells"])
