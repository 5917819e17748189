"""One viewpoint (lat, lon) a request, a random walk from the
configuration's view: each move a uniform bearing and a uniform length in
``step_m``, reflected back when it would leave ``box_deg`` around the
view."""

import math

M_PER_DEG = 6371000.0 * math.pi / 180.0


def make(spec, config, rng):
    lat0, lon0 = config["view_latlon"]
    here = [lat0, lon0]

    def draw():
        lat, lon = here
        bearing = rng.uniform(0.0, 2.0 * math.pi)
        dist = rng.uniform(*spec["step_m"])
        for flip in (0.0, math.pi):
            b = bearing + flip
            nlat = lat + dist * math.cos(b) / M_PER_DEG
            nlon = lon + dist * math.sin(b) / (
                M_PER_DEG * math.cos(math.radians(lat)))
            if (abs(nlat - lat0) <= spec["box_deg"]
                    and abs(nlon - lon0) <= spec["box_deg"]):
                break
        here[:] = nlat, nlon
        return {"lat": nlat, "lon": nlon}
    return draw


def valid(spec, config, req) -> bool:
    lat0, lon0 = config["view_latlon"]
    return (abs(req["lat"] - lat0) <= spec["box_deg"] + 1e-9
            and abs(req["lon"] - lon0) <= spec["box_deg"] + 1e-9)
