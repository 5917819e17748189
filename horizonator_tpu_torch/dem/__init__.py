from .hgt import (SRTM1_EDGE, SRTM3_EDGE, cells_per_deg, hgt_filename,
                  hgt_path, read_hgt, write_hgt)
from .mosaic import (DemMosaic, load_mosaic, radius_cells_from_m,
                     RADIUS_CELLS_DEFAULT_PY, EARTH_RADIUS_M)

__all__ = [
    "SRTM1_EDGE", "SRTM3_EDGE", "cells_per_deg", "hgt_filename", "hgt_path",
    "read_hgt", "write_hgt", "DemMosaic", "load_mosaic", "radius_cells_from_m",
    "RADIUS_CELLS_DEFAULT_PY", "EARTH_RADIUS_M",
]
