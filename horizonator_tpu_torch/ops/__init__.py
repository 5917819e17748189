from .viewshed import (horizon_sweep, viewshed_count, viewshed_grid,
                       viewshed_polar, viewshed_sweep)

__all__ = ["viewshed_polar", "viewshed_grid", "viewshed_sweep",
           "viewshed_count", "horizon_sweep"]
