from .los import (Sightline, intervisibility_matrix, intervisible,
                  sightline)
from .shadows import shadow_light, sun_hours
from .viewshed import (horizon_sweep, viewshed_count, viewshed_grid,
                       viewshed_polar, viewshed_sweep)

__all__ = ["viewshed_polar", "viewshed_grid", "viewshed_sweep",
           "viewshed_count", "horizon_sweep", "shadow_light", "sun_hours",
           "Sightline", "sightline", "intervisible",
           "intervisibility_matrix"]
