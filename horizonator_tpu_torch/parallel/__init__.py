from .sharding import (broadcast_params_batch, horizon_batch,
                       make_sharded_horizon, make_sharded_renderer,
                       render_batch, render_path, stack_params)
from .regions import (make_region_sharded_horizon,
                      make_region_sharded_renderer)

__all__ = ["broadcast_params_batch", "horizon_batch",
           "make_region_sharded_horizon", "make_region_sharded_renderer",
           "make_sharded_horizon", "make_sharded_renderer", "render_batch",
           "render_path", "stack_params"]
