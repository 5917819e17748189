from .sharding import (broadcast_params_batch, horizon_batch, render_batch,
                       render_path, stack_params)

__all__ = ["broadcast_params_batch", "horizon_batch", "render_batch",
           "render_path", "stack_params"]
