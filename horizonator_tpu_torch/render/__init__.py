from .raymarch import (RenderParams, make_params, params_from_jax,
                       render_panorama, resolve_to_image)

__all__ = ["RenderParams", "make_params", "params_from_jax",
           "render_panorama", "resolve_to_image"]
