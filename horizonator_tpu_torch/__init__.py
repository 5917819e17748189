"""horizonator_tpu_torch: the SRTM terrain-panorama renderer in PyTorch,
with hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

The port of ``horizonator_tpu`` (JAX), which stays the reference: module
names mirror it, and the tests hold each module against its counterpart.
This package imports no JAX.
"""

from .api import horizonator
from .render import RenderParams, make_params, render_panorama

__all__ = ["horizonator", "RenderParams", "make_params", "render_panorama"]
