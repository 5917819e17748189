"""Hand-written CUDA kernels for Hopper (sm_90a), bound with ctypes.

``window_march.march``, ``resolve.resolve``, ``near_band.near_band``,
``viewshed_resample.resample`` and the roll-ceiling probes
``roll_ceiling.roll_minmax``/``roll_kv`` (and their shared-memory
entries ``roll_minmax_smem``/``roll_kv_smem``) launch their kernels for CUDA
tensors, take their plain PyTorch versions for CPU tensors, and count
their launches in ``<wrapper>.launches``. ``build`` compiles ``csrc/*.cu``.
"""
