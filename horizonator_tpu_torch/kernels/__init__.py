"""Hand-written CUDA kernels for Hopper (sm_90a), bound with ctypes.

``window_march.march`` and ``resolve.resolve`` launch their kernels for
CUDA tensors, take their plain PyTorch versions for CPU tensors, and count
their launches in ``<wrapper>.launches``. ``build`` compiles ``csrc/*.cu``.
"""
