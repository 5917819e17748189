"""setup_s: process start to the first timed request: imports, CUDA's
start, the seeded inputs, the program's objects, the kernels' build where
it is not built yet, and the warm-up requests."""


def read(w):
    return w.setup_s
