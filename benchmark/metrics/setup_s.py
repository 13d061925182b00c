"""Seconds from the process's start to the window's start: imports, the CUDA
context, the kernels' build (a no-op once built in the checkout), the inputs
made from the seed, and the warm-up (host clock)."""


def read(run):
    return run.setup_s
