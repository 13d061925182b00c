"""CUDA kernels in the profiled GBA (device trace)."""


def read(run):
    t = run.trace
    if t is None:
        return None
    return len(t.kernels())
