"""Percent of the profiled GBA in which no operation ran on the card: 100
less the union of the device operations' intervals over the GBA (device
trace)."""
from benchmark import trace as TR


def read(run):
    t = run.trace
    if t is None or not t.ops:
        return None
    return 100.0 * (1.0 - TR.busy_s(t.ops, t.t0, t.t1) / t.window_s)
