"""Device seconds of the operations launched inside the BA solver's
`ba.edge_terms` spans, their children's included, in the profiled GBA: the device
trace against the program's spans (benchmark/spans.py)."""
from benchmark import spans as SP


def read(run):
    return SP.metric("edge_device_s.gba", run)
