"""Percent of the chip's roofline that a GBA reaches: the least time the
chip could take for a GBA's work (operations and bytes of the frozen
`ba_counts` at the problem's sizes and the GBA schedule, against the
published H100 float32 and HBM peaks) over the mean measured time of the
window's GBAs (host clock)."""
from benchmark import counts as CT


def read(run):
    times = run.data.get("gba_s")
    if not times or run.trace is None:
        return None
    n_bytes, flop = run.data["work"]
    least = CT.least_seconds(n_bytes, flop)
    return 100.0 * least / (sum(times) / len(times))
