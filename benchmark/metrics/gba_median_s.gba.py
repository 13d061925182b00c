"""Seconds a global BA, the median of the window's GBA times (host clock):
beside `gba_solve_s`, which is their mean and so carries every slow GBA,
the time of a typical one."""
import statistics


def read(run):
    times = run.data.get("gba_s")
    if not times:
        return None
    return statistics.median(times)
