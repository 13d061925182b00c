"""Seconds a global BA: the window's GBAs, the sum of their times over their
count; each from its first chunk's dispatch to its last chunk's
synchronise (host clock)."""


def read(run):
    times = run.data.get("gba_s")
    if not times:
        return None
    return sum(times) / len(times)
