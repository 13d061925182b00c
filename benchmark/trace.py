"""The device trace of a slice of the window (benchmark/spans.py's
`capture`), and its reductions: the union of the operations' intervals (the
device's busy time), the kernels among them, the operations that took most
time by name, and the idle gaps.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

NON_KERNEL = ("Memcpy", "Memset", "memcpy", "memset")


@dataclass
class Trace:
    t0: float                  # the slice, perf_counter seconds
    t1: float
    ops: list = field(default_factory=list)  # (name, start, end), by start

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def kernels(self) -> list:
        return [op for op in self.ops if not op[0].startswith(NON_KERNEL)]


def busy_s(ops: list, t0: float, t1: float) -> float:
    """Seconds of [t0, t1] in which some operation of `ops` ran."""
    total, end = 0.0, t0
    for _, a, b in sorted(ops, key=lambda op: op[1]):
        a, b = max(a, end), min(b, t1)
        if b > a:
            total += b - a
            end = b
    return total


def idle_gaps(ops: list, t0: float, t1: float) -> list[tuple[float, float]]:
    """The intervals of [t0, t1] in which no operation ran."""
    gaps, end = [], t0
    for _, a, b in sorted(ops, key=lambda op: op[1]):
        if a > end:
            gaps.append((end, min(a, t1)))
        end = max(end, b)
        if end >= t1:
            break
    if end < t1:
        gaps.append((end, t1))
    return [g for g in gaps if g[1] > g[0]]


def top_ops(ops: list, k: int = 10) -> list:
    """[[name, seconds]] of the k names with most device time."""
    by = defaultdict(float)
    for name, a, b in ops:
        by[name] += b - a
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
