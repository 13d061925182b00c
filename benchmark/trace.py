"""The device trace of a slice of the window, and its reductions.

`capture` runs a function under torch.profiler with CUDA activity alone
(CUPTI records the kernels, copies and fills of every thread of the process;
no host-side op is recorded, so the slice runs at nearly its untraced speed)
and keeps each device operation as (name, start, end) in seconds on the
harness's clock (time.perf_counter). The profiler stamps events with the
wall clock in nanoseconds; the offset between the two clocks is read at the
slice's start.

Reductions: the union of the operations' intervals (the device's busy time),
the kernels among them, the operations that took most time by name, and the
longest idle gaps, each named by what the harness's own spans say the host
was doing then.
"""
from __future__ import annotations

import time
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


def capture(fn) -> tuple[object, Trace]:
    """(fn(), the trace of the device operations while it ran)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        offset = time.time_ns() * 1e-9 - time.perf_counter()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    ops = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start = ev.start_ns() * 1e-9 - offset
        ops.append((ev.name(), start, start + ev.duration_ns() * 1e-9))
    ops.sort(key=lambda op: op[1])
    return out, Trace(t0, t1, ops)


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


def named_gaps(ops: list, t0: float, t1: float, spans: list, k: int = 10) -> list:
    """[[what the host was doing, seconds]] of the k longest idle gaps: the
    names of the harness's spans (name, start, end) open at the gap's middle,
    joined by '+', or 'harness' where none was."""
    out = []
    for a, b in sorted(idle_gaps(ops, t0, t1), key=lambda g: g[0] - g[1])[:k]:
        mid = 0.5 * (a + b)
        names = sorted({n for n, s, e in spans if s <= mid <= e})
        out.append(["+".join(names) or "harness", b - a])
    return out
