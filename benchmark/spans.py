"""The program's spans against the device trace: the solver phase that
launched each device operation, and the one the host was in during each
idle gap.

`capture(fn)` runs a function under torch.profiler with CUDA activity alone
(CUPTI records the kernels, copies and fills of every thread of the process;
no host-side op is recorded, so the slice runs at nearly its untraced speed)
and keeps each device operation as (name, start, end) in seconds on the
harness's clock (time.perf_counter; the profiler stamps events with the wall
clock in nanoseconds, and the offset between the two is read at the slice's
start). It also keeps the profiler's launch records: the CUDA runtime and
driver API events (cudaLaunchKernel, cudaLaunchKernelExC, cudaMemcpyAsync,
cuLaunchKernel, ...). Each carries the
correlation id of the operation it launched and the launching thread: on the
H100 with torch 2.11 `device_resource_id()` is the low 32 bits of the
thread's pthread handle, signed (`start_thread_id()` reads 1 for every
thread), so a thread is matched by `thread_key(threading.get_ident())`. The
program's spans (orbslam2_tpu_torch/utils/metrics.py, `recording()`) are
SpanRecords (name, start_s, end_s, parent, thread) on time.perf_counter(),
the clock the trace maps the device's operations onto.

`metric(name, run)` computes the per-layer metrics that read them, from
`run.trace` (a SpanTrace) and `run.data["program_spans"]`; None where the
run has either missing. `by_span` is the breakdown by span name.

As a module it measures a cell's GBA on the card (`python3 -m
benchmark.spans --workload gba-512-cg --seed <n> [--pairs 6]`): GBAs with
span recording off and on in turns (the recording's cost, the profiler
off), then one GBA traced with recording on, and prints one JSON line: the
metrics, the span counts, the breakdown, the longest idle gaps by span,
and the trace's kernels and idle share as the accepted readers count them.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field

from benchmark import trace as TR

NONE = "(none)"  # operations and gaps no span claims
# the metrics computed here: name -> (span, what)
METRICS = {"pcg_device_s.gba": ("ba.pcg", "device_s"),
           "edge_device_s.gba": ("ba.edge_terms", "device_s"),
           "assemble_device_s.gba": ("ba.assemble", "device_s"),
           "kernels_per_cg_step.gba": ("ba.pcg", "kernels_per_step")}
CG_STEP = "ba.pcg.matvec"


@dataclass
class SpanTrace(TR.Trace):
    corr: list = field(default_factory=list)      # correlation id of each op of `ops`
    launches: dict = field(default_factory=dict)  # correlation id -> (thread key, host s)


def thread_key(ident: int) -> int:
    """A thread's pthread handle (threading.get_ident()) as the profiler's
    launch records name it: its low 32 bits, signed."""
    return ((ident & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def capture(fn) -> tuple[object, SpanTrace]:
    """(fn(), the trace of the device operations while it ran, with the
    API call that launched each)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        offset = time.time_ns() * 1e-9 - time.perf_counter()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    ops, launches = [], {}
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() * 1e-9 - offset
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            ops.append((ev.name(), start, start + ev.duration_ns() * 1e-9,
                        ev.correlation_id()))
        elif ev.name().startswith("cu") and ev.correlation_id() > 0:
            known = launches.get(ev.correlation_id())
            if known is None or start < known[1]:
                launches[ev.correlation_id()] = (ev.device_resource_id(), start)
    ops.sort(key=lambda op: op[1])
    return out, SpanTrace(t0, t1, [op[:3] for op in ops], [op[3] for op in ops], launches)


def _innermost(spans: list, times: list) -> dict:
    """{query: index} of the innermost of one thread's nested spans
    [(start, end, index)] open at each time of [(t, query)], or -1."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    times = sorted(times)
    out, stack, i = {}, [], 0
    for t, q in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[q] = stack[-1][2] if stack else -1
    return out


def _by_thread(records: list) -> dict:
    inf = float("inf")
    spans = defaultdict(list)
    for i, r in enumerate(records):
        spans[thread_key(r.thread)].append((r.start_s, inf if r.end_s is None else r.end_s, i))
    return spans


def attribute_ops(trace: SpanTrace, records: list) -> list[int]:
    """For each operation of trace.ops, the index in `records` of the
    innermost span open on its launching thread when it was launched; -1
    where no span was, or no launch record is."""
    times = defaultdict(list)
    for k, c in enumerate(trace.corr):
        if c in trace.launches:
            thread, t = trace.launches[c]
            times[thread].append((t, k))
    owner = [-1] * len(trace.ops)
    for thread, spans in _by_thread(records).items():
        for k, i in _innermost(spans, times.get(thread, [])).items():
            owner[k] = i
    return owner


def attribute_gaps(trace: TR.Trace, records: list) -> list[tuple[int, float]]:
    """(index in `records` or -1, seconds) of each idle gap of the trace:
    the innermost span open at the gap's middle, of any thread (the latest
    opened where threads differ)."""
    gaps = TR.idle_gaps(trace.ops, trace.t0, trace.t1)
    mids = [(0.5 * (a + b), k) for k, (a, b) in enumerate(gaps)]
    best = [-1] * len(gaps)
    for spans in _by_thread(records).values():
        for k, i in _innermost(spans, mids).items():
            if i >= 0 and (best[k] < 0 or records[i].start_s > records[best[k]].start_s):
                best[k] = i
    return [(i, b - a) for i, (a, b) in zip(best, gaps)]


def _kernel(name: str) -> bool:
    return not name.startswith(TR.NON_KERNEL)


def by_span(trace: SpanTrace, records: list) -> dict:
    """{span name: {"device_s", "kernels", "idle_s"}}: the device seconds
    and kernels of the operations each span launched itself (not its
    children's), and the idle seconds it was innermost in; NONE for what no
    span claims. Ordered by device seconds."""
    out = defaultdict(lambda: {"device_s": 0.0, "kernels": 0, "idle_s": 0.0})
    for (name, a, b), i in zip(trace.ops, attribute_ops(trace, records)):
        row = out[records[i].name if i >= 0 else NONE]
        row["device_s"] += b - a
        row["kernels"] += _kernel(name)
    for i, s in attribute_gaps(trace, records):
        out[records[i].name if i >= 0 else NONE]["idle_s"] += s
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["device_s"]))


def _under(records: list, name: str) -> list[bool]:
    """For each record, whether it or one of its ancestors is named `name`."""
    flag = []
    for r in records:  # a parent precedes its children in a recording
        flag.append(r.name == name or (r.parent >= 0 and flag[r.parent]))
    return flag


def under(trace: SpanTrace, records: list, name: str) -> tuple[float, int]:
    """(device seconds, kernels) of the operations launched inside spans
    `name`, their children's included."""
    flag = _under(records, name)
    seconds, kernels = 0.0, 0
    for (op, a, b), i in zip(trace.ops, attribute_ops(trace, records)):
        if i >= 0 and flag[i]:
            seconds += b - a
            kernels += _kernel(op)
    return seconds, kernels


def metric(name: str, run) -> float | None:
    """Metric `name` of METRICS from the run's SpanTrace and program spans;
    None where the run has no such trace or no spans."""
    trace, records = run.trace, run.data.get("program_spans")
    if not isinstance(trace, SpanTrace) or not records:
        return None
    span, what = METRICS[name]
    seconds, kernels = under(trace, records, span)
    if what == "device_s":
        return seconds
    steps = sum(r.name == CG_STEP for r in records)
    return kernels / steps if steps else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="gba-512-cg")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=6, help="GBAs off and on, in turns")
    args = ap.parse_args(argv)
    from types import SimpleNamespace

    from benchmark import harness as H
    from benchmark import run as R
    from benchmark.drivers import gba as G

    R._environment()
    import torch

    from orbslam2_tpu_torch.utils import metrics as M

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    w = H.cell(args.workload)
    ctx = SimpleNamespace(workload=w, config=H.config(w["config"]),
                          traffic=H.traffic(w["traffic"]), seed=args.seed, seconds=0.0,
                          trace=True, device=torch.device("cuda"))
    from orbslam2_tpu_torch.ops import cuda_kernels as CK
    CK.build_kernels()
    g = G.GBA(ctx)
    p = G.problem(ctx)
    g.intrinsics = p["intrinsics"]
    prob = g.BA.BAProblem(**{k: p[k] for k in g.BA.BAProblem._fields})
    g.gba(prob)
    g.sync()

    def timed(on: bool):
        t0 = time.perf_counter()
        if on:
            with M.recording() as records:
                res = g.gba(prob)
        else:
            res, records = g.gba(prob), None
        return time.perf_counter() - t0, res, records

    times = {False: [], True: []}
    first = {}
    for k in range(2 * args.pairs):
        on = k % 4 in (1, 2)  # off, on, on, off, ...
        s, res, _ = timed(on)
        times[on].append(s)
        first.setdefault(on, res)
    same = all(torch.equal(a, b) for a, b in zip(first[False], first[True]))
    with M.recording() as records:
        _, trace = capture(lambda: g.gba(prob))
    owner = attribute_ops(trace, records)
    gaps = [(i, s, a - trace.t0) for (i, s), (a, _) in
            zip(attribute_gaps(trace, records), TR.idle_gaps(trace.ops, trace.t0, trace.t1))]
    gaps = sorted(gaps, key=lambda g_: -g_[1])[:10]
    ops_of = defaultdict(list)
    for op, i in zip(trace.ops, owner):
        ops_of[records[i].name if i >= 0 else NONE].append(op)
    run = SimpleNamespace(trace=trace, data={"program_spans": records})
    off, on = statistics.median(times[False]), statistics.median(times[True])
    line = {
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(0),
        "metrics": {m: metric(m, run) for m in METRICS},
        "gba_s_off": times[False], "gba_s_on": times[True],
        "recording_cost": on / off - 1.0, "bits_equal_on_off": same,
        "span_counts": dict(Counter(r.name for r in records)),
        "kernels": len(trace.kernels()),
        "kernels_unattributed": sum(i < 0 and _kernel(op[0]) for op, i in zip(trace.ops, owner)),
        "ops_without_launch": sum(c not in trace.launches for c in trace.corr),
        "busy_s": TR.busy_s(trace.ops, trace.t0, trace.t1), "window_s": trace.window_s,
        "idle_pct": 100.0 * (1.0 - TR.busy_s(trace.ops, trace.t0, trace.t1) / trace.window_s),
        "spans": by_span(trace, records),
        "span_ops": {n: TR.top_ops(o, 3) for n, o in ops_of.items()},
        # [span, seconds, start from the GBA's start]
        "idle_gaps": [[records[i].name if i >= 0 else NONE, s, a] for i, s, a in gaps],
    }
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
