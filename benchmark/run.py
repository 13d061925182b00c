"""The port's benchmark: one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix, limits
and metric readers are found by name (benchmark/harness.py). The run makes
its inputs from --seed, sets up and warms the program (orbslam2_tpu_torch)
on the card, measures it for --seconds, checks what the window produced
against the plain reference, and prints the numbers compared, each beside
its limit, as the last lines of standard error, then one JSON line as the
last line of standard output: correct, attempted, failed, metrics (the
cell's end-to-end metrics, or with --trace 1 its per-layer ones, read from a
profiled slice of the window), device, with --trace 1 a breakdown, and the
checks. Exits 2 without enough CUDA devices and 3 if JAX or the JAX package
was loaded, printing no result in either case. With --detail FILE it also
writes there what benchmark/spread.py reads: each GBA's time, the window's
wall-clock ends, and the allocator's new segments and the collector's passes
inside it.
"""
import time

T_PROCESS = time.perf_counter()  # the run's start, before anything heavy loads

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
               "NUMEXPR_NUM_THREADS")


def _environment() -> None:
    """One host thread a library, and every kernel cache at a fixed path in
    the checkout: the port builds its own kernels into build/ there, and a
    Triton or torch-extension cache, should the port come to have one, goes
    beside it."""
    for var in THREAD_VARS:
        os.environ[var] = "1"
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" / "torch_extensions")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--detail", type=Path,
                    help="write the window's per-GBA record here (benchmark/spread.py)")
    return ap.parse_args(argv)


def result(run, workload: dict, trace: bool, device_kind: str):
    """(checks, the result line) of a finished run."""
    from benchmark import harness as H
    from benchmark import spans as SP
    from benchmark import trace as TR

    checks = H.checks(run.values, workload["name"])
    correct = (not run.errors and run.attempted > 0 and bool(checks)
               and all(c.ok for c in checks))
    metrics = {}
    for m in H.metrics_of(workload["name"], trace):
        value = H.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": run.chips,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = {"correct": correct, "attempted": int(run.attempted),
            "failed": int(run.failed), "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        t = run.trace
        device["busy_s"] = TR.busy_s(t.ops, t.t0, t.t1)
        device["window_s"] = t.window_s
        records = run.data.get("program_spans", [])
        gaps = sorted(SP.attribute_gaps(t, records), key=lambda g: -g[1])[:10]
        line["breakdown"] = {
            "device_ops": TR.top_ops(t.ops),
            # the longest idle gaps, each by the program's innermost span open at it
            "idle_gaps": [[records[i].name if i >= 0 else SP.NONE, s] for i, s in gaps],
            # the device seconds of the operations each span launched itself
            "spans": [[name, r["device_s"]]
                      for name, r in list(SP.by_span(t, records).items())[:10]]}
    line["checks"] = {c.name: {"value": c.value if c.value == c.value else None,
                               c.rel: c.limit} for c in checks}
    return checks, line


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    from benchmark import harness as H

    workload = H.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {workload['chips']} CUDA device(s); "
              f"this machine has {n}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    traffic = H.traffic(workload["traffic"])
    ctx = SimpleNamespace(workload=workload, config=H.config(workload["config"]),
                          traffic=traffic, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=torch.device("cuda"),
                          t_process=T_PROCESS, checkout=CHECKOUT)
    run = H.driver(traffic["driver"]).run(ctx)
    if args.detail is not None:
        args.detail.write_text(json.dumps({"gba_s": run.data["gba_s"], **run.data["window"]}))
    checks, line = result(run, workload, bool(args.trace), torch.cuda.get_device_name(0))
    bad = H.forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for err in run.errors:
        print(err, file=sys.stderr)
    for c in checks:
        rel = "<=" if c.rel == "at_most" else ">="
        print(f"check {c.name} {c.value!r} {rel} {c.limit!r} "
              f"{'ok' if c.ok else 'FAIL'}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
