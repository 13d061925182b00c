"""Where a cell's run-to-run spread comes from.

    python3 -m benchmark.spread --workload <cell> --seeds <n> ... [--seconds 20 ...]
        [--trace 0] [--parent DIR] [--card] [--out FILE]

runs the cell once a seed of --seeds, in that order, each run in a fresh
process from the checkout's root, as a check runs it (`python3 -m
benchmark.run ...`; the change side also passes `--detail FILE`, which the
run writes once it has ended). Several --seconds run each seed at every
window length, the lengths in turns (the order rotated from seed to seed),
and summarise each length apart. With --parent, each seed runs as parent,
change, change, parent, the parent from DIR (a copy of the parent commit,
run without --detail). With --card, `nvidia-smi -lms 250` samples the card's
SM clock, power and temperature beside each run; without it nothing runs
beside the measured process. It prints one line a run: the reading, the
quartiles of the window's per-GBA times, the mean of the first and of the
last tenth of them, the allocator's new segments, and with --card the clocks
and power inside the window; then a summary a side: the quartile spread of
the readings over their median (all runs, and as a check judges a bound's
tightness: the mean of the two sets' spreads, a set being each seed's first
or second run, each without its run farthest from the median), the share of
the readings' variance that lies between runs and within them, drift,
outliers, the seed, and the clocks against the readings. Every line also
goes to --out as JSON.
"""
from __future__ import annotations

import argparse
import datetime
import json
import statistics
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
SMI_FIELDS = ("timestamp", "clocks.sm", "power.draw", "temperature.gpu")


# ---- arithmetic --------------------------------------------------------

def spread(values: list, drop_farthest: bool = False) -> float | None:
    """Quartile distance over the median (statistics.quantiles, n=4), as the
    benchmark's bounds measure a spread; with drop_farthest, without the value
    farthest from the median first. None for fewer than two values."""
    values = list(values)
    if drop_farthest and len(values) > 2:
        med = statistics.median(values)
        values.remove(max(values, key=lambda v: abs(v - med)))
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def sets_spread(runs: list[tuple[int, float]]) -> dict:
    """A check's view of a side's runs [(seed, reading)]: set a holds
    each seed's first run, set b its second. `sets` is the mean of the two
    sets' spreads, each without its run farthest from the median (what a
    bound is held to for tightness); `all` is the spread of every run (for
    looseness); `wider` the wider of the two sets' own spreads."""
    seen, a, b = set(), [], []
    for seed, v in runs:
        (b if seed in seen else a).append(v)
        seen.add(seed)
    sa, sb = spread(a, True), spread(b, True)
    both = [s for s in (sa, sb) if s is not None]
    wide = [s for s in (spread(a), spread(b)) if s is not None]
    return {"a": sa, "b": sb, "sets": sum(both) / len(both) if both else None,
            "wider": max(wide) if wide else None, "all": spread([v for _, v in runs]),
            "median": statistics.median(v for _, v in runs) if runs else None}


def tenths(times: list) -> tuple[float, float] | None:
    """Means of the first and of the last tenth of a window's GBA times (at
    least one GBA each)."""
    if not times:
        return None
    k = max(1, len(times) // 10)
    return statistics.fmean(times[:k]), statistics.fmean(times[-k:])


def decompose(runs: list[list]) -> dict | None:
    """How a set of runs' per-GBA times vary. `between` and `within`: the
    shares of the times' sum of squares between the runs' means and within
    runs. `reading_within`: the share of the variance of the runs' means
    that the within-run scatter alone would give (its variance over each
    run's count); the rest, `reading_between`, is a run's own offset: its
    process, its host, its problem."""
    runs = [list(r) for r in runs if r]
    if len(runs) < 2:
        return None
    grand = statistics.fmean(t for r in runs for t in r)
    means = [statistics.fmean(r) for r in runs]
    ss_b = sum(len(r) * (m - grand) ** 2 for r, m in zip(runs, means))
    ss_w = sum((t - m) ** 2 for r, m in zip(runs, means) for t in r)
    n = sum(len(r) for r in runs)
    var_w = ss_w / (n - len(runs)) if n > len(runs) else 0.0
    var_means = statistics.variance(means)
    expected = var_w * statistics.fmean(1.0 / len(r) for r in runs)
    share = min(1.0, expected / var_means) if var_means > 0 else 1.0
    total = ss_b + ss_w
    return {"between": ss_b / total if total else 0.0,
            "within": ss_w / total if total else 0.0,
            "reading_within": share, "reading_between": 1.0 - share}


def correlation(xs: list, ys: list) -> float | None:
    """Pearson's r, None where either side is constant or too short."""
    pairs = [(x, y) for x, y in zip(xs, ys) if x is not None and y is not None]
    if len(pairs) < 3:
        return None
    try:
        return statistics.correlation(*zip(*pairs))
    except statistics.StatisticsError:
        return None


def gba_stats(times: list) -> dict | None:
    """Quartiles, mean, largest, the two tenths and the share of the mean
    that lies above the median of one window's GBA times."""
    if not times:
        return None
    q = statistics.quantiles(times, n=4) if len(times) > 1 else [times[0]] * 3
    first, last = tenths(times)
    mean, med = statistics.fmean(times), statistics.median(times)
    return {"n": len(times), "q1": q[0], "median": med, "q3": q[2], "mean": mean,
            "max": max(times), "first_tenth": first, "last_tenth": last,
            "mean_over_median": mean / med - 1.0}


# ---- the runner ---------------------------------------------------------

class Sampler:
    """nvidia-smi's clock, power and temperature every `ms`, in a thread."""

    def __init__(self, ms: int = 250):
        self.rows = []
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "-i", "0", f"--query-gpu={','.join(SMI_FIELDS)}",
                 "--format=csv,noheader,nounits", "-lms", str(ms)],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
            return
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            parts = [p.strip() for p in line.split(",")]
            try:
                t = datetime.datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
                self.rows.append((t, float(parts[1]), float(parts[2]), float(parts[3])))
            except (ValueError, IndexError):
                continue

    def stop(self) -> list:
        if self.proc is not None:
            self.proc.terminate()
            self.proc.wait(timeout=30)
            self.thread.join(timeout=30)
        return self.rows

    @staticmethod
    def inside(rows: list, wall: list | None) -> dict | None:
        """The samples' SM clock (median, least, most), mean power and
        largest temperature, inside the window [wall] (all of them
        without one)."""
        if wall is not None:
            rows = [r for r in rows if wall[0] <= r[0] <= wall[1]]
        if not rows:
            return None
        sm = [r[1] for r in rows]
        return {"samples": len(rows), "sm_mhz": statistics.median(sm), "sm_min": min(sm),
                "sm_max": max(sm), "power_w": statistics.fmean(r[2] for r in rows),
                "temp_c": max(r[3] for r in rows)}


def run_once(checkout: Path, workload: str, seed: int, seconds: float, trace: int,
             detail: bool, card: bool, timeout: float) -> dict:
    """One run of the cell in a fresh process from `checkout`: its result
    line, its per-GBA record (with `detail`) and, with `card`, the card's
    samples."""
    argv = [sys.executable, "-m", "benchmark.run", "--workload", workload,
            "--seed", str(seed), "--seconds", f"{seconds:g}", "--trace", str(trace)]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "detail.json"
        if detail:
            argv += ["--detail", str(path)]
        sampler = Sampler() if card else None
        try:
            out = subprocess.run(argv, cwd=checkout, capture_output=True, text=True,
                                 timeout=timeout)
        finally:
            rows = sampler.stop() if sampler else []
        info = json.loads(path.read_text()) if detail and path.exists() else {}
    lines = out.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1]) if lines else {}
    except json.JSONDecodeError:
        line = {}
    return {"rc": out.returncode, "line": line, "detail": info,
            "card": Sampler.inside(rows, info.get("wall")) if card else None,
            "stderr_tail": out.stderr[-2000:] if out.returncode else ""}


def row(label: str, seed: int, r: dict, metric: str) -> dict:
    """A run's line: its reading and what ran beside it."""
    line, d = r["line"], r["detail"]
    m = line.get("metrics", {})
    return {"side": label, "seed": seed, "rc": r["rc"], "correct": line.get("correct"),
            "attempted": line.get("attempted"), "failed": line.get("failed"),
            "reading": m.get(metric, {}).get("value"), "metrics": m,
            "device": line.get("device"), "breakdown": line.get("breakdown"),
            "setup_s": m.get("setup_s", {}).get("value"),
            "memory_peak_bytes": line.get("device", {}).get("memory_peak_bytes"),
            "checks": line.get("checks"), "gba": gba_stats(d.get("gba_s", [])),
            "card": r["card"], "new_segments": d.get("new_segments"),
            "gc_passes": d.get("gc_passes"), "gba_s": d.get("gba_s"),
            "stderr_tail": r["stderr_tail"]}


def summary(rows: list, label: str) -> dict:
    """What a side's runs say about its spread."""
    mine = [r for r in rows if r["side"] == label and r["reading"] is not None]
    readings = [(r["seed"], r["reading"]) for r in mine]
    out = {"side": label, "runs": len(mine),
           "correct": sum(r["correct"] is True and r["failed"] == 0 for r in mine),
           "reading": sets_spread(readings),
           "setup_s": sets_spread([(r["seed"], r["setup_s"]) for r in mine])}
    counts = {}
    for r in mine:
        counts[r["seed"]] = counts.get(r["seed"], 0) + 1
    fixed = [v for s, v in readings if counts[s] > 1]
    distinct = [v for s, v in readings if counts[s] == 1]
    out["seed"] = {"repeated_seeds": spread(fixed), "distinct_seeds": spread(distinct),
                   "repeated_median": statistics.median(fixed) if fixed else None,
                   "distinct_median": statistics.median(distinct) if distinct else None}
    timed = [r for r in mine if r["gba_s"]]
    if timed:
        out["decompose"] = decompose([r["gba_s"] for r in timed])
        out["median_reading"] = sets_spread([(r["seed"], r["gba"]["median"]) for r in timed])
        out["drift"] = {"first_over_rest": statistics.median(
            r["gba"]["first_tenth"] / r["gba"]["median"] - 1.0 for r in timed),
            "last_over_rest": statistics.median(
            r["gba"]["last_tenth"] / r["gba"]["median"] - 1.0 for r in timed)}
        out["outliers"] = {"mean_over_median": statistics.median(
            r["gba"]["mean_over_median"] for r in timed),
            "max_over_median": statistics.median(r["gba"]["max"] / r["gba"]["median"]
                                                 for r in timed)}
    with_card = [r for r in mine if r["card"]]
    if with_card:
        out["clock_vs_reading"] = correlation([r["reading"] for r in with_card],
                                              [r["card"]["sm_mhz"] for r in with_card])
        out["power_vs_reading"] = correlation([r["reading"] for r in with_card],
                                              [r["card"]["power_w"] for r in with_card])
    peaks = sorted({r["memory_peak_bytes"] for r in mine if r["memory_peak_bytes"]})
    out["memory_peak_bytes"] = [peaks[0], peaks[-1]] if peaks else None
    return out


def schedule(seeds: list, lengths: list, sides: list) -> list:
    """(seed, seconds, side) in the order they run: each seed at every
    length, the lengths rotated by one from seed to seed, each length's
    sides in turn."""
    out = []
    for i, seed in enumerate(seeds):
        k = i % len(lengths)
        for seconds in lengths[k:] + lengths[:k]:
            out += [(seed, seconds, side) for side in sides]
    return out


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="gba-512-cg")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, nargs="+", default=[20.0])
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--parent", type=Path, help="a copy of the parent commit")
    ap.add_argument("--card", action="store_true",
                    help="sample the card's clock and power beside each run")
    ap.add_argument("--metric", default="gba_solve_s")
    ap.add_argument("--timeout", type=float, default=360.0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    sides = [("change", CHECKOUT, True)]
    if args.parent is not None:
        parent = ("parent", args.parent.resolve(), False)
        sides = [parent, sides[0], sides[0], parent]
    several = len(args.seconds) > 1
    rows, labels = [], {}
    out = args.out.open("a") if args.out else None
    try:
        for seed, seconds, (side, checkout, detail) in schedule(args.seeds, args.seconds,
                                                                 sides):
            label = f"{side}@{seconds:g}s" if several else side
            labels[label] = None
            r = row(label, seed, run_once(checkout, args.workload, seed, seconds, args.trace,
                                          detail, args.card, args.timeout), args.metric)
            rows.append(r)
            g, c = r["gba"] or {}, r["card"] or {}
            print(" ".join(f"{k}={_fmt(v)}" for k, v in [
                ("side", label), ("seed", seed), ("rc", r["rc"]),
                ("correct", r["correct"]), ("reading", r["reading"]),
                ("setup_s", r["setup_s"]), ("peak", r["memory_peak_bytes"]),
                ("n", g.get("n")), ("q1", g.get("q1")), ("med", g.get("median")),
                ("q3", g.get("q3")), ("first10", g.get("first_tenth")),
                ("last10", g.get("last_tenth")), ("max", g.get("max")),
                ("segments", r["new_segments"]), ("sm_mhz", c.get("sm_mhz")),
                ("power_w", c.get("power_w"))]), flush=True)
            if r["stderr_tail"]:
                print(r["stderr_tail"], file=sys.stderr, flush=True)
            if out:
                out.write(json.dumps(r) + "\n")
                out.flush()
        for label in labels:
            s = summary(rows, label)
            print(json.dumps(s), flush=True)
            if out:
                out.write(json.dumps({"summary": s}) + "\n")
    finally:
        if out:
            out.close()
    bad = [r for r in rows if r["rc"] != 0 or r["correct"] is not True]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
