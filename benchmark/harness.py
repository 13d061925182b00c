"""What every cell's run shares: finding the cell's files by name, the
checks against their limits, the metric readers, and the result line.

A cell of BENCHMARK.json names a configuration and a traffic mix; the
harness finds

- the configuration in configs/<config>.json, which names the generator
  of its inputs (gen/<generator>.py, a module with
  `make(config, seed, device) -> dict`),
- the traffic mix in traffic/<traffic>.json, which names its driver
  (drivers/<driver>.py, a module with `run(ctx) -> Run`),
- the limits of the numbers that decide `correct` in limits/<workload>.json,
- each metric's reader in metrics/<metric>.py (a module with
  `read(run) -> float | None`; None: nothing to read in this run, and the
  metric is left out of the line),

so that a later cell adds files and edits none.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SPEC = ROOT.parent / "BENCHMARK.json"
# top-level module names that may not be loaded in the process that prints
# the result: JAX, its companions, and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "orbslam2_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, spec: dict | None = None) -> dict:
    """The workload entry `name` of BENCHMARK.json."""
    spec = load_json(SPEC) if spec is None else spec
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in {SPEC.name}")


def config(name: str) -> dict:
    return load_json(ROOT / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(ROOT / "traffic" / f"{name}.json")


def limits(workload: str) -> dict:
    """{number: {"at_most" or "at_least": limit}} of the cell."""
    return load_json(ROOT / "limits" / f"{workload}.json")["checks"]


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def _by_path(folder: str, name: str):
    path = ROOT / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(name: str):
    """The module gen/<name>.py."""
    return _by_path("gen", name)


def reader(metric: str):
    """The module metrics/<metric>.py (metric names hold dots, so the file
    is loaded by path)."""
    return _by_path("metrics", metric)


def metrics_of(workload: str, trace: bool, spec: dict | None = None) -> list[dict]:
    """The metric entries a run of `workload` reports: its end-to-end ones
    (trace off) or its per-layer ones (trace on). An entry without
    `workloads` belongs to every cell that reports the metric it moves."""
    spec = load_json(SPEC) if spec is None else spec

    def mine(m):
        return workload in m["workloads"] if "workloads" in m else None

    e2e = [m for m in spec["end_to_end"] if mine(m) in (True, None)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if mine(m) or (mine(m) is None and m["moves"] in moved)]


@dataclass
class Check:
    """A number compared, beside its limit: rel is "at_most" or "at_least"."""

    name: str
    value: float
    rel: str
    limit: float | None

    @property
    def ok(self) -> bool:
        if self.limit is None or self.value != self.value:  # no limit, or NaN
            return False
        return self.value <= self.limit if self.rel == "at_most" else self.value >= self.limit


def checks(values: dict, workload: str) -> list[Check]:
    """Each compared number beside its limit from limits/<workload>.json."""
    lim = limits(workload)
    out = []
    for name, v in values.items():
        ((rel, limit),) = lim[name].items()
        out.append(Check(name, float(v), rel, limit))
    return out


@dataclass
class Run:
    """What a driver hands back: the counts, the numbers compared, and what
    the metric readers read (spans, counters, the trace)."""

    setup_s: float
    window_s: float
    attempted: int
    failed: int
    values: dict                       # number compared -> reading
    memory_peak_bytes: int
    chips: int
    data: dict = field(default_factory=dict)
    trace: object = None               # trace.Trace of the traced slice
    errors: list = field(default_factory=list)


def forbidden_modules() -> list[str]:
    """FORBIDDEN top-level names present in sys.modules (compared whole)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
