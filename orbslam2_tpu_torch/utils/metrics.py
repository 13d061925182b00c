"""Structured per-frame metrics (observability subsystem).

The reference's observability is cout prints + the Pangolin overlay
(SURVEY.md §5); here every tracked frame appends a structured record
(System.metrics) that can be dumped as JSONL for dashboards and debugging,
and one-off engine events go to an in-process log.
"""
from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path


@dataclass
class FrameMetrics:
    frame_id: int
    timestamp: float
    state: str
    inliers: int
    keyframes: int
    points: int
    loops: int
    track_ms: float
    created_keyframe: bool = False


@dataclass
class MetricsLog:
    records: list = field(default_factory=list)

    def append(self, **kw):
        self.records.append(FrameMetrics(**kw))

    def dump_jsonl(self, path):
        with Path(path).open("w") as f:
            for r in self.records:
                f.write(json.dumps(asdict(r)) + "\n")

    def summary(self) -> dict:
        if not self.records:
            return {}
        ok = [r for r in self.records if r.state == "OK"]
        tms = sorted(r.track_ms for r in self.records)
        return {
            "frames": len(self.records),
            "tracked": len(ok),
            "keyframes_final": self.records[-1].keyframes,
            "points_final": self.records[-1].points,
            "loops": self.records[-1].loops,
            "median_track_ms": tms[len(tms) // 2],
            "mean_inliers": (sum(r.inliers for r in ok) / max(len(ok), 1)),
        }


_EVENT_LOG: list = []


def log_event(kind: str, **fields):
    """Record a structured one-off engine event (coverage losses, aborts,
    capacity warnings). Kept in-process; drain with `drain_events()`."""
    _EVENT_LOG.append({"kind": kind, "t": time.time(), **fields})
    if len(_EVENT_LOG) > 10000:
        del _EVENT_LOG[:5000]


def drain_events() -> list:
    out = list(_EVENT_LOG)
    _EVENT_LOG.clear()
    return out


class Timer:
    """Context timer for host-side stage profiling."""

    def __init__(self):
        self.t0 = None
        self.elapsed_ms = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.elapsed_ms = (time.perf_counter() - self.t0) * 1e3
        return False
