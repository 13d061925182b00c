"""Structured per-frame metrics (observability subsystem).

The reference's observability is cout prints + the Pangolin overlay
(SURVEY.md §5); here every tracked frame appends a structured record
(System.metrics), and one-off engine events go to an in-process log.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


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
