"""Structured per-frame metrics (observability subsystem).

The reference's observability is cout prints + the Pangolin overlay
(SURVEY.md §5); here every tracked frame appends a structured record
(System.metrics) that can be dumped as JSONL for dashboards and debugging,
one-off engine events go to an in-process log, and `span`s time the
program's phases, recorded with their nesting while `recording()` is on.
"""
from __future__ import annotations

import contextlib
import functools
import json
import threading
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import NamedTuple


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


class SpanRecord(NamedTuple):
    """One recorded span: times on time.perf_counter(), `parent` the index in
    the same record list of the innermost span open on the same thread when
    this one opened (-1: none recorded), `end_s` None while it is still
    open."""

    name: str
    start_s: float
    end_s: float | None
    parent: int
    # threading.get_ident() of the thread that opened it: the pthread handle,
    # by which the CUDA profiler's launch records name their thread
    thread: int


_records: list | None = None  # the list being recorded into, None while off
_record_lock = threading.Lock()
_local = threading.local()  # per thread: open recorded spans, caller name


class span:
    """`with span(name) as s:` times its block on time.perf_counter() into
    `s.elapsed_ms` (and `s.t0`, `s.t1`), always. While `recording()` is on
    it also appends a SpanRecord to the recording's list; spans nest per
    thread. Off, a span costs this object, two clock reads and a test.
    time.perf_counter() is also the clock the benchmark maps the card's
    operations onto (benchmark/trace.py), so spans and a device trace line
    up."""

    __slots__ = ("name", "t0", "t1", "elapsed_ms", "_buf", "_idx")

    def __init__(self, name: str):
        self.name = name
        self.elapsed_ms = 0.0

    def __enter__(self):
        self._buf = buf = _records
        self.t0 = time.perf_counter()
        if buf is not None:
            self._open(buf)
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        self.elapsed_ms = (self.t1 - self.t0) * 1e3
        if self._buf is not None:
            self._close()
        return False

    def _open(self, buf: list) -> None:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        top = stack[-1] if stack else None
        parent = top._idx if top is not None and top._buf is buf else -1
        with _record_lock:
            self._idx = len(buf)
            buf.append(SpanRecord(self.name, self.t0, None, parent,
                                  threading.get_ident()))
        stack.append(self)

    def _close(self) -> None:
        _local.stack.pop()
        self._buf[self._idx] = self._buf[self._idx]._replace(end_s=self.t1)


class caller_span(span):
    """A span whose name is also this thread's `current_caller()` inside it
    (ops/cuda_kernels.launches_counted_as counts hand-kernel launches by
    it)."""

    __slots__ = ("_prev",)

    def __enter__(self):
        self._prev = getattr(_local, "caller", None)
        _local.caller = self.name
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        _local.caller = self._prev
        return False


def spanned(name: str):
    """Decorator: each call of the function is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def current_caller(default: str | None = None) -> str | None:
    """The name of the innermost caller_span open on this thread."""
    return getattr(_local, "caller", None) or default


@contextlib.contextmanager
def recording():
    """Record every thread's spans while the block runs: `with recording()
    as records:` gives the list of SpanRecords, in the order the spans
    opened. One recording at a time."""
    global _records
    with _record_lock:
        if _records is not None:
            raise RuntimeError("spans are already being recorded")
        _records = records = []
    try:
        yield records
    finally:
        _records = None
