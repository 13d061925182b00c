"""utils/metrics.span and recording(): timing always, records only while
recording, nesting per thread; launches_counted_as as a span; and the BA
solver's spans, counted over one small CG solve whose outputs do not
change when recording is on."""
from __future__ import annotations

import collections
import threading
import time

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.ops import ba as BA
from orbslam2_tpu_torch.ops import cuda_kernels as CK
from orbslam2_tpu_torch.utils import metrics as M


def test_spans_nest_and_name_their_parents():
    with M.recording() as records:
        with M.span("a"):
            with M.span("b"):
                with M.span("c"):
                    pass
            with M.span("d"):
                pass
        with M.span("e"):
            pass
    assert [r.name for r in records] == ["a", "b", "c", "d", "e"]
    assert [r.parent for r in records] == [-1, 0, 1, 0, -1]
    for r in records:
        assert r.start_s <= r.end_s and r.thread == threading.get_ident()
    a, b, c, d, _ = records
    assert a.start_s <= b.start_s <= c.start_s <= c.end_s <= b.end_s <= d.start_s <= a.end_s


def test_threads_nest_on_their_own():
    barrier = threading.Barrier(2)

    def work(tag):
        with M.span(f"{tag}.outer"):
            barrier.wait()  # both outer spans are open together
            with M.span(f"{tag}.inner"):
                barrier.wait()

    with M.recording() as records:
        threads = [threading.Thread(target=work, args=(t,)) for t in "xy"]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    by_name = {r.name: (i, r) for i, r in enumerate(records)}
    assert set(by_name) == {"x.outer", "x.inner", "y.outer", "y.inner"}
    for tag in "xy":
        i_outer, outer = by_name[f"{tag}.outer"]
        _, inner = by_name[f"{tag}.inner"]
        assert outer.parent == -1 and inner.parent == i_outer
        assert inner.thread == outer.thread
    assert by_name["x.outer"][1].thread != by_name["y.outer"][1].thread


def test_nothing_is_recorded_outside_recording():
    with M.span("before"):
        pass
    with M.recording() as records:
        with M.span("during"):
            pass
    with M.span("after"):
        pass
    assert [r.name for r in records] == ["during"]
    with M.recording() as again:
        pass
    assert again == []
    with M.recording():
        with pytest.raises(RuntimeError):
            with M.recording():
                pass


@pytest.mark.parametrize("on", [False, True])
def test_elapsed_ms_is_measured_either_way(on):
    def timed():
        with M.span("sleep") as s:
            time.sleep(0.02)
        return s

    if on:
        with M.recording() as records:
            s = timed()
        assert records[0].end_s - records[0].start_s == pytest.approx(s.elapsed_ms / 1e3)
    else:
        s = timed()
    assert 15.0 <= s.elapsed_ms < 2000.0
    assert s.t1 - s.t0 == pytest.approx(s.elapsed_ms / 1e3)


def test_a_span_open_when_recording_stops_keeps_its_slot():
    with M.span("outer"):
        with M.recording() as records:
            with M.span("inner"):
                pass
            s = M.span("open").__enter__()
        s.__exit__(None, None, None)
    assert [r.name for r in records] == ["inner", "open"]
    assert records[0].parent == -1  # "outer" opened before recording
    assert records[1].end_s == s.t1


def test_spanned_decorates_a_function():
    @M.spanned("f")
    def f(x):
        with M.span("g"):
            return 2 * x

    with M.recording() as records:
        assert f(3) == 6
    assert [(r.name, r.parent) for r in records] == [("f", -1), ("g", 0)]
    assert f.__name__ == "f"


def test_launches_counted_as_opens_a_span(monkeypatch):
    counted = []
    # count through the wrapper's bookkeeping as a launch would, without a card
    monkeypatch.setattr(CK, "_launcher", lambda name: lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    CK.reset_launch_counts()
    with M.recording() as records:
        CK._launch(CK.seg_sum, "seg_sum", torch.device("cpu"))
        with CK.launches_counted_as("gba") as s:
            CK._launch(CK.seg_sum, "seg_sum", torch.device("cpu"))
            with CK.launches_counted_as("loop"):
                CK._launch(CK.seg_sum, "seg_sum", torch.device("cpu"))
            CK._launch(CK.seg_sum, "seg_sum", torch.device("cpu"))
            counted.append(M.current_caller())
        CK._launch(CK.seg_sum, "seg_sum", torch.device("cpu"))
    assert CK.seg_sum.launches == 5
    assert CK.seg_sum.launches_by == {"tracker": 2, "gba": 2, "loop": 1}
    assert counted == ["gba"] and M.current_caller("tracker") == "tracker"
    assert [(r.name, r.parent) for r in records] == [("gba", -1), ("loop", 0)]
    assert s.elapsed_ms > 0.0
    CK.reset_launch_counts()


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Stream:
    cuda_stream = 0


# the span counts of one CG ba_solve at iters1=1, iters2=2: 3 LM iterations,
# two classifications, 24 CG steps an iteration
SOLVE_SPANS = {"ba.solve": 1, "ba.plans": 1, "ba.lm": 3, "ba.edge_terms": 8,
               "ba.assemble": 3, "ba.pcg": 3, "ba.pcg.matvec": 72, "ba.apply": 3,
               "ba.classify": 2}
PARENTS = {"ba.solve": None, "ba.plans": "ba.solve", "ba.lm": "ba.solve",
           "ba.assemble": "ba.lm", "ba.pcg": "ba.lm", "ba.pcg.matvec": "ba.pcg",
           "ba.apply": "ba.lm", "ba.classify": "ba.solve"}


def test_a_cg_solve_gives_the_table_of_spans_and_the_same_bits():
    torch.set_num_threads(1)
    arrays, intr = BA.synthetic_problem(8, 256, 2048, seed=4)
    p = BA.problem_from_numpy(arrays, torch.device("cpu"))

    def solve():
        return BA.ba_solve(p, *intr, iters1=1, iters2=2, cg_iters=24, solver="cg")

    off = solve()
    with M.recording() as records:
        on = solve()
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    assert dict(collections.Counter(r.name for r in records)) == SOLVE_SPANS
    assert sum(SOLVE_SPANS.values()) == len(records) == 96
    names = [r.name for r in records]
    for r in records:
        parent = names[r.parent] if r.parent >= 0 else None
        if r.name == "ba.edge_terms":
            assert parent in ("ba.lm", "ba.apply", "ba.classify")
        else:
            assert parent == PARENTS[r.name], r
        assert r.end_s is not None
    # the trial cost's terms are inside ba.apply, one each
    assert sum(names[r.parent] == "ba.apply" for r in records
               if r.name == "ba.edge_terms") == 3
    assert np.all(np.diff([r.start_s for r in records]) >= 0)


def test_the_dense_solve_opens_dense_schur_in_place_of_pcg():
    arrays, intr = BA.synthetic_problem(6, 128, 512, seed=5)
    p = BA.problem_from_numpy(arrays, torch.device("cpu"))
    with M.recording() as records:
        BA.ba_solve(p, *intr, iters1=1, iters2=1, solver="dense")
    counts = collections.Counter(r.name for r in records)
    assert counts["ba.dense_schur"] == 2 and counts["ba.pcg"] == 0
    assert counts["ba.pcg.matvec"] == 0 and counts["ba.lm"] == 2


def test_the_gba_schedule_times_itself_by_its_spans():
    """GlobalBA's `gba` and `gba.chunk` spans: chunk_ms and solve_ms are
    their elapsed times; each chunk holds one ba.solve."""
    from orbslam2_tpu.config import SlamConfig as JConfig, Sensor as JSensor
    from orbslam2_tpu_torch.config import SlamConfig, Sensor
    from orbslam2_tpu_torch.global_ba import GlobalBA
    from test_torch_global_ba import build

    kw = dict(max_keyframes=32, max_points=1024)
    cfgs = (JConfig(sensor=JSensor.MONOCULAR, **kw), SlamConfig(sensor=Sensor.MONOCULAR, **kw))
    _, mp, _, _, _ = build(cfgs)
    gba = GlobalBA(cfgs[1], mp, device="cpu")
    with M.recording() as records:
        gba.launch(fixed_kf=0, chunks=3, background=False)
    names = [r.name for r in records]
    counts = collections.Counter(names)
    assert counts["gba"] == 1 and counts["gba.chunk"] == 3 and counts["ba.solve"] == 3
    whole = names.index("gba")
    chunks = [r for r in records if r.name == "gba.chunk"]
    assert all(r.parent == whole for r in chunks)
    assert all(names[r.parent] == "gba.chunk" for r in records if r.name == "ba.solve")
    assert gba.chunk_ms == pytest.approx([1e3 * (r.end_s - r.start_s) for r in chunks])
    g = records[whole]
    assert gba.solve_ms == pytest.approx([1e3 * (g.end_s - g.start_s)])


def test_many_threads_record_at_once():
    """More threads than cores, switching often: every span is recorded
    once, closed, and under its own thread's parent."""
    import sys

    n_threads, n_outer = 16, 40

    def work(tag):
        for _ in range(n_outer):
            with M.span(f"{tag}.outer"):
                with M.span(f"{tag}.inner"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with M.recording() as records:
            threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(records) == 2 * n_threads * n_outer
    for r in records:
        assert r.end_s is not None
        if r.name.endswith(".inner"):
            parent = records[r.parent]
            assert parent.name == r.name.replace("inner", "outer")
            assert parent.thread == r.thread
            assert parent.start_s <= r.start_s <= r.end_s <= parent.end_s
        else:
            assert r.parent == -1
