"""Each metric reader on a made-up run and trace, and the trace reductions."""
import pytest

from benchmark import harness as H
from benchmark import trace as TR


def made_up_trace():
    # a 1 s slice: kernels 0.1-0.3, 0.2-0.45 (overlapping), a copy 0.6-0.7
    ops = [("k1", 0.1, 0.3), ("k2", 0.2, 0.45), ("Memcpy HtoD", 0.6, 0.7)]
    return TR.Trace(0.0, 1.0, ops)


def run_with(**data):
    run = H.Run(setup_s=12.5, window_s=10.0, attempted=4, failed=1, values={},
                memory_peak_bytes=0, chips=1, trace=data.pop("trace", None))
    run.data.update(data)
    return run


def test_trace_reductions():
    t = made_up_trace()
    assert TR.busy_s(t.ops, t.t0, t.t1) == pytest.approx(0.45)
    assert TR.idle_gaps(t.ops, 0.0, 1.0) == [(0.0, 0.1), pytest.approx((0.45, 0.6)),
                                             pytest.approx((0.7, 1.0))]
    assert [n for n, _ in TR.top_ops(t.ops)] == ["k2", "k1", "Memcpy HtoD"]
    assert len(t.kernels()) == 2


def test_gba_readers():
    run = run_with(gba_s=[1.0, 3.0], work=(3.35e12, 0), trace=made_up_trace())
    assert H.reader("gba_solve_s").read(run) == pytest.approx(2.0)
    assert H.reader("kernels_per_gba.gba").read(run) == 2
    assert H.reader("device_idle.gba").read(run) == pytest.approx(55.0)
    assert H.reader("gba_roofline.gba").read(run) == pytest.approx(50.0)
    assert H.reader("setup_s").read(run) == 12.5


def test_an_outlier_gba_moves_the_mean_and_the_roofline_and_not_the_median():
    run = run_with(gba_s=[1.0] * 9 + [11.0], work=(3.35e12, 0), trace=made_up_trace())
    assert H.reader("gba_solve_s").read(run) == pytest.approx(2.0)
    assert H.reader("gba_roofline.gba").read(run) == pytest.approx(50.0)
    assert H.reader("gba_median_s.gba").read(run) == pytest.approx(1.0)
    assert H.reader("gba_median_s.gba").read(run_with(gba_s=[1.0, 3.0])) == pytest.approx(2.0)


def test_readers_with_nothing_to_read_return_none():
    run = run_with()
    for name in ("gba_solve_s", "kernels_per_gba.gba", "device_idle.gba", "gba_roofline.gba",
                 "gba_median_s.gba"):
        assert H.reader(name).read(run) is None, name


SPAN_READERS = {"pcg_device_s.gba": 0.16, "edge_device_s.gba": 0.09,
                "assemble_device_s.gba": 0.06}


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_readers_read_the_program_spans_of_the_traced_gba(name):
    from test_benchmark_spans import RECORDS, made_up

    assert H.reader(name).read(run_with(trace=made_up())) is None
    assert H.reader(name).read(run_with(program_spans=RECORDS)) is None
    assert H.reader(name).read(run_with(trace=made_up_trace(), program_spans=RECORDS)) is None
    got = H.reader(name).read(run_with(trace=made_up(), program_spans=RECORDS))
    assert got == pytest.approx(SPAN_READERS[name])
