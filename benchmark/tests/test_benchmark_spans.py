"""benchmark/spans.py on a made-up trace: launches on two threads, the
program's nested spans, an operation with no launch record and one launched
after every span closed; then the metrics it computes, and None where a run
has nothing to read."""
import threading

import pytest

from benchmark import harness as H
from benchmark import spans as SP
from benchmark import trace as TR
from orbslam2_tpu_torch.utils.metrics import SpanRecord

# two pthread handles and the keys the profiler gives them (read on the H100)
A, B = 140099435598592, 140083501987520
KEY_A, KEY_B = 1897370368, -1151338816

RECORDS = [SpanRecord("ba.solve", 0.0, 1.0, -1, A),
           SpanRecord("ba.lm", 0.1, 0.9, 0, A),
           SpanRecord("ba.edge_terms", 0.1, 0.2, 1, A),
           SpanRecord("ba.assemble", 0.2, 0.3, 1, A),
           SpanRecord("ba.pcg", 0.3, 0.7, 1, A),
           SpanRecord("ba.pcg.matvec", 0.3, 0.4, 4, A),
           SpanRecord("ba.pcg.matvec", 0.4, 0.5, 4, A),
           SpanRecord("other", 0.01, 0.95, -1, B)]

# (name, start, end, correlation id, launch (thread key, host s) or None)
OPS = [("k_edge", 0.16, 0.25, 1, (KEY_A, 0.15)),
       ("k_asm", 0.26, 0.32, 2, (KEY_A, 0.25)),
       ("k_mv", 0.40, 0.45, 3, (KEY_A, 0.35)),
       ("Memcpy DtoD", 0.46, 0.47, 4, (KEY_A, 0.45)),
       ("k_mv", 0.50, 0.55, 5, (KEY_A, 0.48)),
       ("k_pcg", 0.60, 0.65, 6, (KEY_A, 0.60)),
       ("k_other", 0.70, 0.80, 7, (KEY_B, 0.50)),
       ("k_lost", 0.85, 0.90, 8, None),
       ("k_late", 1.05, 1.10, 9, (KEY_A, 1.05))]
OWNERS = ["ba.edge_terms", "ba.assemble", "ba.pcg.matvec", "ba.pcg.matvec",
          "ba.pcg.matvec", "ba.pcg", "other", SP.NONE, SP.NONE]


def made_up():
    launches = {c: l for _, _, _, c, l in OPS if l is not None}
    return SP.SpanTrace(0.0, 1.2, [op[:3] for op in OPS], [op[3] for op in OPS], launches)


def run_with(trace=None, records=None):
    run = H.Run(setup_s=1.0, window_s=10.0, attempted=1, failed=0, values={},
                memory_peak_bytes=0, chips=1, trace=trace)
    if records is not None:
        run.data["program_spans"] = records
    return run


def test_thread_keys_are_the_profilers():
    assert SP.thread_key(A) == KEY_A and SP.thread_key(B) == KEY_B
    assert SP.thread_key(threading.get_ident()) == SP.thread_key(threading.get_ident())


def test_each_operation_goes_to_the_innermost_span_of_its_launching_thread():
    owner = SP.attribute_ops(made_up(), RECORDS)
    assert [RECORDS[i].name if i >= 0 else SP.NONE for i in owner] == OWNERS
    assert owner[2] == 5 and owner[3] == owner[4] == 6  # the first and second CG step


def test_each_gap_goes_to_the_innermost_span_open_at_its_middle():
    gaps = SP.attribute_gaps(made_up(), RECORDS)
    got = [(RECORDS[i].name if i >= 0 else SP.NONE, s) for i, s in gaps]
    # the first gap's middle (0.08) is inside ba.solve and, opened later, "other"
    want = [("other", 0.16), ("ba.assemble", 0.01), ("ba.pcg.matvec", 0.08),
            ("ba.pcg.matvec", 0.01), ("ba.pcg.matvec", 0.03), ("ba.pcg", 0.05),
            ("ba.pcg", 0.05), ("ba.lm", 0.05), ("ba.solve", 0.15), (SP.NONE, 0.1)]
    assert [n for n, _ in got] == [n for n, _ in want]
    assert [s for _, s in got] == pytest.approx([s for _, s in want])
    t = made_up()
    assert sum(s for _, s in gaps) == pytest.approx(t.window_s - TR.busy_s(t.ops, t.t0, t.t1))


def test_the_breakdown_by_span():
    rows = SP.by_span(made_up(), RECORDS)
    want = {"ba.pcg.matvec": (0.11, 2, 0.12), "other": (0.10, 1, 0.16),
            SP.NONE: (0.10, 2, 0.10), "ba.edge_terms": (0.09, 1, 0.0),
            "ba.assemble": (0.06, 1, 0.01), "ba.pcg": (0.05, 1, 0.10),
            "ba.lm": (0.0, 0, 0.05), "ba.solve": (0.0, 0, 0.15)}
    assert set(rows) == set(want)
    for name, (s, k, idle) in want.items():
        assert rows[name]["device_s"] == pytest.approx(s), name
        assert rows[name]["kernels"] == k, name
        assert rows[name]["idle_s"] == pytest.approx(idle), name
    assert list(rows)[0] == "ba.pcg.matvec"


def test_the_metrics_on_the_made_up_trace():
    run = run_with(made_up(), RECORDS)
    assert SP.metric("pcg_device_s.gba", run) == pytest.approx(0.16)
    assert SP.metric("edge_device_s.gba", run) == pytest.approx(0.09)
    assert SP.metric("assemble_device_s.gba", run) == pytest.approx(0.06)
    assert SP.metric("kernels_per_cg_step.gba", run) == pytest.approx(1.5)


@pytest.mark.parametrize("name", sorted(SP.METRICS))
def test_a_run_with_nothing_to_read_gives_none(name):
    assert SP.metric(name, run_with()) is None
    assert SP.metric(name, run_with(made_up())) is None
    assert SP.metric(name, run_with(records=RECORDS)) is None
    plain = TR.Trace(0.0, 1.2, [op[:3] for op in OPS])  # trace.capture's, no launches
    assert SP.metric(name, run_with(plain, RECORDS)) is None


def test_an_open_span_holds_to_the_end():
    records = RECORDS[:1] + [SpanRecord("ba.lm", 0.1, None, 0, A)]
    owner = SP.attribute_ops(made_up(), records)
    assert [records[i].name if i >= 0 else SP.NONE for i in owner][-1] == "ba.lm"


def test_capture_links_every_operation_to_its_launch(card):
    import torch

    from orbslam2_tpu_torch.utils import metrics as M

    x = torch.ones(1 << 16, device=card)

    def work():
        with M.span("outer"):
            y = x * 2
            with M.span("inner"):
                return (y + 1).sum()

    work()
    torch.cuda.synchronize()
    with M.recording() as records:
        _, trace = SP.capture(work)
    assert trace.ops and all(c in trace.launches for c in trace.corr)
    owner = SP.attribute_ops(trace, records)
    assert {records[i].name for i in owner if i >= 0} == {"outer", "inner"}
    assert -1 not in owner


def test_the_traced_line_carries_the_span_metrics_and_breakdown():
    from benchmark import run as R

    run = run_with(made_up(), RECORDS)
    run.data.update(gba_s=[1.0, 2.0], work=(3.35e12, 0))
    _, line = R.result(run, H.cell("gba-512-cg"), True, "NVIDIA H100 80GB HBM3")
    for name in ("pcg_device_s.gba", "edge_device_s.gba", "assemble_device_s.gba"):
        assert line["metrics"][name]["value"] == pytest.approx(SP.metric(name, run)), name
    assert "kernels_per_cg_step.gba" not in line["metrics"]
    bd = line["breakdown"]
    rows = SP.by_span(made_up(), RECORDS)
    assert bd["spans"] == [[n, r["device_s"]] for n, r in rows.items()][:10]
    assert bd["idle_gaps"][0] == ["other", pytest.approx(0.16)]
    assert len(bd["idle_gaps"]) == 10 and len(bd["device_ops"]) <= 10
    assert line["device"]["busy_s"] <= line["device"]["window_s"]
