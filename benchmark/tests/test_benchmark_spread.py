"""benchmark/spread.py's arithmetic and schedule on made-up readings, and the
window record it reads from a whole driver run on the CPU."""
import statistics

import pytest

from benchmark import harness as H
from benchmark import spread as SPR


def test_spread_is_the_quartile_distance_over_the_median():
    values = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert (q1, q3) == (2.0, 6.0)
    assert SPR.spread(values) == pytest.approx(4.0 / 4.0)
    assert SPR.spread([3.0, 3.0, 3.0]) == 0.0
    assert SPR.spread([1.0]) is None
    # without the run farthest from the median (7.0 away from 4.0 by 3)
    assert SPR.spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 100.0], drop_farthest=True) == \
        pytest.approx(SPR.spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]))


def test_sets_are_each_seeds_first_and_second_run():
    runs = [(1, 10.0), (1, 10.2), (2, 10.1), (2, 10.1), (3, 9.9), (3, 10.4),
            (4, 10.0), (4, 10.0), (5, 10.3), (5, 9.8)]
    got = SPR.sets_spread(runs)
    a, b = [10.0, 10.1, 9.9, 10.0, 10.3], [10.2, 10.1, 10.4, 10.0, 9.8]
    assert got["a"] == pytest.approx(SPR.spread(a, True))
    assert got["b"] == pytest.approx(SPR.spread(b, True))
    assert got["sets"] == pytest.approx((got["a"] + got["b"]) / 2)
    assert got["wider"] == pytest.approx(max(SPR.spread(a), SPR.spread(b)))
    assert got["all"] == pytest.approx(SPR.spread(a + b))
    assert got["median"] == pytest.approx(10.05)


def test_tenths_take_at_least_one_gba():
    times = [2.0] * 10 + [1.0] * 80 + [3.0] * 10
    assert SPR.tenths(times) == (2.0, 3.0)
    assert SPR.tenths([5.0, 1.0]) == (5.0, 1.0)
    assert SPR.tenths([]) is None


def test_decompose_between_and_within():
    # two runs, each scattered by +-1 about its own mean, the means 10 apart
    runs = [[9.0, 11.0, 9.0, 11.0], [19.0, 21.0, 19.0, 21.0]]
    got = SPR.decompose(runs)
    # sums of squares: between 8 * 25 = 200, within 8 * 1 = 8
    assert got["between"] == pytest.approx(200 / 208)
    assert got["within"] == pytest.approx(8 / 208)
    # within-run variance 8/6, over 4 GBAs a run, against the means' variance 50
    assert got["reading_within"] == pytest.approx((8 / 6 / 4) / 50)
    assert got["reading_between"] == pytest.approx(1 - (8 / 6 / 4) / 50)
    # means that agree: the within-run scatter is all there is
    same = SPR.decompose([[1.0, 3.0], [3.0, 1.0]])
    assert same["between"] == 0.0 and same["reading_within"] == 1.0
    assert SPR.decompose([[1.0, 2.0]]) is None


def test_gba_stats_show_an_outlier_in_the_mean_and_not_the_median():
    times = [0.1] * 19 + [0.5]
    got = SPR.gba_stats(times)
    assert got["median"] == pytest.approx(0.1) and got["max"] == 0.5
    assert got["mean"] == pytest.approx(0.12)
    assert got["mean_over_median"] == pytest.approx(0.2)
    assert got["first_tenth"] == pytest.approx(0.1) and got["last_tenth"] == pytest.approx(0.3)


def test_correlation_needs_three_pairs_that_vary():
    assert SPR.correlation([1, 2, 3], [2, 4, 6]) == pytest.approx(1.0)
    assert SPR.correlation([1, 2, 3], [5, 5, 5]) is None
    assert SPR.correlation([1, 2, None, 4], [1, 2, 3, None]) is None


def test_summary_of_made_up_rows():
    def made(seed, reading, times):
        return {"side": "change", "seed": seed, "correct": True, "failed": 0,
                "reading": reading, "setup_s": 9.0, "memory_peak_bytes": 7,
                "gba": SPR.gba_stats(times), "gba_s": times, "card": None}

    rows = [made(1, 1.0, [1.0, 1.0]), made(2, 1.1, [1.0, 1.2]),
            made(1, 1.0, [0.9, 1.1]), made(3, 1.2, [1.2, 1.2])]
    s = SPR.summary(rows, "change")
    assert s["runs"] == 4 and s["correct"] == 4
    assert s["seed"]["repeated_median"] == 1.0 and s["seed"]["distinct_median"] == 1.15
    assert s["memory_peak_bytes"] == [7, 7]
    assert 0.0 <= s["decompose"]["reading_within"] <= 1.0
    assert s["median_reading"]["median"] == pytest.approx(1.05)
    assert "clock_vs_reading" not in s


def test_schedule_rotates_the_lengths_and_keeps_each_lengths_sides_together():
    got = SPR.schedule([7, 8, 9], [10.0, 20.0], ["P", "C", "C", "P"])
    assert [(s, L) for s, L, _ in got[::4]] == [(7, 10.0), (7, 20.0), (8, 20.0), (8, 10.0),
                                               (9, 10.0), (9, 20.0)]
    assert [side for _, _, side in got[:4]] == ["P", "C", "C", "P"]
    assert SPR.schedule([1, 1], [10.0], ["C"]) == [(1, 10.0, "C"), (1, 10.0, "C")]


def test_the_driver_records_its_window_on_the_cpu(gba_ctx):
    run = H.driver("gba").run(gba_ctx(cameras=16, points=512, observations=4096,
                                      seconds=3.0))
    w = run.data["window"]
    assert run.attempted >= 1 and len(run.data["gba_s"]) == run.attempted
    assert w["wall"][1] - w["wall"][0] >= 3.0 and w["new_segments"] == 0
    assert len(w["gc_passes"]) == 3 and all(n >= 0 for n in w["gc_passes"])
