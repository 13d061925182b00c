"""The counts arithmetic, by hand and against the port's own counts."""
import numpy as np
import pytest

from benchmark import counts as CT
from benchmark.gen import ba_problem as GEN
from test_benchmark_gen import cut_config


def test_seg_sum_counts_by_hand():
    # 8192 rows of 36 float32 into 16 segments
    assert CT.seg_sum_counts(8192, 36, 16, 4) == (8192 * 148 + 68 + 16 * 144, 8192 * 36)


def test_ba_counts_by_hand():
    n_bytes, flop = CT.ba_counts(C=2, P=3, E=4, n_valid=4, stereo_rows=1, iters=1, cg_iters=1)
    assert n_bytes == 2 * 50 + 3 * 13 + 4 * 34 + 2 * 48 + 3 * 12 + 4 + 4
    assert flop == CT.BA_ROW_FLOP * 9 + 2 * CT.PROJECT_FLOP * 4 + 40 * 3 + (72 * 4 + 18 * 3 + 144 * 2)


def test_ba_counts_equal_the_ports():
    from orbslam2_tpu_torch.utils import profile_kernels as PK

    p = GEN.make(cut_config(16, 512, 4096), 3, "cpu")
    arrays = {k: p[k].numpy() for k in GEN.FIELDS}
    valid = arrays["e_valid"]
    ours = CT.ba_counts(16, 512, 4096, int(valid.sum()),
                        int((arrays["e_stereo"] & valid).sum()), iters=15, cg_iters=24)
    assert ours == PK.ba_counts(arrays, dense=False, iters=15, cg_iters=24)
    assert CT.seg_sum_counts(100, 6, 7, 4) == PK.seg_sum_counts(100, 6, 7, 4)


def test_least_seconds_takes_the_larger_bound():
    assert CT.least_seconds(3.35e12, 1.0) == pytest.approx(1.0)
    assert CT.least_seconds(1, 67e12) == pytest.approx(1.0)
