"""The port's kernel profiler (orbslam2_tpu_torch/utils/profile_kernels.py),
on the CPU: each row's byte and operation counts at stated shapes against
numbers worked by hand, the bound's arithmetic (utils/cuda_timing.bound),
every row's problem built and called once at the cut size through the plain
versions, and main() refusing to run without a CUDA device."""
import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.config import OrbParams
from orbslam2_tpu_torch.utils import cuda_timing as T
from orbslam2_tpu_torch.utils import profile_kernels as PK

N_ROWS = 11  # the JAX script's 8 rows and the three hand kernels'


def test_hamming_matrix_counts():
    # both [1024, 8] uint32 descriptor sets read, the int32 matrix written;
    # 64 x 128 tiles of 16 x 8, two mma each
    assert PK.hamming_matrix_counts(1024, 1024) == (2 * 1024 * 32 + 1024 * 1024 * 4,
                                                    2 * 64 * 128)
    # ragged: 1000 rows are 63 tiles of 16, 777 columns 98 tiles of 8
    assert PK.hamming_matrix_counts(1000, 777) == (4 * 1000 * 777 + 32 * 1777, 2 * 63 * 98)


def test_hamming_best2_counts_follow_the_mask():
    A, B = 32, 64
    base = A * B + 32 * (A + B) + 12 * A  # the mask, the descriptors, 3 int32 a row
    full = torch.ones((A, B), dtype=torch.bool)
    assert PK.hamming_best2_counts(full) == (base, 16 * 2)   # two 16x64 chunks
    one = torch.zeros((A, B), dtype=torch.bool)
    one[20, 3] = True
    assert PK.hamming_best2_counts(one) == (base, 16)        # the second chunk only
    assert PK.hamming_best2_counts(torch.zeros((A, B), dtype=torch.bool)) == (base, 0)
    # 4096 x 1024 at 1%: every chunk holds a candidate
    cand = torch.from_numpy(np.random.default_rng(0).random((4096, 1024)) < 0.01)
    assert PK.hamming_best2_counts(cand)[1] == 16 * 256 * 16


def test_seg_sum_counts():
    # local Hcc: 8192 rows of 36 floats and their plan index, 17 offsets, 16 sums
    assert PK.seg_sum_counts(8192, 36, 16, 4) == (
        8192 * (36 * 4 + 4) + 4 * 17 + 16 * 36 * 4, 8192 * 36)
    assert PK.seg_sum_counts(0, 18, 1000, 8) == (4 * 1001 + 1000 * 18 * 8, 0)


def test_extract_orb_counts():
    params = OrbParams()
    n_bytes, flop = PK.extract_orb_counts(480, 640, params)
    # the float32 frame read, 1024 rows of 953 bytes written (xy 8, response,
    # angle, octave 4 each, descriptor 32, valid 1, a 15x15 float32 patch)
    assert n_bytes == 4 * 480 * 640 + 1024 * 953
    levels = [(480, 640), (400, 533), (333, 444), (278, 370), (231, 309), (193, 257),
              (161, 214), (134, 179)]
    pixels = sum(h * w for h, w in levels)
    assert flop == 92 * pixels + 6940 * 1024


def test_pose_optimize_and_refine_counts():
    # pose 48 + per observation 12 + 12 + 1 + 4 + 1 read; pose, inliers, count written
    assert PK.pose_optimize_counts(1024) == (
        48 + 1024 * 30 + 48 + 1024 + 8, 1024 * (40 * (90 + 40 + 126 + 36) + 4 * 45))
    # 15x15 and 11x11 float32 windows and a flag read, a float2 and a flag written
    n_bytes, flop = PK.refine_offsets_counts(1)
    assert n_bytes == 900 + 484 + 1 + 9
    sample = 2 * 8 * (165 + 121)
    assert flop == 12 * 121 + 8 * (sample + 8 * 121) + 2 * (sample + 5 * 121)


def tiny_ba_problem() -> dict:
    """Two cameras (the first fixed), one point, a mono and a stereo edge."""
    return dict(cam_T=np.zeros((2, 3, 4), np.float32), cam_fixed=np.array([True, False]),
                cam_valid=np.ones(2, bool), pts=np.zeros((1, 3), np.float32),
                pt_valid=np.ones(1, bool), e_cam=np.array([0, 1], np.int32),
                e_pt=np.array([0, 0], np.int32), e_obs=np.zeros((2, 3), np.float32),
                e_stereo=np.array([False, True]), e_info=np.ones(2, np.float32),
                e_valid=np.ones(2, bool))


def test_ba_counts():
    arrays = tiny_ba_problem()
    # C = 2: pose 48, two flags; P = 1: 12 and a flag; E = 2: two int64
    # indices, 12 of observation, a flag, 4 of information, a flag; written:
    # the poses, the point, the inlier flags and the cost
    n_bytes = 2 * 50 + 13 + 2 * 34 + 2 * 48 + 12 + 2 + 4
    # per LM iteration: 5 residual rows of 144, two cost evaluations of 45
    # per edge, a 3x3 inverse of 40
    common = 144 * 5 + 2 * 45 * 2 + 40
    # dense: 2 (point, camera) pairs of 108, the point's 3 camera pairs of 216,
    # the free camera's 6x6 Cholesky and two triangular solves
    dense = common + 108 * 2 + 216 * 3 + 6 ** 3 // 3 + 2 * 6 ** 2
    assert PK.ba_counts(arrays, dense=True) == (n_bytes, 15 * dense)
    # CG: 24 steps of 72 an edge, 18 a point, 144 a camera
    assert PK.ba_counts(arrays, dense=False) == (n_bytes, 15 * (common + 24 * (144 + 18 + 288)))


def test_bound_takes_the_larger_time():
    b = T.bound(3_350_000_000, 67e9, T.FP32_OPS_PER_S)
    assert b["bound_bytes_ms"] == pytest.approx(1.0)
    assert b["bound_ops_ms"] == pytest.approx(1.0)
    b = T.bound(3_350_000, 67e12, T.FP32_OPS_PER_S)
    assert b["bound_by"] == "operations" and b["bound_ms"] == pytest.approx(1000.0)
    b = T.bound(2 * 3_350_000_000, 1e6, 1e9)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == pytest.approx(2.0)


@pytest.fixture(scope="module")
def cut_rows():
    torch.manual_seed(0)
    return PK.rows("cpu", "cut")


def test_every_row_is_there(cut_rows):
    names = [r.name.split(" ")[0] for r in cut_rows]
    assert names == ["extract_orb", "hamming_matrix", "pose_optimize", "refine_offsets",
                     "ba_solve[cg]", "ba_solve[dense]", "ba_solve[cg]", "ba_solve[dense]",
                     "hamming_best2", "bow_assign", "seg_sum"]
    assert len(cut_rows) == N_ROWS
    assert [r.mma for r in cut_rows] == [False, True] + [False] * 6 + [True, False, False]


def _finite(out) -> bool:
    """A tensor or a tuple of tensors, every float in it finite."""
    tensors = [out] if isinstance(out, torch.Tensor) else list(out)
    return bool(tensors) and all(bool(torch.isfinite(t).all()) for t in tensors
                                 if t.is_floating_point())


@pytest.mark.parametrize("i", range(N_ROWS))
def test_row_runs_on_the_plain_versions(cut_rows, i):
    row = cut_rows[i]
    assert row.n_bytes > 0 and row.n_ops > 0 and row.reps >= 1
    assert _finite(row.call())
    assert _finite(row.call())  # a chained row takes its own last output


def test_main_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert PK.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err

