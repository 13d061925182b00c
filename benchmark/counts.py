"""Operations and bytes of the work, from shapes alone, and the chip's peaks.

Frozen from the port's kernel profiler (orbslam2_tpu_torch/utils/
profile_kernels.py: `ba_counts`, `seg_sum_counts` and their constants) and
its timing module (utils/cuda_timing.py: the published H100 peaks), so that
a roofline share means the same work in every later check, whatever
implements it.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, at the full 700 W power limit
FP32_FLOP_PER_S = 67e12     # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

PROJECT_FLOP = 45                              # project, residual, chi2, weight
BA_ROW_FLOP = 36 + 2 * (21 + 6 + 18 + 6 + 3)   # Jacobian row and its block sums


def ba_counts(C: int, P: int, E: int, n_valid: int, stereo_rows: int,
              iters: int, cg_iters: int) -> tuple[int, int]:
    """(bytes, FLOP) of one CG `ba_solve` of `iters` LM iterations on a
    problem of C cameras, P points and E edges, n_valid of them valid and
    stereo_rows of those stereo: every field read once (edge indices as
    int64), poses, points, inlier flags and cost written; per LM iteration,
    per residual row of a valid edge (2, stereo 3) its Jacobian and its share
    of the Hcc, Hpp, coupling and gradient blocks, per valid edge the
    residual at the pose and at the trial step, per point its 3x3 inverse,
    and per CG step the matvec (two 6x3 products an edge, Hpp^-1 a point,
    Hcc and the preconditioner a camera)."""
    n_bytes = (C * (48 + 1 + 1) + P * (12 + 1) + E * (8 + 8 + 12 + 1 + 4 + 1)
               + C * 48 + P * 12 + E + 4)
    rows = 2 * n_valid + stereo_rows
    per_iter = (BA_ROW_FLOP * rows + 2 * PROJECT_FLOP * n_valid + 40 * P
                + cg_iters * (72 * E + 18 * P + 144 * C))
    return n_bytes, iters * per_iter


def seg_sum_counts(rows: int, d: int, n: int, elem: int) -> tuple[int, int]:
    """(bytes, adds) of a segment sum of `rows` rows of d elements of `elem`
    bytes into n segments: the rows and the plan (a 4-byte row index each,
    n + 1 offsets) read, the sums written; one add an element."""
    return rows * (d * elem + 4) + 4 * (n + 1) + n * d * elem, rows * d


def least_seconds(n_bytes: int, n_flop: int) -> float:
    """The least time one card could take: the larger of the operations
    over the float32 peak and the bytes over the memory bandwidth."""
    return max(n_flop / FP32_FLOP_PER_S, n_bytes / HBM_BYTES_PER_S)
