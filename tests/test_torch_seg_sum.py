"""The order-fixed segment sum (ops/cuda_kernels.py `seg_sum`, csrc/seg_sum.cu)
that assembles the port's BA and pose-graph normal equations, against
`jax.ops.segment_sum`, and the repeatability it buys.

Tolerances:
- `seg_sum_ref` against `jax.ops.segment_sum`: the two add a segment's rows
  in orders of their own, so each output may differ by the float32
  reordering bound, rows x 2^-23 x the sum of the segment's |x|.
- Everything else is exact: the plain version against an explicit
  in-order loop (the order the kernel adds in, read from the plan), the
  plans against numpy's stable argsort, and two solves on the same inputs
  against each other, bit for bit; but for the
  CPU's blocked Cholesky of the dense Schur step, held to S and to
  LAPACK's factor within float32 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.ops import ba as TBA
from orbslam2_tpu_torch.ops import cuda_kernels as CK
from orbslam2_tpu_torch.ops import pose_graph as TPG

# the rows of the port's segment sums: Hcc, G, Hpp, bc, bp and the edge
# count of the BA; the 7x7 blocks and b of the pose graph
WIDTHS = [(6, 6), (6, 3), (3, 3), (6,), (3,), (), (7, 7), (7,)]
EPS32 = 2.0 ** -23


def _rows(rng, E, tail, dtype=np.float32):
    return rng.standard_normal((E, *tail)).astype(dtype)


def _index(rng, E, n):
    """Unsorted segment indices with repeats and (for E < n) empty segments."""
    return rng.integers(0, n, E)


def in_order(x: np.ndarray, plan: CK.SegPlan) -> np.ndarray:
    """The kernel's sum, one segment at a time from the plan: 0.0, then the
    segment's rows added one by one in the plan's order, in x's type."""
    perm, offsets = plan.perm.numpy(), plan.offsets.numpy()
    out = np.zeros((plan.n,) + x.shape[1:], x.dtype)
    for s in range(plan.n):
        acc = np.zeros(x.shape[1:], x.dtype)
        for k in range(offsets[s], offsets[s + 1]):
            acc = acc + x[perm[k]]
        out[s] = acc
    return out


@pytest.mark.parametrize("tail", WIDTHS)
@pytest.mark.parametrize("E,n", [(1024, 16), (700, 2048), (257, 1)])
def test_plain_matches_jax_segment_sum(tail, E, n):
    rng = np.random.default_rng(E + n + len(tail))
    x, idx = _rows(rng, E, tail), _index(rng, E, n)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(idx), n))
    plan = CK.seg_plan(torch.from_numpy(idx), n)
    got = CK.seg_sum(torch.from_numpy(x), plan).numpy()
    rows = np.bincount(idx, minlength=n).reshape((n,) + (1,) * len(tail))
    abs_sum = np.asarray(jax.ops.segment_sum(jnp.abs(jnp.asarray(x)), jnp.asarray(idx), n))
    assert got.shape == want.shape == (n, *tail) and got.dtype == np.float32
    assert np.all(np.abs(got - want) <= rows * EPS32 * abs_sum)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("threads", [1, 4])
def test_plain_is_the_in_order_sum(dtype, threads):
    """`index_add_` on the CPU adds a segment's rows in row order: the same
    bits as the explicit loop over the plan, at any thread count. This is
    what holds the card's kernel, which adds in that order, to the plain
    version bit for bit."""
    rng = np.random.default_rng(threads)
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        for tail, E, n in [((6, 6), 8192, 16), ((6, 3), 512, 4096), ((), 2821, 300),
                           ((7, 7), 300, 40)]:
            x, idx = _rows(rng, E, tail, dtype), _index(rng, E, n)
            plan = CK.seg_plan(torch.from_numpy(idx), n)
            got = CK.seg_sum_ref(torch.from_numpy(x), plan.idx, n).numpy()
            np.testing.assert_array_equal(got, in_order(x, plan))
    finally:
        torch.set_num_threads(before)


def test_plan_is_stable_and_covers_every_row():
    idx = np.array([3, 0, 3, 5, 0, 3, 1, 5, 5, 0])
    n = 7  # segments 2, 4 and 6 are empty
    plan = CK.seg_plan(torch.from_numpy(idx), n)
    perm, offsets = plan.perm.numpy(), plan.offsets.numpy()
    assert plan.perm.dtype == plan.offsets.dtype == torch.int32 and plan.n == n
    np.testing.assert_array_equal(perm, [1, 4, 9, 6, 0, 2, 5, 3, 7, 8])
    np.testing.assert_array_equal(offsets, [0, 3, 4, 4, 7, 7, 10, 10])
    rng = np.random.default_rng(0)
    for E, n in [(8192, 16), (513, 32768), (0, 5), (40, 1)]:
        idx = _index(rng, E, n)
        plan = CK.seg_plan(torch.from_numpy(idx), n)
        perm, offsets = plan.perm.numpy(), plan.offsets.numpy()
        assert sorted(perm.tolist()) == list(range(E))        # a permutation
        assert offsets[0] == 0 and offsets[-1] == E and len(offsets) == n + 1
        assert np.all(np.diff(offsets) == np.bincount(idx, minlength=n))
        for s in range(min(n, 64)):
            rows = perm[offsets[s]:offsets[s + 1]]
            assert np.all(idx[rows] == s) and np.all(np.diff(rows) > 0)


def test_plan_is_numpys_stable_argsort():
    """seg_plan (a stable torch.sort and a search, no readback) against
    numpy's stable argsort and searchsorted of the same index."""
    rng = np.random.default_rng(1)
    for E, n in [(8192, 16), (65536, 128 * 64), (2821, 300), (0, 3)]:
        idx = _index(rng, E, n)
        plan = CK.seg_plan(torch.from_numpy(idx), n)
        perm = np.argsort(idx, kind="stable")
        assert plan.n == n and plan.perm.dtype == plan.offsets.dtype == torch.int32
        np.testing.assert_array_equal(plan.perm.numpy(), perm)
        np.testing.assert_array_equal(plan.offsets.numpy(),
                                      np.searchsorted(idx[perm], np.arange(n + 1)))
        assert torch.equal(plan.idx, torch.from_numpy(idx))


def test_index_outside_the_segments_raises_on_the_cpu():
    """The plan does not check its index (that would read it back); on the
    CPU the sum does, as index_add_ does."""
    x = torch.ones(3, 6)
    for idx in ([0, 3, 1], [0, -1, 1]):
        plan = CK.seg_plan(torch.tensor(idx), 3)
        with pytest.raises((IndexError, RuntimeError)):
            CK.seg_sum(x, plan)


def test_wrapper_checks_and_counts_no_launch_on_the_cpu():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_rows(rng, 50, (6, 3)))
    plan = CK.seg_plan(torch.from_numpy(_index(rng, 50, 9)), 9)
    before = CK.seg_sum.launches
    out = torch.full((9, 6, 3), -1.0)
    assert CK.seg_sum(x, plan, out=out) is out
    assert torch.equal(out, CK.seg_sum_ref(x, plan.idx, 9))
    assert CK.seg_sum.launches == before
    # a strided view of the rows sums as its contiguous copy
    wide = torch.from_numpy(_rows(rng, 50, (6, 6)))
    view = wide[:, :, :3]
    assert torch.equal(CK.seg_sum(view, plan), CK.seg_sum(view.contiguous(), plan))
    with pytest.raises(TypeError):
        CK.seg_sum(x.to(torch.float16), plan)
    with pytest.raises(ValueError, match="rows"):
        CK.seg_sum(x[:49], plan)
    with pytest.raises(ValueError, match="out="):
        CK.seg_sum(x, plan, out=out[:8])
    CK.seg_sum.launches_by["probe"] = 1
    CK.reset_launch_counts()
    assert CK.seg_sum.launches == 0 and CK.seg_sum.launches_by == {}


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_ba_solve_repeats_bit_for_bit(solver):
    """Three solves of one problem are equal bit for bit."""
    arrays, intr = TBA.synthetic_problem(6, 128, 512, seed=5)
    cpu = torch.device("cpu")

    def solve():
        return TBA.ba_solve(TBA.problem_from_numpy(arrays, cpu), *intr, iters1=3,
                            iters2=4, cg_iters=12, solver=solver)
    runs = [solve(), solve(), solve()]
    for r in runs[1:]:
        for a, b in zip(runs[0], r):
            assert torch.equal(a, b)
    assert float(runs[0].cost) < float("inf")


def test_dense_schur_step_repeats_at_the_largest_local_window():
    """The dense Schur step at the mapper's largest local window (64
    cameras: a 384-row reduced system) repeats bit for bit on the CPU at 4
    threads. There LAPACK's threaded Cholesky gave another result on nearly
    every solve, which parted the inline mapper's CPU runs (ROADMAP F4)."""
    arrays, intr = TBA.synthetic_problem(64, 2048, 8192, seed=0)
    cpu = torch.device("cpu")
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        runs = [TBA.ba_solve(TBA.problem_from_numpy(arrays, cpu), *intr, solver="dense")
                for _ in range(3)]
    finally:
        torch.set_num_threads(before)
    for r in runs[1:]:
        for a, b in zip(runs[0], r):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n", [48, 96, 384, 400])
def test_blocked_cholesky_factors_the_system(n):
    """The CPU's blocked Cholesky: lower triangular, L L^T = S within
    float32 rounding (1e-5 of S's largest entry), and within 1e-4 relative
    of LAPACK's factor (another order of the same sums)."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, 3 * n)).astype(np.float32)
    S = torch.from_numpy(A @ A.T / n + np.eye(n, dtype=np.float32))
    L = TBA._cholesky(S)
    assert torch.equal(L, torch.tril(L))
    scale = float(S.abs().max())
    assert float((L @ L.T - S).abs().max()) <= 1e-5 * scale
    ref = torch.linalg.cholesky(S)
    assert float((L - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_ba_plans_hold_every_edge():
    """ba_plans: by camera and by point, and by (point, camera) pair only
    for the dense step; every edge is in each plan, the invalid ones too,
    so the order of a sum does not depend on the mask."""
    arrays, _ = TBA.synthetic_problem(8, 256, 1024, seed=5)
    arrays = dict(arrays, e_valid=np.arange(1024) % 3 > 0)
    prob = TBA.problem_from_numpy(arrays, torch.device("cpu"))
    dense, cg = TBA.ba_plans(prob, dense=True), TBA.ba_plans(prob, dense=False)
    assert cg.pair is None and (dense.cam.n, dense.pt.n, dense.pair.n) == (8, 256, 8 * 256)
    for plan, idx in [(dense.cam, prob.e_cam), (dense.pt, prob.e_pt),
                      (dense.pair, prob.e_pt.long() * 8 + prob.e_cam.long())]:
        assert int(plan.offsets[-1]) == 1024 and torch.equal(plan.idx, idx.long())
    for a, b in zip(cg[:2], dense[:2]):
        assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))


def test_optimize_pose_graph_repeats_bit_for_bit():
    """Three solves of one pose graph are equal bit for bit."""
    args = TPG.synthetic_problem(40, 160, seed=0)

    def solve():
        return TPG.optimize_pose_graph(*(torch.from_numpy(np.array(a)) for a in args),
                                       iters=6)
    runs = [solve(), solve(), solve()]
    for r in runs[1:]:
        for a, b in zip(runs[0], r):
            assert torch.equal(a, b)
    assert runs[0][3][-1] < runs[0][3][0]  # the cost went down


@pytest.mark.cuda
def test_cuda_seg_sum_matches_the_cpu_bit_for_bit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(7)
    for tail, E, n in [((6, 6), 8192, 16), ((6, 3), 8192, 32768), ((7, 7), 2821, 300),
                       ((), 333, 1000), ((3,), 0, 4)]:
        for dtype in (np.float32, np.float64):
            x, idx = _rows(rng, E, tail, dtype), _index(rng, E, n)
            plan = CK.seg_plan(torch.from_numpy(idx).cuda(), n)
            before = CK.seg_sum.launches
            got = CK.seg_sum(torch.from_numpy(x).cuda(), plan).cpu()
            assert CK.seg_sum.launches == before + 1
            want = CK.seg_sum_ref(torch.from_numpy(x), torch.from_numpy(idx), n)
            assert torch.equal(got, want)
