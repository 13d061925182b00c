"""The port's entry points (orbslam2_tpu_torch/graft_entry.py) against the
JAX package's __graft_entry__.py: the same inputs (descriptors through the
u32 <-> i32 bit view of interop), the same tracking result within the
pose-LM tolerance of tests/test_torch_engine_step.py (pose within 1e-4,
inliers within 2), the same BA and pose-graph problems array for array,
and the command line of the dry run.
"""
import numpy as np
import pytest

import __graft_entry__ as J
from orbslam2_tpu_torch import graft_entry as G
from orbslam2_tpu_torch.interop import desc_i32_to_u32


@pytest.fixture(scope="module")
def entries():
    return J.entry(), G.entry(device="cpu")


def test_entry_args_equal_jax(entries):
    (_, ja), (_, ta) = entries
    assert len(ja) == len(ta) == 8
    for i, (j, t) in enumerate(zip(ja, ta)):
        t = t.numpy()
        if i == 3:  # descriptors: the same bits
            t = desc_i32_to_u32(t)
        j = np.asarray(j)
        assert t.shape == j.shape and t.dtype == j.dtype, i
        np.testing.assert_array_equal(t, j, err_msg=str(i))


def test_entry_fn_matches_jax(entries):
    (jf, ja), (tf, ta) = entries
    Tj, nj = jf(*ja)
    Tt, nt = tf(*ta)
    assert abs(int(nt) - int(nj)) <= 2
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)


@pytest.mark.parametrize("size", [(8, 256, 1024), (16, 2048, 8192), (128, 8192, 65536)])
def test_make_ba_problem_equals_jax(size):
    jp, jintr = J._make_ba_problem(*size)
    tp, tintr = G._make_ba_problem(*size)
    assert tuple(jintr) == tuple(tintr)
    for k in jp._fields:
        j = np.asarray(getattr(jp, k))
        assert tp[k].dtype == j.dtype, k
        np.testing.assert_array_equal(tp[k], j, err_msg=k)


@pytest.mark.parametrize("K,loop_conn", [(64, True), (512, True), (40, False)])
def test_make_pgo_problem_equals_jax(K, loop_conn):
    for j, t in zip(J._make_pgo_problem(K=K, loop_conn=loop_conn),
                    G._make_pgo_problem(K=K, loop_conn=loop_conn)):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)


def test_dryrun_command_line():
    a = G._parse_args(["--dryrun", "2", "--backend", "gloo", "--device", "cpu"])
    assert (a.dryrun, a.backend, a.device) == (2, "gloo", "cpu")
    a = G._parse_args(["--dryrun", "1"])
    assert (a.dryrun, a.backend, a.device) == (1, None, "cuda")
    for bad in ([], ["--dryrun", "0"], ["--dryrun", "2", "--backend", "mpi"],
                ["--dryrun", "2", "--device", "tpu"]):
        with pytest.raises(SystemExit):
            G._parse_args(bad)


def test_dryrun_refuses_cuda_without_a_card():
    """No fallback: the default device is the card, and without one the dry
    run raises before it starts a rank."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        G.dryrun_multichip(1)
