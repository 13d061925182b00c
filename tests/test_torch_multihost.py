"""The port's process-group plumbing (orbslam2_tpu_torch/parallel/
multihost.py), the counterpart of tests/test_multihost.py: the
single-process no-op, the device of a rank (no quiet switch of backend or
device), a problem broadcast from rank 0, and solve_multihost over two gloo
ranks against one process (tests/torch_dist_workers.py starts the ranks).
The full-size two-process run of the module's entry point is marked slow,
as the JAX package marks its own.

Tolerance of the two-rank solve against one process: the cost within 1e-5
relative, the inlier masks on >= 99.9% of edges, rotations within 1e-4 and
translations within 5e-4 m (tests/test_torch_dist_ba.py says why).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from orbslam2_tpu_torch.ops import ba as BA
from orbslam2_tpu_torch.parallel import multihost

import torch_dist_workers as W


def test_init_distributed_is_a_noop_single_process(monkeypatch):
    for k in ("SLAM_NUM_PROCESSES", "SLAM_PROCESS_ID", "SLAM_COORDINATOR"):
        monkeypatch.delenv(k, raising=False)
    info = multihost.init_distributed(device="cpu")
    assert info["processes"] == 1 and info["process_id"] == 0
    assert not dist.is_initialized()
    assert multihost.global_group() is None


def test_rank_device(monkeypatch):
    assert multihost.rank_device(3, 4, "cpu", "gloo") == torch.device("cpu")
    assert multihost.default_backend("cuda") == "nccl"
    assert multihost.default_backend("cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.rank_device(0, 1, "cuda", "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks on one device"):
        multihost.rank_device(1, 2, "cuda", "nccl")
    # gloo may share the card; NCCL with one rank per card is placed by rank
    assert multihost.rank_device(1, 2, "cuda", "gloo") == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert multihost.rank_device(6, 4, "cuda", "nccl") == torch.device("cuda", 2)


@pytest.fixture(scope="module")
def small():
    return BA.synthetic_problem(8, 512, 4096, seed=1)


def test_broadcast_problem(tmp_path, small):
    arrays, _ = small
    W.run_ranks(W.broadcast, 2, tmp_path, arrays)
    got = np.load(tmp_path / "bcast_1.npz")
    ref = BA.problem_from_numpy(arrays, torch.device("cpu"))
    for k in BA.BAProblem._fields:
        want = getattr(ref, k).numpy()
        assert got[k].dtype == want.dtype or k in ("e_cam", "e_pt"), k
        np.testing.assert_array_equal(got[k], want, err_msg=k)


def test_two_process_solve_matches_one(tmp_path, small):
    arrays, intr = small
    kw = dict(iters1=2, iters2=3, cg_iters=12)
    W.run_ranks(W.multihost_solve, 2, tmp_path, arrays, intr, kw)
    one = multihost.solve_multihost(BA.problem_from_numpy(arrays, torch.device("cpu")),
                                    *intr, **kw)
    for rank in (0, 1):
        r = np.load(tmp_path / f"mh_{rank}.npz")
        np.testing.assert_allclose(float(r["cost"]), float(one.cost), rtol=1e-5)
        np.testing.assert_allclose(r["cam_T"][..., :3], one.cam_T.numpy()[..., :3],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(r["cam_T"][..., 3], one.cam_T.numpy()[..., 3],
                                   rtol=0, atol=5e-4)
        assert (r["e_inlier"] == one.e_inlier.numpy()).mean() >= 0.999
        assert r["e_inlier"].sum() > 0.9 * arrays["e_valid"].sum()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_main():
    """python3 -m orbslam2_tpu_torch.parallel.multihost --device cpu in two
    processes over the SLAM_* variables, at the full 128/8192/65536."""
    env = dict(os.environ, SLAM_NUM_PROCESSES="2",
               SLAM_COORDINATOR=f"127.0.0.1:{_free_port()}", OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "orbslam2_tpu_torch.parallel.multihost", "--device", "cpu"],
        env=dict(env, SLAM_PROCESS_ID=str(pid)), cwd=os.getcwd(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    assert "BA over 2 devices / 2 processes" in outs[0], outs[0][-2000:]
    assert "inliers=" in outs[0]
