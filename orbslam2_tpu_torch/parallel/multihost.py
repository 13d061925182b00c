"""Process groups for the distributed solvers, and the global BA's peers.

Counterpart of orbslam2_tpu/parallel/multihost.py (jax.distributed): the
process group's initialization from the environment, the global group, a
solve over it, and what the JAX package gets from GSPMD for free: the
broadcast of a problem that only rank 0 holds, and the loop in which a peer
rank joins the global BA's chunks.

Environment (the JAX package's contract):
    SLAM_COORDINATOR   host:port of process 0 (default 127.0.0.1:12321)
    SLAM_NUM_PROCESSES total process count   (default 1)
    SLAM_PROCESS_ID    this process's id     (default 0)

One rank runs on one device: NCCL on `cuda:{rank % device_count}` for the
device "cuda", gloo on the CPU. NCCL refuses two ranks on one device, so
where that would happen `rank_device` raises; gloo, which takes CUDA tensors
and stages them through the host, is the backend to name for ranks that
share a card. Single-process calls are no-ops and the solve is the
unsharded one. A run with one process per rank:

    SLAM_NUM_PROCESSES=2 SLAM_PROCESS_ID=$i SLAM_COORDINATOR=127.0.0.1:12321 \
        python3 -m orbslam2_tpu_torch.parallel.multihost [--device cpu]

solves the seeded 128-camera, 8192-point, 65536-edge problem sharded over
the ranks and prints the result on process 0.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from ..ops import ba as BA
from . import collectives as COL
from . import dist_ba

# the global BA's headers (rank 0 -> peers): a float64 [8] broadcast of
# (op, iters1, iters2, fx, fy, cx, cy, bf)
SHUTDOWN, END, SOLVE, CHUNK = 0, 1, 2, 3


def rank_device(rank: int, world: int, device: str = "cuda",
                backend: str | None = None) -> torch.device:
    """The device of `rank`: `cuda:{rank % device_count}` for "cuda", else
    `device`. Raises without a CUDA device, and where NCCL would put two of
    the `world` ranks on one device (it refuses to)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("device 'cuda' asked for, but no CUDA device is visible")
    if backend == "nccl" and world > n:
        raise RuntimeError(
            f"NCCL refuses two ranks on one device: {world} ranks over {n} CUDA "
            f"device(s); run at most {n} ranks, or name the gloo backend")
    return torch.device("cuda", rank % n)


def default_backend(device: str) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device: str = "cuda") -> dict:
    """Initialize the default process group from the SLAM_* variables
    (no-op when single-process): NCCL for the device "cuda", gloo for
    "cpu". Returns a status dict."""
    n_proc = int(os.environ.get("SLAM_NUM_PROCESSES", "1"))
    if n_proc <= 1:
        return {"processes": 1, "process_id": 0, "devices": 1, "backend": None,
                "device": device}
    coordinator = os.environ.get("SLAM_COORDINATOR", "127.0.0.1:12321")
    pid = int(os.environ.get("SLAM_PROCESS_ID", "0"))
    backend = default_backend(device)
    dev = rank_device(pid, n_proc, device, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=n_proc, rank=pid,
                            device_id=dev if backend == "nccl" else None)
    return {"processes": n_proc, "process_id": pid, "devices": n_proc,
            "backend": backend, "device": str(dev)}


def global_group():
    """The default group over every rank of every process, or None when
    torch.distributed is not initialized (one process)."""
    return dist.group.WORLD if dist.is_initialized() else None


def solve_multihost(prob: BA.BAProblem, fx, fy, cx, cy, bf, **kw) -> BA.BAResult:
    """Solve a BAProblem over the global group. Every process passes the
    same problem (the map snapshot is replicated; the solver state is
    sharded). One process: the unsharded CG solve."""
    group = global_group()
    if group is None:
        return BA.ba_solve(prob, fx, fy, cx, cy, bf, solver="cg", **kw)
    return dist_ba.dist_ba_solve(prob, group, fx, fy, cx, cy, bf, **kw)


def _fields(C: int, P: int, E: int):
    """(name, shape) of the float32 and of the integer fields of a problem."""
    floats = (("cam_T", (C, 3, 4)), ("pts", (P, 3)), ("e_obs", (E, 3)),
              ("e_info", (E,)))
    ints = (("e_cam", (E,)), ("e_pt", (E,)), ("cam_fixed", (C,)),
            ("cam_valid", (C,)), ("pt_valid", (P,)), ("e_stereo", (E,)),
            ("e_valid", (E,)))
    return floats, ints


def broadcast_problem(prob: BA.BAProblem | None, group, src: int = 0,
                      device: str | torch.device | None = None) -> BA.BAProblem:
    """The problem of rank `src` on every rank: its sizes first, then its
    float32 fields in one buffer and its index and mask fields in another.
    `src` passes the problem and gets it back; the others pass None and
    the device to receive it on."""
    g = COL.default_group(group)
    me = COL.rank(g) == src
    dev = prob.cam_T.device if me else torch.device(device)
    sizes = torch.tensor([prob.cam_T.shape[0], prob.pts.shape[0], prob.e_cam.shape[0]]
                         if me else [0, 0, 0], dtype=torch.int64, device=dev)
    C, P, E = COL.broadcast(sizes, g, src).tolist()
    floats, ints = _fields(C, P, E)
    bufs = []
    for spec, dtype in ((floats, torch.float32), (ints, torch.int64)):
        n = sum(int(np.prod(shape)) for _, shape in spec)
        buf = (torch.cat([getattr(prob, k).reshape(-1).to(dtype) for k, _ in spec])
               if me else torch.empty(n, dtype=dtype, device=dev))
        bufs.append(COL.broadcast(buf, g, src))
    if me:
        return prob
    out, bools = {}, ("cam_fixed", "cam_valid", "pt_valid", "e_stereo", "e_valid")
    for spec, buf in zip((floats, ints), bufs):
        i = 0
        for k, shape in spec:
            n = int(np.prod(shape))
            x = buf[i:i + n].reshape(shape)
            out[k] = x.bool() if k in bools else x
            i += n
    return BA.BAProblem(**out)


def header(group, device, op: int | None = None, iters=(0, 0),
           intrinsics=(0.0,) * 5) -> tuple[int, tuple[int, int], tuple]:
    """One header of the global BA, sent by rank 0 (op given) and received
    by the peers (op None): (op, (iters1, iters2), (fx, fy, cx, cy, bf))."""
    g = COL.default_group(group)
    vals = [op if op is not None else -1, *iters, *intrinsics]
    h = COL.broadcast(torch.tensor(vals, dtype=torch.float64, device=device), g, 0)
    h = h.tolist()
    return int(h[0]), (int(h[1]), int(h[2])), tuple(h[3:])


def serve_global_ba(group=None, device: str | torch.device = "cuda") -> list[int]:
    """The loop of a peer rank of the global BA (global_ba.GlobalBA on rank
    0): receive a header; on SOLVE receive the snapshot's problem, then join
    `dist_ba_solve` once per CHUNK header until an END header (the solve
    ended or was aborted); return on SHUTDOWN. Returns the number of chunks
    joined in each solve."""
    g, dev = COL.default_group(group), torch.device(device)
    served = []
    while True:
        op, _, intr = header(g, dev)
        if op == SHUTDOWN:
            return served
        if op != SOLVE:
            raise RuntimeError(f"global BA peer: header {op} outside a solve")
        prob = broadcast_problem(None, g, device=dev)
        chunks = 0
        while True:
            op, iters, _ = header(g, dev)
            if op == END:
                break
            if op != CHUNK:
                raise RuntimeError(f"global BA peer: header {op} inside a solve")
            res = dist_ba.dist_ba_solve(prob, g, *intr, iters1=iters[0],
                                        iters2=iters[1])
            prob = prob._replace(cam_T=res.cam_T, pts=res.pts)
            chunks += 1
        served.append(chunks)


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    info = init_distributed(device=args.device)
    print(f"[multihost] {info}", flush=True)
    try:
        arrays, intr = BA.synthetic_problem(128, 8192, 65536)
        prob = BA.problem_from_numpy(arrays, torch.device(info["device"]))
        res = solve_multihost(prob, *intr, iters1=2, iters2=3, cg_iters=12)
        inl = int(res.e_inlier.sum())
        cost = float(res.cost)
        if not np.isfinite(cost):
            raise RuntimeError(f"the sharded BA diverged: cost {cost}")
        if info["process_id"] == 0:
            print(f"[multihost] BA over {info['devices']} devices / "
                  f"{info['processes']} processes: cost={cost:.1f}, "
                  f"inliers={inl}/65536", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
