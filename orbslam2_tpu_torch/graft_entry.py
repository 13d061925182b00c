"""Entry points of the port: the per-frame program and the multi-rank dry run.

Counterpart of the JAX package's `__graft_entry__.py` (which stays at the
repository's root):

- `entry(device="cuda")` returns `(fn, args)`: `engine_step.tracking_step`
  (extract ORB, project and match on kernel `hamming_best2`, pose-only LM)
  on a 480x640 frame against a 1024-point map, from the same seeded draws
  as the JAX entry;
- `_make_ba_problem` and `_make_pgo_problem`: the seeded BA problem
  (`ops/ba.synthetic_problem`, the same arrays as the JAX package's) and the
  loop-closure pose graph;
- `dryrun_multichip(n, device="cuda", backend=None)` runs the JAX dry run's
  checks with n ranks through the distributed solvers
  (parallel/dist_ba.py, parallel/dist_pgo.py).

    python3 -m orbslam2_tpu_torch.graft_entry --dryrun N [--backend gloo] [--device cpu]

starts the N ranks (one process each, a file store in a temporary
directory) and prints rank 0's lines, the last one as JSON. The default
backend is NCCL on "cuda", one card per rank (rank_device refuses two ranks
on one card under NCCL); `--backend gloo --device cuda` runs ranks that
share a card.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .config import OrbParams
from .interop import desc_u32_to_i32
from .ops import ba as BA
from .ops import features as F
from .ops import pose_graph as PG
from .parallel import dist_ba, dist_pgo
from .parallel.multihost import default_backend, rank_device

# the dry run's problems (the JAX package's __graft_entry__.dryrun_multichip)
BA_SIZE = (128, 8192, 65536)
CROSSOVER_SIZE = (512, 65536, 1048576)
PGO_K = 512


def entry(device: str = "cuda"):
    """(fn, args): the fused per-frame tracking program on a 480x640 frame
    against a 1024-point local map, its inputs on `device`."""
    from .engine_step import tracking_step

    params = OrbParams()
    H, W = 480, 640
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    T_pred = np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32)
    Pn = 1024
    pts = np.asarray(rng.uniform(-2, 2, (Pn, 3)).astype(np.float32) + [0, 0, 6],
                     np.float32)
    desc = desc_u32_to_i32(rng.integers(0, 2 ** 32, (Pn, 8), dtype=np.uint32))
    octv = rng.integers(0, 8, Pn).astype(np.int32)
    valid = np.ones((Pn,), bool)
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
        img, T_pred, pts, desc, octv, valid, F.scale_factors(params),
        F.sigma2_per_octave(params)))

    def fn(img, T_pred, pts, desc, octv, valid, sf, sig2):
        T, n, _ = tracking_step(img, T_pred, pts, desc, octv, valid, sf, sig2,
                                params, H, W, 500.0, 500.0, 320.0, 240.0, 0.0)
        return T, n

    return fn, args


def _make_ba_problem(C: int, P: int, E: int, stereo_frac: float = 0.3, seed: int = 0):
    """The seeded synthetic BA problem (numpy arrays named as BAProblem's
    fields, and (fx, fy, cx, cy, bf)): ops/ba.synthetic_problem."""
    return BA.synthetic_problem(C, P, E, seed=seed, stereo_frac=stereo_frac)


def _make_pgo_problem(K: int = 256, seed: int = 0, loop_conn: bool = True):
    """Synthetic loop-closure pose graph: K Sim3 vertices on a drifting
    circle, sequential odometry edges (from true relative poses),
    covisibility-style skip edges, one loop edge, and with loop_conn the
    cross-graph LoopConnections edges (src/LoopClosing.cpp:684-711) that
    make the corrected essential graph small-world. Returns numpy arrays
    (svals, R, t, fixed, e_i, e_j, meas_s, meas_R, meas_t, e_valid)."""
    rng = np.random.default_rng(seed)

    def rotz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)

    R_gt, t_gt = [], []
    for k in range(K):
        a = 2 * np.pi * k / K
        R_gt.append(rotz(a))
        t_gt.append(np.array([10 * np.cos(a), 10 * np.sin(a), 0], np.float32))
    R_est, t_est = [R_gt[0]], [t_gt[0]]
    for k in range(1, K):
        dR = rotz(rng.normal(0, 0.004))
        R_est.append((dR @ R_gt[k]).astype(np.float32))
        t_est.append((t_gt[k] + rng.normal(0, 0.05, 3)
                      + 0.02 * k * np.array([1, 0, 0])).astype(np.float32))
    edges = [(k, k + 1) for k in range(K - 1)]
    edges += [(k, k + 5) for k in range(0, K - 5, 3)]
    edges += [(0, K - 1)]  # the loop edge
    if loop_conn:
        step = max(K // 16, 8)
        edges += [(k, k + step) for k in range(0, K - step, step // 2)]
    e_i = np.array([a for a, b in edges], np.int32)
    e_j = np.array([b for a, b in edges], np.int32)
    mR, mt = [], []
    for a, b in edges:  # measurements from the true relative poses
        Rrel = R_gt[a] @ R_gt[b].T
        mR.append(Rrel)
        mt.append(t_gt[a] - Rrel @ t_gt[b])
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return (np.ones(K, np.float32), np.stack(R_est), np.stack(t_est), fixed,
            e_i, e_j, np.ones(len(edges), np.float32),
            np.stack(mR).astype(np.float32), np.stack(mt).astype(np.float32),
            np.ones(len(edges), bool))


def _dryrun(rank: int, n: int, dev: torch.device, backend: str) -> dict | None:
    """The checks of the JAX package's dryrun_multichip on this rank; rank
    0 also runs the unsharded solves, prints a line per check before its
    gate and returns the numbers."""
    group, lead = dist.group.WORLD, rank == 0

    def say(msg: str) -> None:
        if lead:
            print(f"dryrun_multichip({n}): {msg}", flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn, warm: bool = True):
        """One timed call (host clock, synchronized), after a warm-up call."""
        if warm:
            fn()
            sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    def ba(size):
        arrays, intr = _make_ba_problem(*size)
        return BA.problem_from_numpy(arrays, dev), intr

    def sharded(prob, intr):
        return lambda: dist_ba.dist_ba_solve(prob, group, *intr, iters1=2, iters2=3,
                                             cg_iters=12)

    def unsharded(prob, intr):
        return lambda: BA.ba_solve(prob, *intr, iters1=2, iters2=3, cg_iters=12,
                                   solver="cg")

    out = {"ranks": n, "backend": backend, "device": str(dev)}
    prob, intr = ba(BA_SIZE)
    colls = dist_ba.collectives(prob, group, *intr)
    if colls != [("all_gather", 1), ("all_reduce", (1 + 1) * (4 + 2))]:
        raise AssertionError(f"sharded BA issued {colls} (expected 1 all_gather and "
                             "(iters1 + iters2) * (cg_iters + 2) = 12 all_reduce)")
    pgo = tuple(torch.from_numpy(a).to(dev) for a in _make_pgo_problem(K=PGO_K))
    pgo_colls = dist_pgo.collectives_pgo(group, *pgo)
    if pgo_colls != [("all_reduce", 1 * (4 + 1))]:
        raise AssertionError(f"sharded PGO issued {pgo_colls} (expected iters * "
                             "(cg_iters + 1) = 5 all_reduce)")
    out["collectives"] = {"ba": colls, "pgo": pgo_colls}
    say(f"{backend} on {dev}; a sharded BA of C={BA_SIZE[0]} P={BA_SIZE[1]} "
        f"E={BA_SIZE[2]} (points by owner, cameras replicated) issued {colls} in 1 + 1 "
        f"LM iterations of 4 CG steps; a sharded PGO (edges split) {pgo_colls} in 1 "
        f"Gauss-Newton iteration of 4 CG steps")

    # the pose graph (GBA-sized, 512 keyframes) to the solver's convergence
    # budget: sharded against the single-process solve, max |dt| < 1e-3;
    # one call each, timed without a warm-up (the collectives' count warmed
    # its kernels)
    (_, _, t_n, _), out["pgo_ms_ranks"] = timed(
        lambda: dist_pgo.dist_pose_graph(group, *pgo, iters=40, cg_iters=64), False)
    if lead:
        (_, _, t_1, _), out["pgo_ms_one"] = timed(
            lambda: PG.optimize_pose_graph(*pgo, iters=40, cg_iters=64), False)
        out["pgo_max_dt"] = float((t_n - t_1).abs().max())
        say(f"PGO K={PGO_K}, 40 x 64 CG: {out['pgo_ms_ranks']:.0f} ms over {n} rank(s), "
            f"{out['pgo_ms_one']:.0f} ms in one process, max|dt| = "
            f"{out['pgo_max_dt']:.2e}")
        if not bool(torch.isfinite(t_n).all()):
            raise AssertionError("sharded PGO produced non-finite poses")
        if not out["pgo_max_dt"] < 1e-3:
            raise AssertionError(f"sharded PGO diverged from the single-process "
                                 f"solve: max |dt| = {out['pgo_max_dt']}")
    dist.barrier()

    # the crossover scale, where the JAX package's mesh pays on wall clock
    prob_x, intr_x = ba(CROSSOVER_SIZE)
    res_x, out["crossover_ms_ranks"] = timed(sharded(prob_x, intr_x))
    if lead:
        _, out["crossover_ms_one"] = timed(unsharded(prob_x, intr_x))
        if not np.isfinite(float(res_x.cost)):
            raise AssertionError("crossover-scale BA diverged")
        out["speedup"] = out["crossover_ms_one"] / out["crossover_ms_ranks"]
        # the ranks divide the work only where each has a device of its own
        distinct = dev.type == "cuda" and 1 < n <= torch.cuda.device_count()
        out["speedup_asserted"] = distinct
        why = ("" if distinct else " (not asserted: one rank)" if n == 1 else
               " (not asserted: ranks on the CPU)" if dev.type == "cpu" else
               f" (not asserted: {n} ranks share {torch.cuda.device_count()} device(s))")
        Cx, Px, Ex = CROSSOVER_SIZE
        say(f"crossover C={Cx} P={Px} E={Ex}: one process "
            f"{out['crossover_ms_one']:.0f} ms, {n} rank(s) "
            f"{out['crossover_ms_ranks']:.0f} ms = {out['speedup']:.2f}x{why}")
        if distinct and not out["speedup"] > 1.15:
            raise AssertionError(f"sharded BA does not pay at scale: "
                                 f"{out['speedup']:.2f}x over {n} devices")
    del prob_x, res_x
    dist.barrier()

    # the KITTI-scale problem: the same optimum as the single-process solve
    resN, out["ba_ms_ranks"] = timed(sharded(prob, intr))
    if lead:
        res1, out["ba_ms_one"] = timed(unsharded(prob, intr))
        E = BA_SIZE[2]
        cost1, costN = float(res1.cost), float(resN.cost)
        inl1, inlN = int(res1.e_inlier.sum()), int(resN.e_inlier.sum())
        out.update(cost_one=cost1, cost_ranks=costN, inliers_one=inl1,
                   inliers_ranks=inlN)
        say(f"BA C={BA_SIZE[0]} P={BA_SIZE[1]} E={E}, 2 + 3 LM iterations of 12 CG "
            f"steps: one process {out['ba_ms_one']:.0f} ms, cost {cost1:.1f}, {inl1} "
            f"inliers; {n} rank(s) {out['ba_ms_ranks']:.0f} ms, cost {costN:.1f}, "
            f"{inlN} inliers")
        if not (np.isfinite(costN) and bool(torch.isfinite(resN.cam_T).all())):
            raise AssertionError(f"distributed BA diverged: cost={costN}")
        if not 0.95 < costN / max(cost1, 1e-9) < 1.05:
            raise AssertionError(f"sharded solve converged elsewhere: cost {costN:.2f}"
                                 f" against {cost1:.2f}")
        if not inlN > 0.9 * E:
            raise AssertionError(f"BA did not converge: {inlN}/{E} inliers")
        if not abs(inlN - inl1) <= 0.02 * E:
            raise AssertionError(f"inlier classification diverged: {inlN} vs {inl1}")
    dist.barrier()
    return out if lead else None


def _rank_main(rank: int, n: int, store: str, device: str, backend: str) -> None:
    dev = rank_device(rank, n, device, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # each CPU rank its share of the cores (spinning threads starve the rest)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=n,
                            rank=rank, device_id=dev if backend == "nccl" else None)
    try:
        out = _dryrun(rank, n, dev, backend)
    finally:
        dist.destroy_process_group()
    if out is not None:
        print(json.dumps(out), flush=True)


def dryrun_multichip(n: int, device: str = "cuda", backend: str | None = None) -> None:
    """Start n ranks and run the JAX package's multichip checks through the
    distributed solvers: the collectives of a sharded BA and PGO solve
    (their counts exactly), the 512-vertex pose graph against the
    single-process solve (max |dt| < 1e-3), the 512/65536/1048576 crossover
    BA timed at n ranks and 1 (the JAX speedup gate > 1.15 only where the n
    ranks have n devices), and the 128/8192/65536 BA against the
    single-process solve (cost within 5%, > 90% inliers, inlier counts
    within 2%). Raises if a rank fails."""
    import torch.multiprocessing as mp
    backend = backend or default_backend(device)
    rank_device(0, n, device, backend)  # refuse before starting any rank
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(n, os.path.join(tmp, "store"), device, backend),
                 nprocs=n, join=True)


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun", type=int, required=True, metavar="N",
                    help="ranks to start (one process each)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.dryrun < 1:
        ap.error("--dryrun needs at least 1 rank")
    return args


def main(argv=None) -> int:
    args = _parse_args(argv)
    dryrun_multichip(args.dryrun, device=args.device, backend=args.backend)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
