"""Rank targets of the port's distributed tests (tests/test_torch_dist_ba.py,
tests/test_torch_multihost.py), and the helper that runs them.

`run_ranks(target, world, work, *args)` starts `world` processes with
torch.multiprocessing (spawn), joins them in a gloo group through a file
store under `work` (no TCP port that two test workers could both take),
caps torch at one thread each, and calls `target(rank, world, work, *args)`
in each. A target writes what the test reads as .npz or .json files into
`work`. This module and what the ranks run import torch, numpy and the port
only: no JAX, no test module that imports it.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from orbslam2_tpu_torch.ops import ba as BA
from orbslam2_tpu_torch.parallel import dist_ba, dist_pgo, multihost


def _entry(rank, target, world, work, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            world_size=world, rank=rank)
    try:
        target(rank, world, Path(work), *args)
    finally:
        dist.destroy_process_group()


def run_ranks(target, world: int, work: Path, *args) -> Path:
    work = Path(work)
    work.mkdir(parents=True, exist_ok=True)
    store = work / "store"
    if store.exists():
        os.remove(store)
    mp.spawn(_entry, args=(target, world, str(work), args), nprocs=world, join=True)
    return work


def _cpu_problem(arrays):
    return BA.problem_from_numpy(arrays, torch.device("cpu"))


def _save(path: Path, **arrays):
    np.savez(path, **{k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                      for k, v in arrays.items()})


def solvers(rank, world, work, ba_cases: dict, pgo, pgo_iters: int):
    """Every sharded BA case of `ba_cases` (name -> (arrays, intrinsics,
    keyword arguments of dist_ba_solve)) and the sharded pose graph; each
    rank writes its own results, rank 0 also the collective counts."""
    for name, (arrays, intr, kw) in ba_cases.items():
        r = dist_ba.dist_ba_solve(_cpu_problem(arrays), None, *intr, **kw)
        _save(work / f"ba_{name}_{rank}.npz", cam_T=r.cam_T, pts=r.pts,
              e_inlier=r.e_inlier, cost=r.cost)
    pg = [torch.from_numpy(np.asarray(a)) for a in pgo]
    sv, R, t, costs = dist_pgo.dist_pose_graph(None, *pg, iters=pgo_iters)
    _save(work / f"pgo_{rank}.npz", svals=sv, R=R, t=t, costs=costs)
    arrays, intr, _ = next(iter(ba_cases.values()))
    counts = {
        "ba": dist_ba.collectives(_cpu_problem(arrays), None, *intr, iters1=2,
                                  iters2=1, cg_iters=3),
        "pgo": dist_pgo.collectives_pgo(None, *pg, iters=2, cg_iters=5)}
    if rank == 0:
        (work / "counts.json").write_text(json.dumps(counts))


def multihost_solve(rank, world, work, arrays, intr, kw):
    """solve_multihost over the default group; every rank writes its result."""
    r = multihost.solve_multihost(_cpu_problem(arrays), *intr, **kw)
    _save(work / f"mh_{rank}.npz", cam_T=r.cam_T, pts=r.pts, e_inlier=r.e_inlier,
          cost=r.cost)


def global_ba(rank, world, work, map_path: str, cfg):
    """The global BA's distributed branch: rank 0 loads the map into a
    GlobalBA (dist_min_cams = 1, on the CPU) and runs one solve on its
    thread, applied, then a second solve aborted after chunk 0 on a fresh
    load; the other ranks serve both. Rank 0 writes the applied poses and
    points, the dispatch's rank count and the aborted map's poses before
    and after; every rank writes the chunks it joined."""
    from orbslam2_tpu_torch.global_ba import GlobalBA
    from orbslam2_tpu_torch.map.mapstate import MapState
    if rank != 0:
        served = multihost.serve_global_ba(None, "cpu")
        (work / f"served_{rank}.json").write_text(json.dumps(served))
        return
    mp_ = MapState.load(map_path, cfg)
    gba = GlobalBA(cfg, mp_, device="cpu")
    gba.dist_min_cams = 1
    seen = []
    orig = gba._solver_fn

    def probe(prob):
        solve, n = orig(prob)
        seen.append(n)
        return solve, n

    gba._solver_fn = probe
    gba.launch(fixed_kf=0, chunks=2, chunk_iters=(1, 2))
    applied = gba.wait_and_apply(timeout=600)
    ab_map = MapState.load(map_path, cfg)
    before = ab_map.kf_pose.copy()
    ab = GlobalBA(cfg, ab_map, device="cpu")
    ab.dist_min_cams = 1
    ab.chunk_hook = lambda chunk: ab.request_abort()
    ab.launch(fixed_kf=0, chunks=2, chunk_iters=(1, 2))
    ab.abort_and_join(timeout=600)
    aborted_applied = ab.poll()
    multihost.header(None, "cpu", multihost.SHUTDOWN)
    _save(work / "gba.npz", kf_pose=mp_.kf_pose, pt_xyz=mp_.pt_xyz, dispatch=seen,
          applied=applied, aborted=ab.n_aborted, aborted_applied=aborted_applied,
          abort_before=before, abort_after=ab_map.kf_pose)


def broadcast(rank, world, work, arrays):
    """broadcast_problem from rank 0; every other rank writes what it got."""
    prob = _cpu_problem(arrays) if rank == 0 else None
    got = multihost.broadcast_problem(prob, None, device="cpu")
    if rank != 0:
        _save(work / f"bcast_{rank}.npz", **got._asdict())
