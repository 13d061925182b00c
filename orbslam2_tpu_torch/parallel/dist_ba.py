"""Distributed Schur-complement bundle adjustment over a process group.

Counterpart of orbslam2_tpu/parallel/dist_ba.py. The JAX package places the
edge arrays and the point blocks on a mesh axis, each split by index, and
lets GSPMD add the collectives, the halo exchanges between an edge's shard
and its point's included. PyTorch has no GSPMD, so here the sharding is
written out, and laid out so that no halo is needed:

- the POINTS are split into `world` contiguous blocks; rank r holds block r
  and EVERY edge that observes one of its points (its owner's edges),
  re-indexed locally and padded with invalid edges to the largest shard.
  Hpp, bp, the 3x3 marginalization and the back-substitution are then
  local, as is the chi2 classification;
- the CAMERAS are replicated: the camera-indexed sums (Hcc, the Schur rhs,
  the CG matvec) and the costs are all-reduced, so the CG and the LM
  accept/reject run on replicated values on every rank.

Collectives of one solve (`collectives` counts them):
    all_reduce: (iters1 + iters2) * (cg_iters + 2)
        per LM iteration one for Hcc, the rhs and the cost packed together,
        one per CG matvec, one for the cost of the step;
    all_gather: 1
        the points and the inlier mask, to put them back in order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import ba as BA
from . import collectives as COL


class Shard(NamedTuple):
    problem: BA.BAProblem    # this rank's points and their edges, cameras whole
    pt_index: torch.Tensor   # [world, P_max] global point of each local row, -1 pad
    edge_index: torch.Tensor  # [world, E_max] global edge of each local row, -1 pad


def shard_plan(e_pt: torch.Tensor, n_points: int, world: int):
    """Points in `world` contiguous blocks, each edge on its point's owner.
    Returns (pt_index [world, P_max], edge_index [world, E_max]): the global
    point and edge of every rank's local row, -1 in the padding; the edges
    of a rank keep their global order."""
    dev = e_pt.device
    bounds = [(r * n_points) // world for r in range(world + 1)]
    p_max = max(max(b - a for a, b in zip(bounds, bounds[1:])), 1)
    col = torch.arange(p_max, device=dev)
    lo = torch.tensor(bounds[:-1], device=dev)[:, None]
    hi = torch.tensor(bounds[1:], device=dev)[:, None]
    pt_index = torch.where(lo + col < hi, lo + col, -1)
    owner = torch.bucketize(e_pt.long(), hi[:, 0], right=True)
    order = torch.sort(owner, stable=True).indices
    counts = torch.zeros(world, dtype=torch.long, device=dev).scatter_add_(
        0, owner, torch.ones_like(owner)).tolist()
    e_max = max(max(counts), 1)
    edge_index = torch.full((world, e_max), -1, dtype=torch.long, device=dev)
    start = 0
    for r, n in enumerate(counts):
        edge_index[r, :n] = order[start:start + n]
        start += n
    return pt_index, edge_index


def shard_problem(p: BA.BAProblem, rank: int, world: int) -> Shard:
    """Rank `rank`'s part of the problem: its block of points (padded with
    invalid points), every edge of them with `e_pt` made local (padded with
    invalid edges), the cameras whole. Every rank computes the same plan
    from the same full problem."""
    pt_index, edge_index = shard_plan(p.e_pt, p.pts.shape[0], world)
    pi, ei = pt_index[rank], edge_index[rank]
    pin, ein = pi >= 0, ei >= 0
    pc, ec = pi.clamp(min=0), ei.clamp(min=0)
    lo = (rank * p.pts.shape[0]) // world
    local = p._replace(
        pts=p.pts[pc], pt_valid=p.pt_valid[pc] & pin,
        e_cam=p.e_cam[ec], e_pt=torch.where(ein, p.e_pt[ec] - lo, 0),
        e_obs=p.e_obs[ec], e_stereo=p.e_stereo[ec] & ein, e_info=p.e_info[ec],
        e_valid=p.e_valid[ec] & ein)
    return Shard(local, pt_index, edge_index)


def dist_ba_solve(p: BA.BAProblem, group, fx, fy, cx, cy, bf,
                  iters1: int = 5, iters2: int = 10, cg_iters: int = 24) -> BA.BAResult:
    """Solve BA sharded by point owner over `group` (None: the default
    group). Every rank passes the same full problem, as in the JAX
    package's solve_multihost, and gets the whole result in the original
    point and edge order: the cameras and the cost are replicated, the
    points and the inlier mask come back by one all_gather.

    solver is pinned to "cg", as in the JAX package: the dense Schur step
    forms the reduced system from every point's coupling."""
    g = COL.default_group(group)
    world = COL.world(g)
    shard = shard_problem(p, COL.rank(g), world)
    res = BA.ba_solve(shard.problem, fx, fy, cx, cy, bf, iters1=iters1,
                      iters2=iters2, cg_iters=cg_iters, solver="cg", group=g)
    packed = torch.cat([res.pts.reshape(-1), res.e_inlier.to(res.pts.dtype)])
    every = COL.all_gather(packed, g)
    p_max = shard.pt_index.shape[1]
    pts_all = every[:, :3 * p_max].reshape(world, p_max, 3)
    inl_all = every[:, 3 * p_max:] > 0.5
    own, seen = shard.pt_index >= 0, shard.edge_index >= 0
    pts = p.pts.clone()
    pts[shard.pt_index[own]] = pts_all[own]
    e_inlier = torch.zeros_like(p.e_valid)
    e_inlier[shard.edge_index[seen]] = inl_all[seen]
    return BA.BAResult(cam_T=res.cam_T, pts=pts, e_inlier=e_inlier, cost=res.cost)


def collectives(p: BA.BAProblem, group, fx, fy, cx, cy, bf, iters1: int = 1,
                iters2: int = 1, cg_iters: int = 4) -> list[tuple[str, int]]:
    """The collectives a short sharded solve issues, by name and count
    (the counterpart of the JAX package's lowered_collectives, which reads
    them from the compiled program): (iters1 + iters2) * (cg_iters + 2)
    all_reduce and 1 all_gather (module docstring)."""
    counting = COL.Counting(COL.default_group(group))
    dist_ba_solve(p, counting, fx, fy, cx, cy, bf, iters1=iters1, iters2=iters2,
                  cg_iters=cg_iters)
    return sorted(counting.counts.items())
