"""Distributed Sim(3) pose-graph optimization over a process group.

Counterpart of orbslam2_tpu/parallel/dist_pgo.py: the essential-graph
solver (ops/pose_graph.py) does its heavy work per edge (the residuals and
the 14 perturbations of each endpoint) and reduces it into per-vertex
blocks. So, as in the JAX package:

- the EDGE arrays are split into `world` contiguous parts, padded to a
  multiple of `world` with invalid identity edges (masked out of every sum);
- the VERTEX state ([K] Sim3) is replicated: K is the keyframe count, small
  next to E.

Collectives of one solve (`collectives_pgo` counts them):
    all_reduce: iters * (cg_iters + 1)
        per Gauss-Newton iteration one for the block diagonal, b and the
        cost packed together, one per CG matvec.
"""
from __future__ import annotations

import torch

from ..ops import pose_graph as PG
from . import collectives as COL


def shard_pgo(rank: int, world: int, svals, R, t, fixed, e_i, e_j, meas_s, meas_R,
              meas_t, e_valid):
    """Rank `rank`'s part of a pose-graph problem: the vertices whole, its
    contiguous slice of the edges after padding them to a multiple of
    `world` with e_valid=False identity edges."""
    E = int(e_i.shape[0])
    pad = (-E) % world

    def padded(a, fill):
        if not pad:
            return a
        return torch.cat([a, fill.to(a).expand((pad,) + tuple(a.shape[1:]))])

    one, zero = torch.ones(()), torch.zeros(())
    edges = (padded(e_i, zero), padded(e_j, zero), padded(meas_s, one),
             padded(meas_R, torch.eye(3)), padded(meas_t, zero),
             padded(e_valid, zero))
    n = (E + pad) // world
    return (svals, R, t, fixed) + tuple(a[rank * n:(rank + 1) * n] for a in edges)


def dist_pose_graph(group, svals, R, t, fixed, e_i, e_j, meas_s, meas_R, meas_t,
                    e_valid, iters: int = 20, cg_iters: int = 32):
    """optimize_pose_graph with the edges split over `group` (None: the
    default group); every rank passes the same full problem and gets the
    same (svals, R, t, costs)."""
    g = COL.default_group(group)
    args = shard_pgo(COL.rank(g), COL.world(g), svals, R, t, fixed, e_i, e_j,
                     meas_s, meas_R, meas_t, e_valid)
    return PG.optimize_pose_graph(*args, iters=iters, cg_iters=cg_iters, group=g)


def collectives_pgo(group, svals, R, t, fixed, e_i, e_j, meas_s, meas_R, meas_t,
                    e_valid, iters: int = 1, cg_iters: int = 4) -> list[tuple[str, int]]:
    """The collectives of a short sharded solve, by name and count:
    iters * (cg_iters + 1) all_reduce (module docstring)."""
    counting = COL.Counting(COL.default_group(group))
    dist_pose_graph(counting, svals, R, t, fixed, e_i, e_j, meas_s, meas_R, meas_t,
                    e_valid, iters=iters, cg_iters=cg_iters)
    return sorted(counting.counts.items())
