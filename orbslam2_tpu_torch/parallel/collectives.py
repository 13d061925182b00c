"""The collectives of the sharded solvers.

`ops/ba.ba_solve` and `ops/pose_graph.optimize_pose_graph` take `group=None`
and route every sum that crosses ranks through `all_reduce` here. With
`group=None` the helpers issue nothing and return their input, so the
single-process solvers run exactly as before. With a process group (or a
`Counting` wrapper of one) they call torch.distributed.

PyTorch has no GSPMD: where the JAX package annotates shardings and lets XLA
insert the collectives (orbslam2_tpu/parallel/dist_ba.py), the port names
each one. `Counting` is how a caller sees them, since there is no lowered
program to read.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist


class Counting:
    """A process group that counts, by name, the collectives issued
    through it (dist_ba.collectives, dist_pgo.collectives_pgo)."""

    def __init__(self, group):
        self.group = group
        self.counts: collections.Counter = collections.Counter()


def _pg(group, name: str | None = None):
    """The torch.distributed group behind `group`, counting one `name`."""
    if isinstance(group, Counting):
        if name is not None:
            group.counts[name] += 1
        return group.group
    return group


def default_group(group):
    """`group`, or the default group (every rank) for None: the entry points
    of dist_ba, dist_pgo and multihost take None for it."""
    return dist.group.WORLD if group is None else group


def rank(group) -> int:
    return dist.get_rank(_pg(group))


def world(group) -> int:
    return dist.get_world_size(_pg(group))


def lead(group) -> bool:
    """True on the rank that adds a replicated term into a sum that is then
    all-reduced (rank 0), and in a single-process solve."""
    return group is None or rank(group) == 0


def all_reduce(xs: list[torch.Tensor], group) -> list[torch.Tensor]:
    """The sum over the ranks of each tensor of `xs` (float32 partial sums,
    computed as the single-process solver computes its sums), packed into
    one buffer and reduced by one all_reduce in float64, then rounded back
    to float32 once. `group=None`: `xs`.

    An all_reduce in float32 rounds once per rank added, in an order of the
    backend's own; on a monocular BA, whose scale is a free gauge, that
    moved the cameras by 3.0e-4 at 4 ranks, against 1.2e-5 with the float64
    reduction, where the JAX package's sharded and unsharded solves agree to
    1e-4 (tests/test_torch_dist_ba.py). One rank is the unsharded sum."""
    if group is None:
        return xs
    flat = torch.cat([x.reshape(-1).double() for x in xs])
    dist.all_reduce(flat, group=_pg(group, "all_reduce"))
    out, i = [], 0
    for x in xs:
        out.append(flat[i:i + x.numel()].view(x.shape).to(x.dtype))
        i += x.numel()
    return out


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[world, *x.shape]: every rank's `x` (the same shape on every rank)."""
    parts = [torch.empty_like(x) for _ in range(world(group))]
    dist.all_gather(parts, x.contiguous(), group=_pg(group, "all_gather"))
    return torch.stack(parts)


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """`x` of rank `src` on every rank (in place; `x` must be contiguous)."""
    g = _pg(group, "broadcast")
    dist.broadcast(x, src=dist.get_global_rank(g, src), group=g)
    return x
