"""Sim(3) pose-graph optimization (the essential-graph solver).

Counterpart of orbslam2_tpu/ops/pose_graph.py (Optimizer::
OptimizeEssentialGraph, src/Optimizer.cpp:944-1280): g2o's BlockSolver_7_3
Levenberg over Sim3 vertices becomes a batched Gauss-Newton on [K, 7]
tangent updates:

- residual per edge: r = log(S_meas^-1 ∘ S_i ∘ S_j^-1) in the 7-dof
  tangent (identity information, as the reference's 7x7 identity,
  src/Optimizer.cpp:1026)
- Jacobians by central differences over the 14 basis perturbations of
  each endpoint, all in one batch (g2o also differentiates EdgeSim3
  numerically)
- normal equations solved matrix-free by block-Jacobi PCG over vertices;
  the 7x7 blocks and the per-edge couplings are summed by `seg_sum`, the
  order-fixed kernel of ops/cuda_kernels.py, over plans of e_i and e_j
  built once a call (so a solve repeats itself bit for bit)
- vertices updated by left-multiplicative Sim3 retraction; fixed vertices
  (the loop keyframe, :1000) masked out

The Gauss-Newton and CG loops are Python loops with no readback: their
guards (den > 1e-12, rz > 1e-20) are torch.where selects. f32 central
differences of sim3.log at eps = 1e-4 are noisy, so the port is held to
JAX by final poses and cost, not by Jacobians.

`group` shards the edges (parallel/dist_pgo.py) with the vertices
replicated: the vertex-indexed sums (the block diagonal and b with the cost,
the CG matvec) go through one all_reduce each (parallel/collectives.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import sim3
from ..parallel import collectives as COL
from . import cuda_kernels as CK

_EPS = 1e-4


def _vertex(svals, R, t, idx) -> dict:
    return {"s": svals[idx], "R": R[idx], "t": t[idx]}


def optimize_pose_graph(svals, R, t, fixed, e_i, e_j, meas_s, meas_R, meas_t,
                        e_valid, iters: int = 20, cg_iters: int = 32, group=None):
    """svals/R/t: [K], [K,3,3], [K,3] Sim3 vertices (world->kf); fixed [K]
    bool. e_i/e_j: [E] vertex indices; meas_*: the measured relative Sim3
    S_meas = S_i ∘ S_j^-1 at edge creation; e_valid [E] bool. Returns the
    updated (svals, R, t) and the cost before each iteration [iters].
    group: None, or a process group over which the edges are split
    (dist_pgo.shard_pgo) and the vertices replicated."""
    K = svals.shape[0]
    dev, dt = svals.device, svals.dtype
    e_i, e_j = e_i.long(), e_j.long()
    plan_i, plan_j = CK.seg_plan(e_i, K), CK.seg_plan(e_j, K)
    meas_inv = sim3.inverse({"s": meas_s, "R": meas_R, "t": meas_t})
    free = (~fixed).to(dt)[:, None]
    wE = e_valid.to(dt)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    # the 14 perturbations D_k = exp(+-eps e_k), [14] Sims
    D = sim3.exp(torch.cat([_EPS * eye7, -_EPS * eye7]))
    D = {k: v[:, None] for k, v in D.items()}               # broadcast over E
    lead = COL.lead(group)

    def residuals(Si, Sj):
        return sim3.log(sim3.compose(meas_inv, sim3.compose(Si, sim3.inverse(Sj))))

    def jac(r):  # [14, E, 7] -> [E, 7(res), 7(param)]
        return ((r[:7] - r[7:]) / (2 * _EPS)).permute(1, 2, 0)

    costs = []
    for _ in range(iters):
        Si = _vertex(svals, R, t, e_i)
        Sj = _vertex(svals, R, t, e_j)
        r0 = residuals(Si, Sj)                                  # [E, 7]
        Ji = jac(residuals(sim3.compose(D, Si), Sj))
        Jj = jac(residuals(Si, sim3.compose(D, Sj)))

        Hd = (CK.seg_sum(torch.einsum("eri,e,erj->eij", Ji, wE, Ji), plan_i)
              + CK.seg_sum(torch.einsum("eri,e,erj->eij", Jj, wE, Jj), plan_j))
        b = (CK.seg_sum(-torch.einsum("eri,e,er->ei", Ji, wE, r0), plan_i)
             + CK.seg_sum(-torch.einsum("eri,e,er->ei", Jj, wE, r0), plan_j))
        Hd, b, cost = COL.all_reduce([Hd, b, torch.sum(r0 * r0 * wE[:, None])], group)
        Hdiag = Hd + 1e-6 * eye7
        b = b * free
        Hij = torch.einsum("eri,e,erj->eij", Ji, wE, Jj)        # per-edge coupling

        def matvec(x):
            x = x * free
            # the replicated block-diagonal term enters the sum once
            y = (torch.einsum("kij,kj->ki", Hdiag, x) if lead
                 else torch.zeros_like(x))
            y = y + CK.seg_sum(torch.einsum("eij,ej->ei", Hij, x[e_j]), plan_i)
            y = y + CK.seg_sum(torch.einsum("eij,ei->ej", Hij, x[e_i]), plan_j)
            return COL.all_reduce([y], group)[0] * free

        Minv = torch.linalg.inv_ex(Hdiag)[0]

        def precond(v):
            return torch.einsum("kij,kj->ki", Minv, v) * free

        x, rr = torch.zeros_like(b), b
        z = precond(b)
        p, rz = z, torch.sum(b * z)
        for _ in range(cg_iters):
            Ap = matvec(p)
            den = torch.sum(p * Ap)
            ok = den > 1e-12
            alpha = torch.where(ok, rz / torch.where(ok, den, 1.0), 0.0)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = torch.sum(rr * z)
            beta = torch.where(rz > 1e-20, rz_new / torch.where(rz > 1e-20, rz, 1.0), 0.0)
            p = z + beta * p
            rz = rz_new
        dx = torch.where(torch.isfinite(x), x, 0.0) * free
        S = sim3.compose(sim3.exp(dx), {"s": svals, "R": R, "t": t})
        svals, R, t = S["s"], S["R"], S["t"]
        costs.append(cost)
    return svals, R, t, torch.stack(costs)


def synthetic_problem(K: int, E: int, seed: int = 0) -> tuple:
    """A seeded pose graph as numpy arrays, in optimize_pose_graph's
    argument order: K Sim(3) vertices on a ring of radius 3 m (vertex 0
    fixed), the K - 1 odometry edges and E - K + 1 more between vertices at
    most 8 apart (covisibility-like; endpoints repeat, edges in random
    order), each measured from the truth with noise; the vertices start
    from drifted poses, and 5% of the edges are invalid."""
    rng = np.random.default_rng(seed)

    def rot(w):
        th = np.linalg.norm(w)
        k = w / max(th, 1e-12)
        kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx

    ang = 2 * np.pi * np.arange(K) / K
    R = np.stack([rot(np.array([0.0, a, 0.0])) for a in ang])
    t = np.stack([3 * np.sin(ang), np.zeros(K), 3 * np.cos(ang)], -1)
    a = rng.integers(0, K, E - K + 1)
    b = (a + rng.integers(1, 9, len(a))) % K
    e_i = np.concatenate([np.arange(1, K), a])
    e_j = np.concatenate([np.arange(K - 1), b])
    order = rng.permutation(len(e_i))
    e_i, e_j = e_i[order], e_j[order]
    Rrel = np.einsum("eij,ekj->eik", R[e_i], R[e_j])         # R_i R_j^T
    noise = np.stack([rot(w) for w in rng.normal(0, 0.01, (len(e_i), 3))])
    mt = (t[e_i] - np.einsum("eij,ej->ei", Rrel, t[e_j])
          + rng.normal(0, 0.01, (len(e_i), 3)))
    drift = np.stack([rot(w) for w in rng.normal(0, 0.03, (K, 3))])
    f32 = np.float32
    return (np.ones(K, f32), (drift @ R).astype(f32),
            (t + rng.normal(0, 0.05, (K, 3))).astype(f32), np.arange(K) == 0,
            e_i, e_j, np.ones(len(e_i), f32), (noise @ Rrel).astype(f32),
            mt.astype(f32), rng.random(len(e_i)) > 0.05)
