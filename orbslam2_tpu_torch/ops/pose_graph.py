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
  the 7x7 blocks and the per-edge couplings are summed with index_add_
- vertices updated by left-multiplicative Sim3 retraction; fixed vertices
  (the loop keyframe, :1000) masked out

The Gauss-Newton and CG loops are Python loops with no readback: their
guards (den > 1e-12, rz > 1e-20) are torch.where selects. f32 central
differences of sim3.log at eps = 1e-4 are noisy, so the port is held to
JAX by final poses and cost, not by Jacobians.
"""
from __future__ import annotations

import torch

from ..geometry import sim3

_EPS = 1e-4


def _vertex(svals, R, t, idx) -> dict:
    return {"s": svals[idx], "R": R[idx], "t": t[idx]}


def _seg(x, idx, K):
    out = torch.zeros((K,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add_(0, idx, x)


def optimize_pose_graph(svals, R, t, fixed, e_i, e_j, meas_s, meas_R, meas_t,
                        e_valid, iters: int = 20, cg_iters: int = 32):
    """svals/R/t: [K], [K,3,3], [K,3] Sim3 vertices (world->kf); fixed [K]
    bool. e_i/e_j: [E] vertex indices; meas_*: the measured relative Sim3
    S_meas = S_i ∘ S_j^-1 at edge creation; e_valid [E] bool. Returns the
    updated (svals, R, t) and the cost before each iteration [iters]."""
    K = svals.shape[0]
    dev, dt = svals.device, svals.dtype
    e_i, e_j = e_i.long(), e_j.long()
    meas_inv = sim3.inverse({"s": meas_s, "R": meas_R, "t": meas_t})
    free = (~fixed).to(dt)[:, None]
    wE = e_valid.to(dt)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    # the 14 perturbations D_k = exp(+-eps e_k), [14] Sims
    D = sim3.exp(torch.cat([_EPS * eye7, -_EPS * eye7]))
    D = {k: v[:, None] for k, v in D.items()}               # broadcast over E

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

        Hdiag = (_seg(torch.einsum("eri,e,erj->eij", Ji, wE, Ji), e_i, K)
                 + _seg(torch.einsum("eri,e,erj->eij", Jj, wE, Jj), e_j, K)
                 + 1e-6 * eye7)
        b = (_seg(-torch.einsum("eri,e,er->ei", Ji, wE, r0), e_i, K)
             + _seg(-torch.einsum("eri,e,er->ei", Jj, wE, r0), e_j, K)) * free
        Hij = torch.einsum("eri,e,erj->eij", Ji, wE, Jj)        # per-edge coupling

        def matvec(x):
            x = x * free
            y = torch.einsum("kij,kj->ki", Hdiag, x)
            y = y + _seg(torch.einsum("eij,ej->ei", Hij, x[e_j]), e_i, K)
            y = y + _seg(torch.einsum("eij,ei->ej", Hij, x[e_i]), e_j, K)
            return y * free

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
        costs.append(torch.sum(r0 * r0 * wE[:, None]))
    return svals, R, t, torch.stack(costs)
