"""Motion-only bundle adjustment (the per-frame pose optimizer).

Counterpart of orbslam2_tpu/ops/pose_opt.py (Optimizer::PoseOptimization,
src/Optimizer.cpp:306-562): 4 rounds x 10 LM iterations on one SE3 pose with
unary reprojection edges; after each round observations are re-classified
by chi2 (5.991 mono / 7.815 stereo); the Huber kernel is dropped after round
2 (:491-492).

The 6x6 normal system is built by masked reductions over all N
observations. Accept/reject is a `torch.where` select and the solve is
`torch.linalg.solve_ex` without its error check, so the 40 iterations run
without reading anything back from the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from . import ba_core as BC


class PoseOptResult(NamedTuple):
    T: torch.Tensor        # [3, 4] optimized Tcw
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor


def _residuals(T, pts, obs, is_stereo, info, active, fx, fy, cx, cy, bf, robust):
    res, pc = BC.project_residual(T, pts, obs, is_stereo, fx, fy, cx, cy, bf)
    chi2, w = BC.chi2_and_weight(res, is_stereo, info, robust)
    depth_ok = pc[:, 2] > 0.05  # f32-safe depth floor
    # the accept/reject objective is the same (robust) cost the step model
    # minimizes (ba_core.robust_cost)
    rho = BC.robust_cost(chi2, is_stereo, robust)
    cost = torch.sum(torch.where(active & depth_ok, torch.clamp(rho, max=1e6), 0.0))
    return res, pc, chi2, w, depth_ok, cost


def _normal_system(T, pts, obs, is_stereo, info, active, fx, fy, cx, cy, bf, robust):
    res, pc, chi2, w, depth_ok, cost = _residuals(
        T, pts, obs, is_stereo, info, active, fx, fy, cx, cy, bf, robust)
    Jp, _ = BC.residual_jacobians(pc, is_stereo, fx, fy, bf)
    m = (active & depth_ok & (chi2 < 1e5)).to(torch.float32) * w * info
    H = torch.einsum("nri,n,nrj->ij", Jp, m, Jp)
    g = -torch.einsum("nri,n,nr->i", Jp, m, res)
    return H, g, cost


def _lm_rounds(T, pts, obs, is_stereo, info, active, fx, fy, cx, cy, bf,
               robust: bool, n_iters: int):
    lam = torch.full((), 1e-3, dtype=torch.float32, device=T.device)
    eye6 = torch.eye(6, dtype=torch.float32, device=T.device)
    for _ in range(n_iters):
        H, g, cost = _normal_system(
            T, pts, obs, is_stereo, info, active, fx, fy, cx, cy, bf, robust)
        Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
        dx = torch.linalg.solve_ex(Hd, g[:, None], check_errors=False)[0][:, 0]
        T_new = se3.retract(T, dx)
        cost_new = _residuals(T_new, pts, obs, is_stereo, info, active,
                              fx, fy, cx, cy, bf, robust)[-1]
        accept = cost_new < cost
        T = torch.where(accept, T_new, T)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                          torch.clamp(lam * 4.0, max=1e4))
    return T


def pose_optimize(T0, pts, obs_uvr, is_stereo, octave_sigma2_inv, valid,
                  fx: float, fy: float, cx: float, cy: float, bf: float
                  ) -> PoseOptResult:
    """Optimize a single camera pose against fixed world points.

    T0: [3, 4] initial Tcw; pts: [N, 3] world points; obs_uvr: [N, 3]
    (u, v, u_r); is_stereo: [N] bool; octave_sigma2_inv: [N] information;
    valid: [N] initial edge validity."""
    inliers = valid
    T = T0
    for rnd in range(4):
        robust = rnd < 2  # kernel dropped after round 2 (src/Optimizer.cpp:491)
        T = _lm_rounds(T, pts, obs_uvr, is_stereo, octave_sigma2_inv,
                       inliers, fx, fy, cx, cy, bf, robust, n_iters=10)
        # re-classify ALL valid observations at the new pose (:450-526)
        res, pc = BC.project_residual(T, pts, obs_uvr, is_stereo, fx, fy, cx, cy, bf)
        chi2, _ = BC.chi2_and_weight(res, is_stereo, octave_sigma2_inv, robust=False)
        th = torch.where(is_stereo, BC.CHI2_STEREO, BC.CHI2_MONO)
        inliers = valid & (chi2 <= th) & (pc[:, 2] > 0.05)
    return PoseOptResult(T=T, inliers=inliers, n_inliers=inliers.sum())
