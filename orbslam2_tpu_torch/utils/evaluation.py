"""Trajectory evaluation: ATE RMSE with Umeyama alignment (the metric used
by the TUM RGB-D benchmark scripts that consume the reference's trajectory
output, cf. SaveTrajectoryTUM src/System.cpp:307-370)."""
from __future__ import annotations

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform dst ~ s R src + t.
    src, dst: [N, 3]. Returns (s, R, t)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12)) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_centers: np.ndarray, gt_centers: np.ndarray,
             with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after (Sim3 for mono / SE3 otherwise)
    alignment. est/gt: [N, 3] camera centers, time-aligned."""
    s, R, t = umeyama(est_centers, gt_centers, with_scale)
    aligned = (s * (R @ est_centers.T)).T + t
    return float(np.sqrt(((aligned - gt_centers) ** 2).sum(-1).mean()))


def camera_centers(Tcw: np.ndarray) -> np.ndarray:
    """[F, 3, 4] world->cam poses -> [F, 3] camera centers."""
    R = Tcw[:, :, :3]
    t = Tcw[:, :, 3]
    return -np.einsum("nij,nj->ni", R.transpose(0, 2, 1), t)
