"""Shared reprojection residual and Jacobian machinery for the optimizers.

Counterpart of orbslam2_tpu/ops/ba_core.py (g2o's EdgeSE3ProjectXYZ and
EdgeStereoSE3ProjectXYZ, Thirdparty/g2o/g2o/types/types_six_dof_expmap.h:91,
:147): one batched residual [du, dv, du_r] with analytic Jacobians w.r.t. the
left-multiplicative se(3) twist and the point; the third row is masked off
for monocular observations.

Robust weighting follows the reference: Huber delta sqrt(5.991) mono,
sqrt(7.815) stereo (src/Optimizer.cpp:347-348), information = 1/sigma^2 of
the observation's octave (src/Optimizer.cpp:376-377).
"""
from __future__ import annotations

import torch

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
HUBER_MONO = CHI2_MONO ** 0.5
HUBER_STEREO = CHI2_STEREO ** 0.5


def project_residual(T, pts_w, obs_uvr, is_stereo, fx, fy, cx, cy, bf):
    """T: [3, 4] world->cam; pts_w: [N, 3]; obs_uvr: [N, 3] = (u, v, u_right).
    Returns (res [N, 3], pc [N, 3]) with res row 2 zeroed for mono obs."""
    R, t = T[..., :3], T[..., 3]
    pc = pts_w @ R.T + t
    z = pc[:, 2]
    inv_z = 1.0 / torch.where(z.abs() > 1e-6, z, 1e-6)
    u = fx * pc[:, 0] * inv_z + cx
    v = fy * pc[:, 1] * inv_z + cy
    ur = u - bf * inv_z
    res = torch.stack(
        [u - obs_uvr[:, 0], v - obs_uvr[:, 1],
         torch.where(is_stereo, ur - obs_uvr[:, 2], 0.0)], dim=-1)
    return res, pc


def residual_jacobians(pc, is_stereo, fx, fy, bf):
    """Analytic Jacobians of the [du, dv, du_r] residual at camera-frame
    points pc [N, 3]. Returns (J_pose [N, 3, 6] w.r.t. the left twist [v, w]
    of Tcw, J_point_cam [N, 3, 3])."""
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    z = torch.where(z.abs() > 1e-6, z, 1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    r0 = torch.stack([fx * iz, zero, -fx * x * iz2], -1)
    r1 = torch.stack([zero, fy * iz, -fy * y * iz2], -1)
    r2 = torch.stack([fx * iz, zero, -fx * x * iz2 + bf * iz2], -1)
    r2 = torch.where(is_stereo[:, None], r2, 0.0)
    J_pc = torch.stack([r0, r1, r2], dim=1)  # [N, 3, 3]
    # d(pc)/d(twist): pc' = exp(xi) pc => d/dv = I, d/dw = -[pc]x
    skew = torch.stack(
        [
            torch.stack([zero, pc[:, 2], -pc[:, 1]], -1),
            torch.stack([-pc[:, 2], zero, pc[:, 0]], -1),
            torch.stack([pc[:, 1], -pc[:, 0], zero], -1),
        ],
        dim=1,
    )
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(skew.shape)
    J_twist = torch.cat([eye, skew], dim=-1)  # [N, 3, 6]
    return J_pc @ J_twist, J_pc


def chi2_and_weight(res, is_stereo, info, robust: bool):
    """Per-observation chi2 and IRLS Huber weight. res: [N, 3]; info: [N]."""
    sq = torch.sum(res * res, dim=-1) * info
    if robust:
        delta = torch.sqrt(torch.where(is_stereo, CHI2_STEREO, CHI2_MONO))
        norm = torch.sqrt(torch.clamp(sq, min=1e-12))
        w = torch.where(norm <= delta, 1.0, delta / norm)
    else:
        w = torch.ones_like(sq)
    return sq, w


def robust_cost(chi2, is_stereo, robust: bool):
    """The objective the LM accept test tracks: the Huber rho(chi2) when the
    kernel is active (g2o RobustKernelHuber::robustify), chi2 otherwise."""
    if not robust:
        return chi2
    delta2 = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    delta = torch.sqrt(delta2)
    return torch.where(chi2 <= delta2, chi2,
                       2.0 * delta * torch.sqrt(torch.clamp(chi2, min=1e-12)) - delta2)
