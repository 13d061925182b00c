"""Batched Horn closed-form Sim(3) RANSAC and Gauss-Newton refinement.

Counterpart of orbslam2_tpu/ops/sim3_solver.py (Sim3Solver,
src/Sim3Solver.cpp, and Optimizer::OptimizeSim3, src/Optimizer.cpp:
1281-1496). The reference runs sequential RANSAC over 3-point sets with
Horn 1987's closed form (ComputeSim3, :249-370); here all N_HYPOTHESES sets
are one leading axis: centroid removal, M = sum p1' p2'^T, the 4x4 N
matrix's dominant eigenvector as quaternion, the scale from the deviation
ratio (fixed to 1 for stereo/RGB-D, :321-341), two-way reprojection
inlier voting under the chi2 gate 9.210 sigma^2 (CheckInliers, :372-420),
then a weighted Horn refit on the winner's inliers, kept only if it loses
none.

The minimal sets are an input: `sim3_ransac` takes the [N_HYPOTHESES, 3]
index sets, or draws them without replacement from an explicit
torch.Generator (the JAX package draws them from threefry keys inside its
program, which torch cannot replay). q and -q give the same rotation, and
eigenvector signs differ between solvers: compare rotations, not
eigenvectors. Non-finite 4x4 matrices are zeroed before `eigh`, which
raises on them where JAX returns NaN.

It runs once per loop candidate, on the loop closer's thread.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import sim3 as s3

N_HYPOTHESES = 256
MIN_SET = 3
CHI2_GATE = 9.210


class Sim3Result(NamedTuple):
    s: torch.Tensor          # 0-d
    R: torch.Tensor          # [3, 3] maps cam2 coords into the cam1 frame
    t: torch.Tensor          # [3]
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # 0-d int


def _quat_R_2to1(q: torch.Tensor) -> torch.Tensor:
    """Horn's dominant eigenvector(s) [..., 4] (w, x, y, z) -> the rotation
    [..., 3, 3] mapping frame-2 points into frame 1 (with M = sum p1' p2'^T
    the raw quaternion rotation maps 1->2; transposed here)."""
    qw, qx, qy, qz = q.unbind(-1)
    R12 = torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
                     2 * (qx * qz + qy * qw)], -1),
        torch.stack([2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
                     2 * (qy * qz - qx * qw)], -1),
        torch.stack([2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
                     1 - 2 * (qx * qx + qy * qy)], -1),
    ], -2)
    return R12.transpose(-1, -2)


def _horn_rotation(M: torch.Tensor) -> torch.Tensor:
    """Horn's 4x4 N matrix of the cross-covariance M [..., 3, 3], its
    dominant eigenvector, and the rotation of it."""
    (Sxx, Sxy, Sxz), (Syx, Syy, Syz), (Szx, Szy, Szz) = (
        M[..., i, :].unbind(-1) for i in range(3))
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    N = torch.nan_to_num(N, nan=0.0, posinf=0.0, neginf=0.0)
    _, v = torch.linalg.eigh(N)
    return _quat_R_2to1(v[..., :, -1])


def _horn_sim3(P1: torch.Tensor, P2: torch.Tensor, fix_scale: bool):
    """Closed-form similarity aligning P2 -> P1. P1, P2: [..., M, 3].
    Returns (s [...], R [..., 3, 3], t [..., 3])."""
    c1 = P1.mean(-2)
    c2 = P2.mean(-2)
    q1 = P1 - c1[..., None, :]
    q2 = P2 - c2[..., None, :]
    R = _horn_rotation(q1.transpose(-1, -2) @ q2)
    if fix_scale:
        s = torch.ones(P1.shape[:-2], dtype=P1.dtype, device=P1.device)
    else:
        # s = sum(q1 . R q2) / sum |q2|^2 (src/Sim3Solver.cpp:321-341)
        num = torch.sum(q1 * (q2 @ R.transpose(-1, -2)), dim=(-1, -2))
        den = torch.sum(q2 * q2, dim=(-1, -2))
        s = num / torch.clamp(den, min=1e-12)
    t = c1 - s[..., None] * (R @ c2[..., None])[..., 0]
    return s, R, t


def draw_minimal_sets(valid: torch.Tensor, generator=None) -> torch.Tensor:
    """[N_HYPOTHESES, MIN_SET] row indices, each set drawn without
    replacement among the valid rows (at least MIN_SET must be valid)."""
    probs = valid.to(torch.float32)
    return torch.multinomial(probs.expand(N_HYPOTHESES, -1), MIN_SET,
                             replacement=False, generator=generator)


def _project(P, fx, fy, cx, cy):
    z = torch.clamp(P[..., 2], min=1e-6)
    return torch.stack([fx * P[..., 0] / z + cx, fy * P[..., 1] / z + cy], -1)


def _score(s, R, t, P1, P2, uv1_obs, uv2_obs, sigma2_1, sigma2_2, valid,
           fx, fy, cx, cy):
    """Two-way reprojection inliers of similarities s [H], R [H,3,3],
    t [H,3]: (counts [H], inliers [H, N])."""
    Rt = R.transpose(-1, -2)
    P2in1 = s[:, None, None] * (P2 @ Rt) + t[:, None]
    s_inv = 1.0 / torch.clamp(s, min=1e-12)
    P1in2 = s_inv[:, None, None] * ((P1 - t[:, None]) @ R)
    e1 = torch.sum((_project(P2in1, fx, fy, cx, cy) - uv1_obs) ** 2, -1) / sigma2_1
    e2 = torch.sum((_project(P1in2, fx, fy, cx, cy) - uv2_obs) ** 2, -1) / sigma2_2
    inl = valid & (e1 < CHI2_GATE) & (e2 < CHI2_GATE)
    return inl.sum(-1), inl


def sim3_ransac(P1, P2, sigma2_1, sigma2_2, valid,
                fx: float, fy: float, cx: float, cy: float,
                fix_scale: bool = False, *, idx=None, generator=None) -> Sim3Result:
    """P1/P2: [N, 3] matched 3D points in the two camera frames; sigma2_*:
    [N] per-match pixel variance (chi2 gate 9.210 sigma2,
    src/Sim3Solver.cpp:84-92); valid [N] bool. idx: the [N_HYPOTHESES, 3]
    minimal sets, drawn from `generator` when None. Returns the best S12
    (maps 2 -> 1); the hypothesis with the most inliers wins (the first
    among equals)."""
    if idx is None:
        idx = draw_minimal_sets(valid, generator)
    idx = idx.long()
    ss, Rs, ts = _horn_sim3(P1[idx], P2[idx], fix_scale)
    uv1_obs = _project(P1, fx, fy, cx, cy)
    uv2_obs = _project(P2, fx, fy, cx, cy)

    def score(s, R, t):
        return _score(s, R, t, P1, P2, uv1_obs, uv2_obs, sigma2_1, sigma2_2,
                      valid, fx, fy, cx, cy)

    counts, inls = score(ss, Rs, ts)
    best = counts.argmax()[None]  # index_select, not [best]: no wait
    s_b, R_b, t_b = ss.index_select(0, best), Rs.index_select(0, best), ts.index_select(0, best)
    inl_b, cnt_b = inls.index_select(0, best)[0], counts.index_select(0, best)[0]
    # refit on the winning inlier set (weighted Horn over all inliers)
    w = inl_b.to(P1.dtype)
    wsum = torch.clamp(w.sum(), min=1.0)
    c1 = torch.sum(P1 * w[:, None], 0) / wsum
    c2 = torch.sum(P2 * w[:, None], 0) / wsum
    q1 = (P1 - c1) * w[:, None]
    d2 = P2 - c2
    R = _horn_rotation(q1.T @ d2)
    if fix_scale:
        s = torch.ones((), dtype=P1.dtype, device=P1.device)
    else:
        num = torch.sum(q1 * (d2 @ R.T))
        den = torch.sum(w[:, None] * d2 ** 2)
        s = num / torch.clamp(den, min=1e-12)
    t = c1 - s * (R @ c2)
    cnt, inl = score(s[None], R[None], t[None])
    use_refit = cnt[0] >= cnt_b
    return Sim3Result(
        s=torch.where(use_refit, s, s_b[0]),
        R=torch.where(use_refit, R, R_b[0]),
        t=torch.where(use_refit, t, t_b[0]),
        inliers=torch.where(use_refit, inl[0], inl_b),
        n_inliers=torch.where(use_refit, cnt[0], cnt_b))


def _sim3_residuals(xi, s0, R0, t0, P1, P2, uv1, uv2, inv_s1, inv_s2,
                    fx, fy, cx, cy, fix_scale):
    """Two-way reprojection residuals of the perturbed similarities
    S = exp(xi) ∘ S0 (left-multiplicative 7-dof tangent), for a batch of
    perturbations xi [B, 7]: [B, 2N, 2]."""
    if fix_scale:
        xi = torch.cat([xi[:, :6], torch.zeros_like(xi[:, 6:])], -1)
    S = s3.compose(s3.exp(xi), s3.make(s0, R0, t0))
    s, R, t = S["s"], S["R"], S["t"]
    P2in1 = s[:, None, None] * (P2 @ R.transpose(-1, -2)) + t[:, None]
    P1in2 = (1.0 / s)[:, None, None] * ((P1 - t[:, None]) @ R)
    r1 = (_project(P2in1, fx, fy, cx, cy) - uv1) * inv_s1[:, None]
    r2 = (_project(P1in2, fx, fy, cx, cy) - uv2) * inv_s2[:, None]
    return torch.cat([r1, r2], dim=-2)


def optimize_sim3(s0, R0, t0, P1, P2, uv1, uv2, sigma2_1, sigma2_2, valid,
                  fx: float, fy: float, cx: float, cy: float,
                  fix_scale: bool = False, iters: int = 10):
    """Gauss-Newton refinement of a relative Sim3 over matched pairs (the
    reference's Optimizer::OptimizeSim3, src/Optimizer.cpp:1281-1496: g2o
    VertexSim3Expmap with paired forward/inverse projection edges,
    numerically differentiated). Central differences at eps = 1e-4, all 14
    perturbations and the base point in one batch; Huber weights at a
    normalized residual norm of 3.16. Returns (s, R, t, inliers,
    n_inliers)."""
    dev, dt = P1.device, P1.dtype
    inv_s1 = 1.0 / torch.sqrt(sigma2_1)
    inv_s2 = 1.0 / torch.sqrt(sigma2_2)
    w2 = torch.cat([valid, valid]).to(dt)
    eps = 1e-4
    eye7 = torch.eye(7, dtype=dt, device=dev)
    xis = torch.cat([torch.zeros(1, 7, dtype=dt, device=dev), eps * eye7, -eps * eye7])
    s = torch.as_tensor(s0, dtype=dt, device=dev).reshape(())
    R, t = R0, t0

    def residuals(xi, s, R, t):
        return _sim3_residuals(xi, s, R, t, P1, P2, uv1, uv2, inv_s1, inv_s2,
                               fx, fy, cx, cy, fix_scale)

    for _ in range(iters):
        r = residuals(xis, s, R, t)                       # [15, 2N, 2]
        base = r[0]
        # Huber weights at sqrt(10) normalized-residual norm (delta ~ chi2 10)
        nrm = torch.linalg.vector_norm(base, dim=-1)
        hub = torch.where(nrm <= 3.16, 1.0, 3.16 / torch.clamp(nrm, min=1e-9))
        wgt = w2 * hub
        J = ((r[1:8] - r[8:15]) / (2 * eps)).permute(1, 2, 0)  # [2N, 2, 7]
        H = torch.einsum("nri,n,nrj->ij", J, wgt, J) + 1e-6 * eye7
        g = -torch.einsum("nri,n,nr->i", J, wgt, base)
        dx = torch.linalg.solve_ex(H, g[:, None], check_errors=False)[0][:, 0]
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        if fix_scale:
            dx = torch.cat([dx[:6], torch.zeros_like(dx[6:])])
        S = s3.compose(s3.exp(dx), s3.make(s, R, t))
        s, R, t = S["s"], S["R"], S["t"]
    # final chi2 classification at 9.210 per direction
    # (src/Optimizer.cpp:1435-1445 drops edges above chi2 10)
    base = residuals(xis[:1], s, R, t)[0]
    n = P1.shape[0]
    chi1 = torch.sum(base[:n] ** 2, -1)
    chi2 = torch.sum(base[n:] ** 2, -1)
    inl = valid & (chi1 < CHI2_GATE) & (chi2 < CHI2_GATE)
    return s, R, t, inl, inl.sum()
