"""Plain bundle adjustment: the reference that the global-BA cells' outputs
are held to.

The same problem and schedule as the port's `ops.ba.ba_solve` chunks
(ORB-SLAM2's Optimizer::BundleAdjustment as the port states it: Levenberg-
Marquardt on the Schur complement of the points, Huber-weighted iterations,
the chi2 classification (5.991 mono, 7.815 stereo), then unweighted ones,
block-Jacobi preconditioned CG on the reduced camera system), written
from that description in plain PyTorch: `index_add_` for every block sum, a
batched inverse for every 3x3 and 6x6 block, the exact SE(3) exponential. It
runs in float64 by default. With dtype=float32 and tf32=True it is the
control: every matrix product takes its operands rounded to TF32 (10
mantissa bits, as a tensor core reads them) and adds in float32. The
rounding is done here rather than left to `allow_tf32`, because the batched
3x3 and 6x3 products of a BA run on cuBLAS's float32 gemv kernels, which
ignore that switch. It imports nothing of the port.
"""
from __future__ import annotations

import math

import torch

CHI2_MONO, CHI2_STEREO = 5.991, 7.815
MIN_DEPTH = 0.05
CHI2_TRIM = 1e5


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (the low 13 of the 23
    mantissa bits cleared, ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def matmul(tf32: bool):
    """The matrix product of the reference: plain, or on TF32 operands."""
    if not tf32:
        return torch.matmul
    return lambda a, b: torch.matmul(to_tf32(a), to_tf32(b))


def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def se3_exp(xi, mm=torch.matmul):
    """Twist [v, w] -> [R | J_l(w) v]: Rodrigues with its left Jacobian, the
    series below a rotation of 1e-4 rad."""
    v, w = xi[..., :3], xi[..., 3:]
    th2 = (w * w).sum(-1)[..., None, None]
    th = th2.sqrt()
    small = th2 < 1e-8
    safe = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1 - th2 / 6, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(safe)) / (safe * safe))
    c = torch.where(small, 1.0 / 6 - th2 / 120, (safe - torch.sin(safe)) / (safe ** 3))
    W = _hat(w)
    W2 = mm(W, W)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a * W + b * W2
    Jl = eye + b * W + c * W2
    return torch.cat([R, mm(Jl, v[..., None])], -1)


def _compose(A, B, mm=torch.matmul):
    return torch.cat([mm(A[..., :3], B[..., :3]), mm(A[..., :3], B[..., 3:]) + A[..., 3:]], -1)


def _segsum(x, index, n):
    return torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device).index_add_(0, index, x)


class Problem:
    """The problem's fixed part in the reference's precision."""

    def __init__(self, p: dict, dtype, tf32: bool = False):
        self.dtype = dtype
        self.mm = matmul(tf32)
        self.e_cam, self.e_pt = p["e_cam"].long(), p["e_pt"].long()
        self.obs = p["e_obs"].to(dtype)
        self.stereo = p["e_stereo"]
        self.info = p["e_info"].to(dtype)
        self.e_valid = p["e_valid"]
        self.pt_valid = p["pt_valid"]
        self.free = (p["cam_valid"] & ~p["cam_fixed"]).to(dtype)[:, None]
        self.C, self.P = p["cam_T"].shape[0], p["pts"].shape[0]
        self.fx, self.fy, self.cx, self.cy, self.bf = p["intrinsics"]
        self.delta2 = torch.where(self.stereo, CHI2_STEREO, CHI2_MONO).to(dtype)

    def edges(self, cam_T, pts, active, robust):
        """Residuals, Jacobians (twist and point), weights, cost, chi2, depth."""
        T = cam_T[self.e_cam]
        R, t = T[..., :3], T[..., 3]
        pc = self.mm(R, pts[self.e_pt][..., None])[..., 0] + t
        x, y, z = pc.unbind(-1)
        iz = 1.0 / torch.where(z.abs() > 1e-6, z, torch.full_like(z, 1e-6))
        u = self.fx * x * iz + self.cx
        v = self.fy * y * iz + self.cy
        res = torch.stack([u - self.obs[:, 0], v - self.obs[:, 1],
                           torch.where(self.stereo, u - self.bf * iz - self.obs[:, 2],
                                       torch.zeros_like(u))], -1)
        zero = torch.zeros_like(x)
        iz2 = iz * iz
        third = torch.stack([self.fx * iz, zero, -self.fx * x * iz2 + self.bf * iz2], -1)
        J_pc = torch.stack([
            torch.stack([self.fx * iz, zero, -self.fx * x * iz2], -1),
            torch.stack([zero, self.fy * iz, -self.fy * y * iz2], -1),
            torch.where(self.stereo[:, None], third, torch.zeros_like(third))], 1)
        eye = torch.eye(3, dtype=self.dtype, device=pc.device).expand(len(pc), 3, 3)
        Jp = self.mm(J_pc, torch.cat([eye, -_hat(pc)], -1))  # [E, 3, 6]
        Jx = self.mm(J_pc, R)                                # [E, 3, 3]
        chi2 = (res * res).sum(-1) * self.info
        norm = chi2.clamp(min=1e-12).sqrt()
        delta = self.delta2.sqrt()
        if robust:
            w = torch.where(norm <= delta, torch.ones_like(norm), delta / norm)
            rho = torch.where(chi2 <= self.delta2, chi2, 2 * delta * norm - self.delta2)
        else:
            w, rho = torch.ones_like(chi2), chi2
        usable = active & (z > MIN_DEPTH) & (chi2 < CHI2_TRIM)
        m = usable.to(self.dtype) * w * self.info
        cost = torch.where(active & (z > MIN_DEPTH), rho.clamp(max=CHI2_TRIM),
                           torch.zeros_like(rho)).sum()
        return res, Jp, Jx, m, cost, chi2, z

    def cost(self, cam_T, pts, active, robust):
        return self.edges(cam_T, pts, active, robust)[4]

    def classify(self, cam_T, pts):
        _, _, _, _, _, chi2, z = self.edges(cam_T, pts, self.e_valid, False)
        th = torch.where(self.stereo, CHI2_STEREO, CHI2_MONO)
        return self.e_valid & (chi2 <= th) & (z > MIN_DEPTH)


def lm_iteration(pb: Problem, cam_T, pts, lam, active, robust, cg_iters):
    """One damped Gauss-Newton step, kept if it lowers the cost at the
    current point. Returns (cam_T, pts, lam, the lower of the two costs)."""
    mm = pb.mm
    res, Jp, Jx, m, cost, _, _ = pb.edges(cam_T, pts, active, robust)
    Jpm, Jxm = Jp * m[:, None, None], Jx * m[:, None, None]
    Hcc = _segsum(mm(Jpm.transpose(1, 2), Jp), pb.e_cam, pb.C)
    bc = _segsum(-mm(Jpm.transpose(1, 2), res[..., None])[..., 0], pb.e_cam, pb.C)
    Hpp = _segsum(mm(Jxm.transpose(1, 2), Jx), pb.e_pt, pb.P)
    bp = _segsum(-mm(Jxm.transpose(1, 2), res[..., None])[..., 0], pb.e_pt, pb.P)
    W = mm(Jpm.transpose(1, 2), Jx)                       # [E, 6, 3]
    eye3 = torch.eye(3, dtype=pb.dtype, device=pts.device)
    eye6 = torch.eye(6, dtype=pb.dtype, device=pts.device)
    Hpp_inv = torch.linalg.inv_ex(Hpp + lam * Hpp * eye3 + 1e-8 * eye3)[0]
    hb = mm(Hpp_inv, bp[..., None])[..., 0]
    rhs = bc - _segsum(mm(W, hb[pb.e_pt][..., None])[..., 0], pb.e_cam, pb.C)
    Hcc_d = Hcc + lam * Hcc * eye6 + 1e-8 * eye6
    rhs = rhs * pb.free
    dx = pcg(pb, Hcc_d, Hpp_inv, W, rhs, cg_iters)

    dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
    wtx = _segsum(mm(W.transpose(1, 2), dx[pb.e_cam][..., None])[..., 0], pb.e_pt, pb.P)
    dxp = mm(Hpp_inv, (bp - wtx)[..., None])[..., 0]
    has_edges = _segsum(m, pb.e_pt, pb.P) > 0
    dxp = torch.where((pb.pt_valid & has_edges)[:, None], dxp, torch.zeros_like(dxp))
    dxp = torch.where(torch.isfinite(dxp), dxp, torch.zeros_like(dxp))
    cam_new = _compose(se3_exp(dx * pb.free, mm), cam_T, mm)
    pts_new = pts + dxp
    cost_new = pb.cost(cam_new, pts_new, active, robust)
    accept = cost_new < cost
    cam_T = torch.where(accept, cam_new, cam_T)
    pts = torch.where(accept, pts_new, pts)
    lam = torch.where(accept, (lam * 0.5).clamp(min=1e-8), (lam * 4.0).clamp(max=1e6))
    return cam_T, pts, lam, torch.minimum(cost_new, cost)


def pcg(pb: Problem, Hcc_d, Hpp_inv, W, rhs, iters):
    """Block-Jacobi preconditioned CG on S = Hcc_d - W Hpp^-1 W^T, matrix-free,
    for `iters` steps from 0 (breakdown guards: a step along a direction of
    no curvature is 0; beta is 0 once r.z vanishes)."""
    mm = pb.mm
    eye6 = torch.eye(6, dtype=pb.dtype, device=rhs.device)
    Minv = torch.linalg.inv_ex(Hcc_d + 1e-6 * eye6)[0]

    def S(x):
        x = x * pb.free
        u = mm(W.transpose(1, 2), x[pb.e_cam][..., None])[..., 0]
        wp = mm(Hpp_inv, _segsum(u, pb.e_pt, pb.P)[..., None])[..., 0]
        ze = mm(W, wp[pb.e_pt][..., None])[..., 0]
        return (mm(Hcc_d, x[..., None])[..., 0] - _segsum(ze, pb.e_cam, pb.C)) * pb.free

    def M(r):
        return mm(Minv, r[..., None])[..., 0] * pb.free

    x = torch.zeros_like(rhs)
    r = rhs
    z = M(r)
    d = z
    rz = (r * z).sum()
    one = torch.ones((), dtype=pb.dtype, device=rhs.device)
    zero = torch.zeros_like(one)
    for _ in range(iters):
        Ad = S(d)
        den = (d * Ad).sum()
        ok = den > 1e-12
        alpha = torch.where(ok, rz / torch.where(ok, den, one), zero)
        x = x + alpha * d
        r = r - alpha * Ad
        z = M(r)
        rz_new = (r * z).sum()
        big = rz > 1e-20
        beta = torch.where(big, rz_new / torch.where(big, rz, one), zero)
        d = z + beta * d
        rz = rz_new
    return x


def solve(pb: Problem, cam_T, pts, iters1, iters2, cg_iters):
    """One chunk: iters1 Huber iterations, classify, iters2 plain ones,
    classify; LM damping from 1e-4, the first cost that of the start."""
    lam = torch.full((), 1e-4, dtype=pb.dtype, device=pts.device)
    cost = torch.full((), math.inf, dtype=pb.dtype, device=pts.device)
    active = pb.e_valid
    for n, robust in ((iters1, True), (iters2, False)):
        for _ in range(n):
            cam_T, pts, lam, cost = lm_iteration(pb, cam_T, pts, lam, active,
                                                 robust, cg_iters)
        active = pb.classify(cam_T, pts)
    return cam_T, pts, active, cost


def global_ba(problem: dict, chunks: int, iters1: int, iters2: int, cg_iters: int,
              dtype=torch.float64, tf32: bool = False):
    """The GBA schedule: `chunks` solves, each from the last one's poses and
    points. Returns (cam_T, pts, inlier, cost) in `dtype`."""
    pb = Problem(problem, dtype, tf32)
    cam_T, pts = problem["cam_T"].to(dtype), problem["pts"].to(dtype)
    with torch.no_grad():
        for _ in range(chunks):
            cam_T, pts, inlier, cost = solve(pb, cam_T, pts, iters1, iters2, cg_iters)
    return cam_T, pts, inlier, cost
