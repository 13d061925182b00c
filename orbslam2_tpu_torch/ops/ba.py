"""Batched Schur-complement bundle adjustment (the g2o replacement).

Counterpart of orbslam2_tpu/ops/ba.py (Optimizer::LocalBundleAdjustment,
src/Optimizer.cpp:564-941, and the BundleAdjustment core, :44-304), which
replaces g2o's sparse BlockSolver_6_3 + OptimizationAlgorithmLevenberg:

- residuals and Jacobians of every observation edge in one batch (mono and
  stereo edges unified, ops/ba_core.py);
- block assembly by segment sums over the edge list (`seg_sum`, the
  order-fixed kernel of ops/cuda_kernels.py, so a solve repeats itself bit
  for bit as the JAX package's does): Hcc [C,6,6], Hpp [P,3,3], the
  per-edge coupling W [E,6,3]. The edge structure is fixed through a
  solve, so the sums' plans (`BAPlans`) are built once a solve;
- point marginalization by batched 3x3 inverses (the reference's
  `setMarginalized(true)` Schur trick, src/Optimizer.cpp:707);
- the reduced camera system S = Hcc - W Hpp^-1 W^T either formed and solved
  by dense Cholesky, or solved matrix-free by block-Jacobi preconditioned
  conjugate gradient (the form that shards across devices);
- Levenberg-Marquardt accept/reject as `torch.where` selects, in the
  reference's schedule: 5 iterations with Huber, the chi2 outlier cut
  (5.991 mono, 7.815 stereo), 10 more without (src/Optimizer.cpp:790-841).

Nothing is read back from the device inside a solve: the LM and CG
iterations are Python loops of device ops.

`group` shards the solve by point owner (parallel/dist_ba.py): each rank
holds its points and every edge of them, the cameras are replicated. The
camera-indexed sums (Hcc, the Schur rhs, the CG matvec) and the costs then
go through one all_reduce each (parallel/collectives.py); the point blocks
stay local; the LM accept/reject and the CG scalars are computed from
replicated values, so every rank takes the same branch.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3
from ..parallel import collectives as COL
from ..utils.device import upload
from . import ba_core as BC
from . import cuda_kernels as CK

MIN_DEPTH = 0.05    # meters; below this J ~ 1/z^2 risks f32 overflow
CHI2_TRIM = 1e5     # edges beyond this are excluded from the normal system
_CHOL_BLOCK = 64    # rows of a diagonal block of the CPU Cholesky (_cholesky)


class BAProblem(NamedTuple):
    """Fixed-shape BA problem. Invalid edges/cameras/points are masked."""

    cam_T: torch.Tensor      # [C, 3, 4] Tcw
    cam_fixed: torch.Tensor  # [C] bool (pose held constant)
    cam_valid: torch.Tensor  # [C] bool
    pts: torch.Tensor        # [P, 3] world points
    pt_valid: torch.Tensor   # [P] bool
    e_cam: torch.Tensor      # [E] int64 camera index
    e_pt: torch.Tensor       # [E] int64 point index
    e_obs: torch.Tensor      # [E, 3] (u, v, u_r)
    e_stereo: torch.Tensor   # [E] bool
    e_info: torch.Tensor     # [E] float32 (1/sigma^2)
    e_valid: torch.Tensor    # [E] bool


class BAPlans(NamedTuple):
    """The segment-sum plans of a problem's edges: by camera, by point, and
    by (point, camera) pair for the dense Schur step's coupling G (None
    where the solve is the CG one)."""

    cam: CK.SegPlan
    pt: CK.SegPlan
    pair: CK.SegPlan | None


def ba_plans(p: BAProblem, dense: bool) -> BAPlans:
    """The plans of p's edges, built on p's device without a readback. Every
    edge is in them, the invalid ones too (they carry zero weight), so the
    order of a sum does not depend on the mask."""
    C, P = p.cam_T.shape[0], p.pts.shape[0]
    pair = CK.seg_plan(p.e_pt.long() * C + p.e_cam.long(), P * C) if dense else None
    return BAPlans(CK.seg_plan(p.e_cam, C), CK.seg_plan(p.e_pt, P), pair)


class BAResult(NamedTuple):
    cam_T: torch.Tensor
    pts: torch.Tensor
    e_inlier: torch.Tensor   # [E] final chi2 classification
    cost: torch.Tensor


def _edge_terms(p: BAProblem, cam_T, pts, e_active, fx, fy, cx, cy, bf, robust):
    """Residuals, Jacobians and weights for every edge."""
    Te = cam_T[p.e_cam]                      # [E, 3, 4]
    Xe = pts[p.e_pt]                         # [E, 3]
    R, t = Te[..., :3], Te[..., 3]
    pc = torch.einsum("eij,ej->ei", R, Xe) + t
    z = pc[:, 2]
    iz = 1.0 / torch.where(z.abs() > 1e-6, z, 1e-6)
    u = fx * pc[:, 0] * iz + cx
    v = fy * pc[:, 1] * iz + cy
    ur = u - bf * iz
    res = torch.stack(
        [u - p.e_obs[:, 0], v - p.e_obs[:, 1],
         torch.where(p.e_stereo, ur - p.e_obs[:, 2], 0.0)], dim=-1)
    Jp, Jpc = BC.residual_jacobians(pc, p.e_stereo, fx, fy, bf)
    Jpt = Jpc @ R                            # world-point Jacobian [E, 3, 3]
    chi2, w = BC.chi2_and_weight(res, p.e_stereo, p.e_info, robust)
    # depth floor + hopeless-outlier trim: near-zero depth makes J ~ 1/z^2
    # overflow f32 in the H assembly
    usable = e_active & (z > MIN_DEPTH) & (chi2 < CHI2_TRIM)
    m = usable.to(torch.float32) * w * p.e_info
    # the accept/reject objective is the (robust) cost the step models
    rho = BC.robust_cost(chi2, p.e_stereo, robust)
    cost = torch.sum(torch.where(e_active & (z > MIN_DEPTH),
                                 torch.clamp(rho, max=CHI2_TRIM), 0.0))
    return res, Jp, Jpt, m, cost, chi2, z


def _cholesky(S: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor of the reduced camera system S (not
    checked: a factor of a system that is not positive definite gives a
    non-finite step, which the caller zeroes). On a card, cuSOLVER's. On
    the CPU, by diagonal blocks of _CHOL_BLOCK in a fixed order: LAPACK's
    threaded factorization (MKL's potrf at 4 threads) returned other bits
    for one S from one solve to the next at 384 rows (64 cameras, the
    mapper's largest local window; not at 96 or 192), which made two runs
    of the inline mapper part on the CPU (ROADMAP F4). A block this small
    is factored without threads, and the panel solves and updates repeat."""
    if S.device.type != "cpu":
        return torch.linalg.cholesky_ex(S, check_errors=False)[0]
    n = S.shape[0]
    L = torch.zeros_like(S)
    for j in range(0, n, _CHOL_BLOCK):
        e = min(j + _CHOL_BLOCK, n)
        L[j:e, j:e] = torch.linalg.cholesky_ex(
            S[j:e, j:e] - L[j:e, :j] @ L[j:e, :j].T, check_errors=False)[0]
        if e < n:
            panel = S[e:, j:e] - L[e:, :j] @ L[j:e, :j].T
            L[e:, j:e] = torch.linalg.solve_triangular(L[j:e, j:e], panel.T,
                                                       upper=False).T
    return L


def _dense_schur_step(p: BAProblem, plans: BAPlans, Hcc_d, Hpp_inv, W, rhs,
                      free_cam):
    """Form the reduced camera system S = Hcc_d - W Hpp^-1 W^T (one matrix
    product over the per-point camera coupling G [P, C, 6, 3]) and solve it
    by dense Cholesky, restricted to the free cameras."""
    C = Hcc_d.shape[0]
    P = Hpp_inv.shape[0]
    # G[p, c] = sum of W_e over the edges by which c observes p
    G = CK.seg_sum(W, plans.pair).reshape(P, C, 6, 3)
    Y = torch.einsum("pcij,pjk->pcik", G, Hpp_inv)
    # coupling[(c,i),(d,j)] = sum_{p,k} Y[p,c,i,k] G[p,d,j,k]
    Yf = Y.permute(1, 2, 0, 3).reshape(6 * C, 3 * P)
    Gf = G.permute(1, 2, 0, 3).reshape(6 * C, 3 * P)
    S = -(Yf @ Gf.T)
    diag = torch.arange(C, device=S.device)
    Sv = S.view(C, 6, C, 6)
    Sv[diag, :, diag, :] += Hcc_d
    # restrict to free cameras: identity rows/cols elsewhere (their rhs is 0)
    f = free_cam[:, 0].repeat_interleave(6)
    S = S * f[:, None] * f[None, :] + torch.diag(torch.where(f > 0, 1e-6, 1.0))
    L = _cholesky(S)
    dx = torch.cholesky_solve((rhs.reshape(-1) * f)[:, None], L)[:, 0]
    return (dx * f).reshape(C, 6)


def _lm_iteration(p: BAProblem, plans: BAPlans, cam_T, pts, lam, e_active, fx,
                  fy, cx, cy, bf, robust, cg_iters: int, dense_schur: bool = False,
                  group=None):
    res, Jp, Jpt, m, cost, _, _ = _edge_terms(
        p, cam_T, pts, e_active, fx, fy, cx, cy, bf, robust)

    free_cam = (p.cam_valid & ~p.cam_fixed).to(torch.float32)[:, None]

    # block assembly (segment sums over the edge list)
    Jpm = Jp * m[:, None, None]
    Jptm = Jpt * m[:, None, None]
    Hcc = CK.seg_sum(Jpm.transpose(1, 2) @ Jp, plans.cam)
    bc = CK.seg_sum(-torch.einsum("eri,er->ei", Jpm, res), plans.cam)
    Hpp = CK.seg_sum(Jptm.transpose(1, 2) @ Jpt, plans.pt)
    bp = CK.seg_sum(-torch.einsum("eri,er->ei", Jptm, res), plans.pt)
    W = Jpm.transpose(1, 2) @ Jpt  # [E, 6, 3]

    # LM damping (multiplicative on block diagonals)
    eye6 = torch.eye(6, device=cam_T.device)
    eye3 = torch.eye(3, device=cam_T.device)
    Hpp_d = Hpp + lam * Hpp * eye3 + 1e-8 * eye3
    Hpp_inv = torch.linalg.inv_ex(Hpp_d)[0]   # [P, 3, 3] point marginalization

    # Schur RHS: bc - W Hpp^-1 bp
    hb = torch.einsum("pij,pj->pi", Hpp_inv, bp)
    rhs = bc - CK.seg_sum(torch.einsum("eij,ej->ei", W, hb[p.e_pt]), plans.cam)
    Hcc, rhs, cost = COL.all_reduce([Hcc, rhs, cost], group)
    Hcc_d = Hcc + lam * Hcc * eye6 + 1e-8 * eye6
    rhs = rhs * free_cam

    if dense_schur:
        dx_c = _dense_schur_step(p, plans, Hcc_d, Hpp_inv, W, rhs, free_cam)
    else:
        dx_c = _pcg(p, plans, Hcc_d, Hpp_inv, W, rhs, free_cam, cg_iters, group)
    return _apply_step(p, plans, cam_T, pts, lam, e_active, fx, fy, cx, cy, bf,
                       robust, dx_c, Hpp_inv, W, bp, m, cost, free_cam, group)


def _pcg(p: BAProblem, plans: BAPlans, Hcc_d, Hpp_inv, W, rhs, free_cam,
         cg_iters: int, group=None):
    """Block-Jacobi preconditioned CG on the reduced camera system, matrix
    free: S @ x costs two edge gathers and two segment sums."""
    def S_mv(x):
        x = x * free_cam
        u = torch.einsum("eij,ei->ej", W, x[p.e_cam])          # [E, 3] = W^T x
        wp = torch.einsum("pij,pj->pi", Hpp_inv, CK.seg_sum(u, plans.pt))
        ze = torch.einsum("eij,ej->ei", W, wp[p.e_pt])         # [E, 6]
        y = (torch.einsum("cij,cj->ci", Hcc_d, x)
             - COL.all_reduce([CK.seg_sum(ze, plans.cam)], group)[0])
        return y * free_cam

    eye6 = torch.eye(6, device=Hcc_d.device)
    Minv = torch.linalg.inv_ex(Hcc_d + 1e-6 * eye6)[0]

    def precond(r):
        return torch.einsum("cij,cj->ci", Minv, r) * free_cam

    x = torch.zeros_like(rhs)
    r = rhs
    z = precond(r)
    pdir = z
    rz = torch.sum(r * z)
    for _ in range(cg_iters):
        Ap = S_mv(pdir)
        denom = torch.sum(pdir * Ap)
        # Krylov breakdown guard: along a near-null (gauge) direction
        # denom ~ 0; freeze the iterate there instead of dividing
        ok = denom > 1e-12
        alpha = torch.where(ok, rz / torch.where(ok, denom, 1.0), 0.0)
        x = x + alpha * pdir
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        big = rz > 1e-20
        beta = torch.where(big, rz_new / torch.where(big, rz, 1.0), 0.0)
        pdir = z + beta * pdir
        rz = rz_new
    return x


def _apply_step(p: BAProblem, plans: BAPlans, cam_T, pts, lam, e_active, fx, fy,
                cx, cy, bf, robust, dx_c, Hpp_inv, W, bp, m, cost, free_cam,
                group=None):
    """Point back-substitution + LM accept/reject for a camera step dx_c."""
    dx_c = torch.where(torch.isfinite(dx_c), dx_c, 0.0)
    # back-substitute points: dx_p = Hpp^-1 (bp - W^T dx_c)
    wtx = CK.seg_sum(torch.einsum("eij,ei->ej", W, dx_c[p.e_cam]), plans.pt)
    dx_p = torch.einsum("pij,pj->pi", Hpp_inv, bp - wtx)
    pt_has_edges = CK.seg_sum(m, plans.pt) > 0
    dx_p = torch.where((p.pt_valid & pt_has_edges)[:, None], dx_p, 0.0)
    dx_p = torch.where(torch.isfinite(dx_p), dx_p, 0.0)

    cam_T_new = se3.retract(cam_T, dx_c * free_cam)
    pts_new = pts + dx_p
    cost_new = COL.all_reduce([_edge_terms(p, cam_T_new, pts_new, e_active, fx,
                                           fy, cx, cy, bf, robust)[4]], group)[0]

    accept = cost_new < cost
    cam_T = torch.where(accept, cam_T_new, cam_T)
    pts = torch.where(accept, pts_new, pts)
    lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-8),
                      torch.clamp(lam * 4.0, max=1e6))
    return cam_T, pts, lam, torch.minimum(cost_new, cost)


def _classify(p: BAProblem, cam_T, pts, fx, fy, cx, cy, bf):
    _, _, _, _, _, chi2, z = _edge_terms(
        p, cam_T, pts, p.e_valid, fx, fy, cx, cy, bf, robust=False)
    th = torch.where(p.e_stereo, BC.CHI2_STEREO, BC.CHI2_MONO)
    return p.e_valid & (chi2 <= th) & (z > MIN_DEPTH)


# [P, C, 6, 3] f32 budget for the formed per-point camera coupling; above
# this the matrix-free CG path is used instead (512 MB at 72 B/entry)
_DENSE_SCHUR_MAX_PC = 7_000_000


def _use_dense_schur(C: int, P: int, solver: str) -> bool:
    if solver == "dense":
        return True
    if solver == "cg":
        return False
    return P * C <= _DENSE_SCHUR_MAX_PC and 6 * C <= 4096


def ba_solve(p: BAProblem, fx: float, fy: float, cx: float, cy: float,
             bf: float, iters1: int = 5, iters2: int = 10,
             cg_iters: int = 24, solver: str = "auto", group=None) -> BAResult:
    """Two-phase LM Schur BA (reference schedule: 5 iterations, outlier
    cut, 10 iterations, src/Optimizer.cpp:790-841). Huber in phase 1,
    plain in phase 2 (outliers excluded instead).

    solver: "dense" forms the reduced camera system and solves it by
    Cholesky, "cg" is the matrix-free preconditioned CG, "auto" takes dense
    when the [P, C] coupling fits.

    group: None for the whole problem in this process; a process group (or
    collectives.Counting) for this rank's shard of a problem sharded by
    point owner (parallel/dist_ba.shard_problem), which needs "cg"."""
    cam_T, pts = p.cam_T, p.pts
    lam = torch.full((), 1e-4, dtype=torch.float32, device=cam_T.device)
    cost = torch.full((), float("inf"), dtype=torch.float32, device=cam_T.device)
    dense = _use_dense_schur(cam_T.shape[0], pts.shape[0], solver)
    if dense and group is not None:
        raise ValueError("a sharded solve runs solver='cg': the dense Schur step "
                         "forms the reduced system from every point")
    plans = ba_plans(p, dense)

    e_active = p.e_valid
    for n, robust in ((iters1, True), (iters2, False)):
        for _ in range(n):
            cam_T, pts, lam, cost = _lm_iteration(
                p, plans, cam_T, pts, lam, e_active, fx, fy, cx, cy, bf, robust,
                cg_iters, dense_schur=dense, group=group)
        e_active = _classify(p, cam_T, pts, fx, fy, cx, cy, bf)
    return BAResult(cam_T=cam_T, pts=pts, e_inlier=e_active, cost=cost)


def synthetic_problem(C: int, P: int, E: int, seed: int = 0,
                      stereo_frac: float = 0.3) -> tuple[dict, tuple]:
    """A seeded BA problem as numpy arrays: C cameras on a forward
    trajectory (the first fixed) observing P points through E edges, mono
    and stereo mixed, 0.5 px observation noise, poses and points perturbed.
    Returns (arrays named as BAProblem's fields, (fx, fy, cx, cy, bf)):
    the same draws and roundings as the JAX package's
    __graft_entry__._make_ba_problem, array for array."""
    rng = np.random.default_rng(seed)
    fx = fy = 718.0
    cx, cy = 607.0, 185.0
    bf = 386.0
    s = rng.uniform(0, C * 0.8, P)
    pts = np.stack([rng.uniform(-12, 12, P), rng.uniform(-2, 3, P),
                    s + rng.uniform(4, 30, P)], -1).astype(np.float32)
    cams = np.stack([
        np.hstack([np.eye(3), np.array([[0.02 * i], [0.0], [-0.8 * i]])])
        for i in range(C)]).astype(np.float32)
    e_cam = rng.integers(0, C, E)
    e_pt = rng.integers(0, P, E)

    def visible():
        pc = np.einsum("eij,ej->ei", cams[e_cam, :, :3], pts[e_pt]) + cams[e_cam, :, 3]
        return pc, pc[:, 2] > 1.0

    pc, ok = visible()
    for _ in range(8):  # re-draw the edges that look behind their camera
        bad = ~ok
        if not bad.any():
            break
        e_cam[bad] = rng.integers(0, C, bad.sum())
        e_pt[bad] = rng.integers(0, P, bad.sum())
        pc, ok = visible()
    z = np.maximum(pc[:, 2], 1.0)
    obs = np.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy,
                    fx * pc[:, 0] / z + cx - bf / z], -1).astype(np.float32)
    obs[:, :2] += rng.normal(0, 0.5, (E, 2))
    stereo = rng.random(E) < stereo_frac
    shift = np.concatenate([np.zeros((C, 3, 3)), rng.normal(0, 0.02, (C, 3, 1))], -1)
    arrays = dict(
        cam_T=(cams + shift.astype(np.float32) * (np.arange(C) > 0)[:, None, None]
               ).astype(np.float32),
        cam_fixed=np.arange(C) < 1, cam_valid=np.ones(C, bool),
        pts=pts + rng.normal(0, 0.05, (P, 3)).astype(np.float32),
        pt_valid=np.ones(P, bool),
        e_cam=e_cam.astype(np.int32), e_pt=e_pt.astype(np.int32), e_obs=obs,
        e_stereo=stereo & ok, e_info=np.ones(E, np.float32), e_valid=ok)
    return arrays, (fx, fy, cx, cy, bf)


def problem_from_numpy(arrays: dict, device: torch.device) -> BAProblem:
    """BAProblem on `device` from numpy arrays named as its fields."""
    return BAProblem(**{k: upload(np.asarray(
        arrays[k], np.int64) if k in ("e_cam", "e_pt") else arrays[k], device)
        for k in BAProblem._fields})
