"""Batched PnP RANSAC for relocalization.

Counterpart of orbslam2_tpu/ops/pnp.py (PnPsolver, src/PnPsolver.cpp,
Lepetit's EPnP + RANSAC): the reference iterates 300 sequential RANSAC
rounds of 4-point EPnP (src/PnPsolver.cpp:472-1106: control points,
barycentric coordinates, the beta cases over the 12x12 kernel, Gauss-Newton
on beta, Horn absolute orientation); here the same pipeline runs on all
hypotheses at once, a leading dimension where the JAX package uses
jax.vmap, and a second one over the five beta seeds. Every stage is
fixed-size linear algebra (3x3 and 12x12 eigendecompositions, 6xk least
squares, an 8-step Gauss-Newton on beta). The winning pose is always refined
by the LM pose optimizer afterwards (Tracking::Relocalization does the same,
src/Tracking.cpp:1890-1950).

RANSAC parameters mirror SetRansacParameters defaults used at
src/Tracking.cpp:1851: 300 iterations max (256 here, all at once), chi2
threshold 5.991 * sigma^2(octave).

The minimal sets are an input: `pnp_ransac` takes the [256, 4] index sets,
or draws them without replacement from an explicit torch.Generator (the JAX
package draws them from threefry keys inside its program, which torch cannot
replay). A 4-point set leaves the 12x12 system an exactly 4-dimensional
kernel with an arbitrary `eigh` basis, and eigenvector signs differ between
solvers, so single hypotheses are compared by what they achieve, not
elementwise.

The decompositions (`torch.linalg.eigh`, `svd`, `pinv`) may wait for the
device; relocalization is a staged, host-driven path that runs when
tracking is lost, never inside the per-frame step. Non-finite intermediates
(a degenerate sample) are zeroed before a decomposition, which would raise
on them, and their seed is given an infinite error.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

N_HYPOTHESES = 256
MIN_SET = 4  # EPnP minimal sample (mRansacMinSet, src/Tracking.cpp:1851)
GN_ITERS = 8
_EPS = 1e-9
_PAIR_I = (0, 0, 0, 1, 1, 2)
_PAIR_J = (1, 2, 3, 2, 3, 3)


class PnPResult(NamedTuple):
    T: torch.Tensor          # [3, 4] best hypothesis pose
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # 0-d int


def _pinv(A):
    """Moore-Penrose pseudo-inverse with jnp.linalg.pinv's default cutoff
    (10 * max(m, n) * eps of the largest singular value)."""
    m, n = A.shape[-2:]
    return torch.linalg.pinv(A, rtol=10.0 * max(m, n) * torch.finfo(A.dtype).eps)


def _finite(x):
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def _gauss_newton(L, rho, b):
    """8 iterations on ||L @ betas10(b) - rho|| (PnPsolver::gauss_newton).
    L: [H, 6, 10]; rho: [H, 6]; b: [H, S, 4] -> [H, S, 4]."""
    eye = _EPS * torch.eye(4, dtype=b.dtype, device=b.device)
    for _ in range(GN_ITERS):
        b1, b2, b3, b4 = b.unbind(-1)
        z = torch.zeros_like(b1)
        b10 = torch.stack([b1 * b1, b1 * b2, b2 * b2, b1 * b3, b2 * b3,
                           b3 * b3, b1 * b4, b2 * b4, b3 * b4, b4 * b4], -1)
        r = torch.einsum("hpq,hsq->hsp", L, b10) - rho[:, None, :]
        J10 = torch.stack([
            torch.stack([2 * b1, z, z, z], -1), torch.stack([b2, b1, z, z], -1),
            torch.stack([z, 2 * b2, z, z], -1), torch.stack([b3, z, b1, z], -1),
            torch.stack([z, b3, b2, z], -1), torch.stack([z, z, 2 * b3, z], -1),
            torch.stack([b4, z, z, b1], -1), torch.stack([z, b4, z, b2], -1),
            torch.stack([z, z, b4, b3], -1), torch.stack([z, z, z, 2 * b4], -1),
        ], -2)                                             # [H, S, 10, 4]
        J = torch.einsum("hpq,hsqk->hspk", L, J10)         # [H, S, 6, 4]
        JtJ = J.transpose(-1, -2) @ J + eye
        g = -torch.einsum("hspk,hsp->hsk", J, r)
        db = torch.linalg.solve_ex(_finite(JtJ), _finite(g)[..., None])[0][..., 0]
        b = b + db
    return b


def _epnp_pose(X, uv, fx, fy, cx, cy):
    """EPnP (Lepetit et al., IJCV'09) pose from n >= 4 world points
    [..., M, 3] and pixels [..., M, 2] (the reference's minimal solver,
    PnPsolver::compute_pose, src/PnPsolver.cpp:472-560 and helpers), one
    pose [..., 3, 4] per leading index.

    Control points by PCA, barycentric coordinates, the 2Mx12 system's
    12x12 kernel, five beta seeds (the reference's three approximation
    cases and two from the full relinearization) with an 8-step Gauss-Newton
    each, and Horn absolute orientation; the best of the five by
    reprojection error wins."""
    lead = X.shape[:-2]
    M = X.shape[-2]
    X = X.reshape(-1, M, 3)
    uv = uv.reshape(-1, M, 2)
    dt, dev = X.dtype, X.device
    # normalized camera coordinates: with unit focal the 2Mx12 system is
    # balanced and f32 suffices
    un = (uv[..., 0] - cx) / fx
    vn = (uv[..., 1] - cy) / fy
    # ---- control points: centroid + principal directions ----
    cw0 = X.mean(1)                                         # [H, 3]
    A = X - cw0[:, None]
    lam, V = torch.linalg.eigh(A.transpose(-1, -2) @ A / M)  # ascending
    lam = lam.flip(-1).clamp(min=_EPS)                      # descending
    Vd = V.flip(-1)
    Cs = torch.cat([cw0[:, None], cw0[:, None]
                    + lam.sqrt()[:, :, None] * Vd.transpose(-1, -2)], 1)  # [H,4,3]
    # ---- barycentric coordinates ----
    CC = (Cs[:, 1:] - cw0[:, None]).transpose(-1, -2)       # columns cw_j - cw0
    CCinv = torch.linalg.inv_ex(CC + _EPS * torch.eye(3, dtype=dt, device=dev))[0]
    a123 = A @ CCinv.transpose(-1, -2)                      # [H, M, 3]
    alphas = torch.cat([1.0 - a123.sum(-1, keepdim=True), a123], -1)  # [H, M, 4]
    # ---- the 2Mx12 system (unit focal, principal point at origin) ----
    zero = torch.zeros_like(alphas)
    ru = torch.stack([alphas, zero, alphas * (-un)[..., None]], -1)   # [H,M,4,3]
    rv = torch.stack([zero, alphas, alphas * (-vn)[..., None]], -1)
    Mm = torch.cat([ru.reshape(-1, M, 12), rv.reshape(-1, M, 12)], 1)
    _, Ve = torch.linalg.eigh(_finite(Mm.transpose(-1, -2) @ Mm))
    vk = Ve[:, :, :4].transpose(-1, -2).reshape(-1, 4, 4, 3)  # kernel x ctrl x 3
    # ---- L_6x10 / rho over the 6 control-point pairs ----
    pi = torch.tensor(_PAIR_I, device=dev)
    pj = torch.tensor(_PAIR_J, device=dev)
    dv = vk[:, :, pi] - vk[:, :, pj]                        # [H, 4, 6, 3]

    def dot(a, b):
        return torch.sum(dv[:, a] * dv[:, b], -1)           # [H, 6]

    L = torch.stack([dot(0, 0), 2 * dot(0, 1), dot(1, 1), 2 * dot(0, 2),
                     2 * dot(1, 2), dot(2, 2), 2 * dot(0, 3), 2 * dot(1, 3),
                     2 * dot(2, 3), dot(3, 3)], -1)         # [H, 6, 10]
    rho = torch.sum((Cs[:, pi] - Cs[:, pj]) ** 2, -1)       # [H, 6]
    L = _finite(L)

    def lstsq(cols):
        return (_pinv(L[:, :, list(cols)]) @ rho[..., None])[..., 0]

    # ---- beta seeds: the reference's three approximation cases ----
    x = lstsq((0, 1, 3, 6))
    x = x * torch.where(x[:, 0:1] < 0, -1.0, 1.0)
    b0 = x[:, 0].clamp(min=_EPS).sqrt()
    case1 = torch.stack([b0, x[:, 1] / b0, x[:, 2] / b0, x[:, 3] / b0], -1)

    def b01(x):
        b0 = x[:, 0].abs().sqrt()
        b1 = torch.where(x[:, 0] < 0, -x[:, 2], x[:, 2]).clamp(min=0.0).sqrt()
        return torch.where(x[:, 1] < 0, -b0, b0), b1

    b0, b1 = b01(lstsq((0, 1, 2)))
    case2 = torch.stack([b0, b1, 0.0 * b0, 0.0 * b0], -1)
    x = lstsq((0, 1, 2, 3, 4))
    b0, b1 = b01(x)
    b2 = x[:, 3] / torch.where(b0.abs() < _EPS, _EPS, b0)
    case3 = torch.stack([b0, b1, b2, 0.0 * b0], -1)
    # ---- two seeds beyond the reference's: minimum-norm least squares over
    # the FULL L (all 10 beta products), reassembled into the symmetric 4x4
    # B ~ beta beta^T and factored by its dominant rank-1 component, both
    # signs. For a 4-point sample the true beta is not concentrated on the
    # leading kernel vectors, which the three cases above assume. ----
    b10 = (_pinv(L) @ rho[..., None])[..., 0]
    sym = torch.tensor([[0, 1, 3, 6], [1, 2, 4, 7], [3, 4, 5, 8], [6, 7, 8, 9]],
                       device=dev)
    wB, VB = torch.linalg.eigh(_finite(b10[:, sym]))
    s_pos = VB[:, :, -1] * wB[:, -1:].clamp(min=_EPS).sqrt()
    s_neg = VB[:, :, 0] * (-wB[:, 0:1]).clamp(min=_EPS).sqrt()

    seeds = torch.stack([case1, case2, case3, s_pos, s_neg], 1)  # [H, 5, 4]
    betas = _gauss_newton(L, rho, seeds)

    # ---- pose from betas: camera-frame control points, Horn ----
    ccs = torch.einsum("hsk,hkjc->hsjc", betas, vk)         # [H, 5, 4, 3]
    pcs = alphas[:, None] @ ccs                             # [H, 5, M, 3]
    # solve_for_sign: the points must sit in front of the camera
    pcs = pcs * torch.where(pcs[:, :, 0:1, 2:3] < 0, -1.0, 1.0)
    pc0 = pcs.mean(2)                                       # [H, 5, 3]
    pw0 = X.mean(1)                                         # [H, 3]
    ABt = (pcs - pc0[:, :, None]).transpose(-1, -2) @ (X - pw0[:, None])[:, None]
    good = torch.isfinite(ABt).all(-1).all(-1)              # [H, 5]
    Uh, _, Vt = torch.linalg.svd(_finite(ABt))
    d = torch.linalg.det(Uh @ Vt)
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = Uh @ D @ Vt                                         # [H, 5, 3, 3]
    t = pc0 - torch.einsum("hsij,hj->hsi", R, pw0)
    pc = torch.einsum("hmj,hsij->hsmi", X, R) + t[:, :, None]
    zc = pc[..., 2].clamp(min=1e-6)
    err = ((pc[..., 0] / zc - un[:, None]) ** 2
           + (pc[..., 1] / zc - vn[:, None]) ** 2).mean(-1)  # [H, 5]
    err = torch.where(good & torch.isfinite(err), err, torch.inf)
    best = err.argmin(dim=1)
    Ts = torch.cat([R, t[..., None]], -1)                   # [H, 5, 3, 4]
    T = Ts.gather(1, best[:, None, None, None].expand(-1, 1, 3, 4))[:, 0]
    return T.reshape(*lead, 3, 4)


def draw_minimal_sets(valid, generator=None):
    """[N_HYPOTHESES, MIN_SET] row indices, each set drawn without
    replacement among the valid rows. At least MIN_SET rows must be valid
    (torch.multinomial refuses a row of weights with fewer non-zeros)."""
    probs = valid.to(torch.float32)
    return torch.multinomial(probs.expand(N_HYPOTHESES, -1), MIN_SET,
                             replacement=False, generator=generator)


def pnp_ransac(X, uv, sigma2, valid, fx: float, fy: float, cx: float, cy: float,
               *, idx=None, generator=None) -> PnPResult:
    """X: [N, 3] world points; uv: [N, 2] observed pixels; sigma2: [N]
    per-observation variance; valid: [N] bool. idx: the [N_HYPOTHESES,
    MIN_SET] minimal sets, drawn from `generator` when None. The hypothesis
    with the most inliers wins (the first among equals)."""
    if idx is None:
        idx = draw_minimal_sets(valid, generator)
    idx = idx.long()
    Ts = _epnp_pose(X[idx], uv[idx], fx, fy, cx, cy)        # [H, 3, 4]
    pc = torch.einsum("nj,hij->hni", X, Ts[:, :, :3]) + Ts[:, None, :, 3]
    z = pc[..., 2]
    zs = z.clamp(min=1e-6)
    u = fx * pc[..., 0] / zs + cx
    v = fy * pc[..., 1] / zs + cy
    chi2 = ((u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2) / sigma2[None]
    inls = valid[None] & (z > 0.05) & (chi2 < 5.991)        # [H, N]
    counts = inls.sum(1)
    best = counts.argmax()
    # index_select, not Ts[best]: indexing with a 0-d tensor waits for it
    sel = best[None]
    return PnPResult(T=Ts.index_select(0, sel)[0],
                     inliers=inls.index_select(0, sel)[0],
                     n_inliers=counts.index_select(0, sel)[0])
