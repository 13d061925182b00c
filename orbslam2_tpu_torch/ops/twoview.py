"""Two-view geometry: batched H/F RANSAC with reconstruction (monocular
initialization), and the linear triangulation local mapping shares with it.

Counterpart of orbslam2_tpu/ops/twoview.py (src/Initializer.cpp). The
reference runs 200 sequential RANSAC iterations for H and for F; here each
model sweep is one batch of tensor ops over all hypotheses (a leading
dimension where the JAX package uses jax.vmap), and so are the 12 motion
hypotheses of the reconstruction:

- `Initialize` (:55)            -> `initialize_two_view`
- `ComputeH21/ComputeF21` (:319/:372) -> `_dlt_H`, `_dlt_F`: 8-point DLT,
  the null vector from the 9x9 Gram matrix's `eigh` (`_null9`)
- `CheckHomography/CheckFundamental` (:395/:503) -> `_score_H`, `_score_F`
- `ReconstructF` (:607) -> `_decompose_E` + `_check_rt` (4 motions)
- `ReconstructH` (:725, Faugeras) -> `_decompose_H` + `_check_rt` (8 motions)
- `Triangulate` (:951) -> `triangulate_dlt`
- `Normalize` (:981, Hartley conditioning) -> `_normalize`

Same gates and constants as the reference: sigma = 1, chi2 thresholds 5.991
(H) and 3.841 + 5.991 (F), RH = SH / (SH + SF) > 0.40 picks H, cheirality
with parallax and 4 sigma^2 reprojection bounds (CheckRT :1038).

The minimal sets are inputs: `initialize_two_view` takes the [200, 8] index
sets, or draws them from an explicit torch.Generator (the JAX package draws
them from threefry keys inside its program, which torch cannot replay).
`eigh` and `svd` may return another sign, or another order of equal values,
than another solver: H and F are homogeneous, and the motion hypotheses are
compared as a set.

The triangulation solves are closed-form 3x3 adjugates: no decomposition,
nothing read back from the device. The decompositions of the RANSAC
(`torch.linalg.eigh`, `svd`) may wait for the device; they run once per
initialization attempt, never inside the per-frame step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

N_HYPOTHESES = 200
SIGMA = 1.0
TH_H = 5.991
TH_F_LINE = 3.841
TH_F_SCORE = 5.991
MIN_PARALLAX_DEG = 1.0


def _adj3(G):
    """Batched adjugate of [..., 3, 3] (transpose of the cofactor matrix)."""
    a, b, c = G[..., 0, 0], G[..., 0, 1], G[..., 0, 2]
    d, e, f = G[..., 1, 0], G[..., 1, 1], G[..., 1, 2]
    g, h, i = G[..., 2, 0], G[..., 2, 1], G[..., 2, 2]
    return torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], dim=-2)


def _solve3(G, rhs):
    """G^-1 rhs for [..., 3, 3] G by the adjugate, with the determinant
    floored at 1e-20 in magnitude (as the JAX package's solves)."""
    adj = _adj3(G)
    det = torch.sum(G[..., 0, :] * adj[..., :, 0], dim=-1)
    det = torch.where(det.abs() > 1e-20, det, 1e-20)
    return torch.einsum("...ij,...j->...i", adj, rhs) / det[..., None]


def triangulate_dlt(P1, P2, xy1, xy2):
    """Linear triangulation. P1, P2: [..., 3, 4] projections (pixel or
    normalized; leading dimensions broadcast, one triangulation per motion
    hypothesis), xy: [N, 2] -> [..., N, 3].

    The closed-form inhomogeneous DLT seed (normal equations of the [N, 4, 4]
    system) plus 2 Gauss-Newton steps on the reprojection residuals: the
    normal equations square the conditioning, and the GN steps, which work
    on pixel-scale residuals, restore the accuracy at large depth/baseline
    ratios. Points at infinity come out huge and are culled by the callers'
    parallax and cheirality gates."""
    rows = []
    for P, xy in ((P1, xy1), (P2, xy2)):
        rows.append(xy[:, 0:1] * P[..., None, 2, :] - P[..., None, 0, :])
        rows.append(xy[:, 1:2] * P[..., None, 2, :] - P[..., None, 1, :])
    rows = torch.broadcast_tensors(*rows)
    A = torch.stack(rows, dim=-2)  # [..., N, 4, 4]
    B, c = A[..., :3], A[..., 3]
    G = torch.einsum("...ri,...rj->...ij", B, B)
    rhs = -torch.einsum("...ri,...r->...i", B, c)
    return _triangulate_gn(_solve3(G, rhs), (P1, P2), (xy1, xy2))


def _triangulate_gn(X, Ps, xys, iters: int = 2, damp: float = 1e-6):
    """Batched Gauss-Newton refinement of [..., N, 3] points against their
    reprojections in each [..., 3, 4] view of Ps."""
    eye = torch.eye(3, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        H = torch.zeros(X.shape + (3,), dtype=X.dtype, device=X.device)
        g = torch.zeros_like(X)
        for P, xy in zip(Ps, xys):
            h = X @ P[..., :3].mT + P[..., None, :, 3]   # [..., N, 3]
            z = torch.where(h[..., 2:].abs() > 1e-9, h[..., 2:], 1e-9)
            r = h[..., :2] / z - xy                        # [..., N, 2]
            # J = d(h01/h2)/dX = (P01*h2 - h01*P2) / h2^2   [..., N, 2, 3]
            J = (P[..., None, :2, :3] * z[..., None]
                 - h[..., :2, None] * P[..., None, 2:3, :3]) / (z ** 2)[..., None]
            H = H + torch.einsum("...ri,...rj->...ij", J, J)
            g = g + torch.einsum("...ri,...r->...i", J, r)
        step = _solve3(H + damp * eye, g)
        # keep the (huge, gate-culled) degenerate points finite
        X = X - torch.where(torch.isfinite(step), step, 0.0)
    return X


# ------------------------------------------------------------ H / F models
def _normalize(xy, w):
    """Hartley conditioning (Initializer::Normalize, src/Initializer.cpp:981)
    over the rows where w. Returns the normalized coordinates and the 3x3
    similarity T with xn = T x."""
    wf = w.to(xy.dtype)
    wsum = wf.sum().clamp(min=1.0)
    mean = (xy * wf[:, None]).sum(0) / wsum
    mean_dev = ((xy - mean).abs() * wf[:, None]).sum(0) / wsum
    s = 1.0 / mean_dev.clamp(min=1e-8)
    xn = (xy - mean) * s
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([
        torch.stack([s[0], zero, -mean[0] * s[0]]),
        torch.stack([zero, s[1], -mean[1] * s[1]]),
        torch.stack([zero, zero, one])])
    return xn, T


def _homog(xy):
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


def _null9(A):
    """Null vector of thin [..., r, 9] DLT systems as the eigenvector of the
    smallest eigenvalue of AᵀA (a batched 9x9 `eigh` on the Gram matrix in
    place of a batched rectangular SVD). The squared conditioning is
    harmless for the hypothesis sweep, which only selects; the refits
    inherit it, as in the JAX package."""
    _, V = torch.linalg.eigh(A.mT @ A)
    return V[..., :, 0]


def _rows_F(x1, x2):
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                        torch.ones_like(u1)], dim=-1)


def _rows_H(x1, x2):
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z, o = torch.zeros_like(u1), torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    return r1, r2


def _dlt_F(x1, x2):
    """8-point fundamental matrices from [..., 8, 2] normalized
    correspondences -> [..., 3, 3]. No rank-2 projection: epipolar-distance
    scoring is defined for the unconstrained solution, and the winning model
    is refit, with rank 2 enforced, by _dlt_F_masked."""
    A = _rows_F(x1, x2)
    return _null9(A).reshape(A.shape[:-2] + (3, 3))


def _dlt_H(x1, x2):
    """Homographies from [..., 8, 2] normalized correspondences,
    x2 ~ H x1 -> [..., 3, 3]."""
    A = torch.cat(_rows_H(x1, x2), dim=-2)  # [..., 16, 9]
    return _null9(A).reshape(A.shape[:-2] + (3, 3))


def _inv3(M):
    """Batched 3x3 inverse without the error check (a singular hypothesis
    gives non-finite entries, which score nothing)."""
    return torch.linalg.inv_ex(M, check_errors=False).inverse


def _score_H(H, xy1, xy2, w):
    """Symmetric transfer score (CheckHomography, src/Initializer.cpp:395).
    H: [..., 3, 3]; xy: [N, 2]; w: [N] -> (score [...], inliers [..., N])."""
    p1, p2 = _homog(xy1), _homog(xy2)

    def transfer(M, src, dst):
        proj = src @ M.mT
        den = torch.where(proj[..., 2:].abs() > 1e-12, proj[..., 2:], 1e-12)
        return ((proj[..., :2] / den - dst[:, :2]) ** 2).sum(-1) / (SIGMA * SIGMA)

    chi12 = transfer(H, p1, p2)
    chi21 = transfer(_inv3(H), p2, p1)
    ok = (chi12 < TH_H) & (chi21 < TH_H) & w
    score = torch.where(ok, (TH_H - chi12) + (TH_H - chi21), 0.0).sum(-1)
    return score, ok


def _score_F(F, xy1, xy2, w):
    """Epipolar line distance score (CheckFundamental,
    src/Initializer.cpp:503). F: [..., 3, 3] -> (score [...], inliers
    [..., N])."""
    p1, p2 = _homog(xy1), _homog(xy2)
    l2 = p1 @ F.mT  # lines in image 2
    l1 = p2 @ F     # lines in image 1

    def line_chi2(line, p):
        num = (line * p).sum(-1) ** 2
        den = line[..., 0] ** 2 + line[..., 1] ** 2
        return num / den.clamp(min=1e-12) / (SIGMA * SIGMA)

    chi2_2 = line_chi2(l2, p2)
    chi2_1 = line_chi2(l1, p1)
    ok = (chi2_2 < TH_F_LINE) & (chi2_1 < TH_F_LINE) & w
    score = torch.where(ok, (TH_F_SCORE - chi2_2) + (TH_F_SCORE - chi2_1), 0.0).sum(-1)
    return score, ok


def _dlt_F_masked(xy1, xy2, w):
    """Fundamental DLT over all masked correspondences (the inlier refit).
    Rows of invalid matches are zeroed: they add no constraint. Rank 2 is
    enforced on the exact 3x3 SVD."""
    xn1, T1 = _normalize(xy1, w)
    xn2, T2 = _normalize(xy2, w)
    A = _rows_F(xn1, xn2) * w.to(xy1.dtype)[:, None]
    uf, sf, vtf = torch.linalg.svd(_null9(A).reshape(3, 3))
    sf = torch.cat([sf[:2], torch.zeros_like(sf[2:])])
    return T2.T @ (uf @ torch.diag(sf) @ vtf) @ T1


def _dlt_H_masked(xy1, xy2, w):
    """Homography DLT over all masked correspondences (the inlier refit)."""
    xn1, T1 = _normalize(xy1, w)
    xn2, T2 = _normalize(xy2, w)
    wf = w.to(xy1.dtype)[:, None]
    r1, r2 = _rows_H(xn1, xn2)
    Hn = _null9(torch.cat([r1 * wf, r2 * wf], dim=0)).reshape(3, 3)
    return _inv3(T2) @ Hn @ T1


# ---------------------------------------------------------- reconstruction
def _check_rt(R, t, xy1, xy2, w, K, th2: float = 4.0 * SIGMA * SIGMA):
    """Cheirality, parallax and reprojection gating of motion hypotheses
    (Initializer::CheckRT, src/Initializer.cpp:1038). R: [..., 3, 3];
    t: [..., 3]; xy: [N, 2]; w: [N].

    Returns (n_good [...], parallax_deg [...], pts3d [..., N, 3], good
    [..., N])."""
    P1 = K @ torch.eye(3, 4, dtype=K.dtype, device=K.device)
    P2 = K @ torch.cat([R, t[..., None]], dim=-1)
    X = triangulate_dlt(P1, P2, xy1, xy2)

    finite = torch.isfinite(X).all(-1)
    O2 = -(R.mT @ t[..., None])[..., 0]
    n1 = X
    n2 = X - O2[..., None, :]
    cos_par = (n1 * n2).sum(-1) / (
        torch.linalg.vector_norm(n1, dim=-1)
        * torch.linalg.vector_norm(n2, dim=-1)).clamp(min=1e-12)
    Xc2 = X @ R.mT + t[..., None, :]
    depth_ok = (X[..., 2] > 0) & (Xc2[..., 2] > 0)

    f = torch.stack([K[0, 0], K[1, 1]])
    c = torch.stack([K[0, 2], K[1, 2]])

    def reproj_err(Xc, xy):
        den = torch.where(Xc[..., 2:].abs() > 1e-12, Xc[..., 2:], 1e-12)
        return ((Xc[..., :2] / den * f + c - xy) ** 2).sum(-1)

    e1 = reproj_err(X, xy1)
    e2 = reproj_err(Xc2, xy2)
    good = w & finite & depth_ok & (e1 < th2) & (e2 < th2) & (cos_par < 0.99998)
    n_good = good.sum(-1)
    # parallax at the 50th-best point (the reference takes the
    # min(50, n)-th)
    cos_sorted = torch.sort(torch.where(good, cos_par, 1.0), dim=-1).values
    take = (n_good - 1).clamp(0, 49)
    cos_take = cos_sorted.gather(-1, take[..., None])[..., 0]
    parallax = torch.rad2deg(torch.acos(cos_take.clamp(-1.0, 1.0)))
    return n_good, parallax, X, good


def _unit(t):
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp(min=1e-12)


def _decompose_E(E):
    """4 motion hypotheses from an essential matrix
    (Initializer::DecomposeE, src/Initializer.cpp:1185) -> (Rs [4, 3, 3],
    ts [4, 3])."""
    u, _, vt = torch.linalg.svd(E)
    t = _unit(u[:, 2])
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_H(H, K):
    """Faugeras' SVD-based homography decomposition, 8 motions
    (Initializer::ReconstructH, src/Initializer.cpp:725-950) -> (Rs
    [8, 3, 3], ts [8, 3])."""
    A = _inv3(K) @ H @ K
    U, d, Vt = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    den13 = (d1 * d1 - d3 * d3).clamp(min=1e-12)
    aux1 = torch.sqrt(((d1 * d1 - d2 * d2) / den13).clamp(min=0.0))
    aux3 = torch.sqrt(((d2 * d2 - d3 * d3) / den13).clamp(min=0.0))
    signs = torch.tensor([[1.0, 1.0], [1.0, -1.0], [-1.0, 1.0], [-1.0, -1.0]],
                         dtype=H.dtype, device=H.device)
    x1s, x3s = aux1 * signs[:, 0], aux3 * signs[:, 1]
    alt = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=H.dtype, device=H.device)
    root = torch.sqrt(((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)).clamp(min=0.0))
    zero, one = torch.zeros_like(x1s), torch.ones_like(x1s)

    def motions(sin, cos, flip, tp):
        # R' rotates about y (flip = -1: with a reflection); [4, 3, 3]
        Rp = torch.stack([
            torch.stack([cos, zero, -flip * sin], -1),
            torch.stack([zero, flip * one, zero], -1),
            torch.stack([sin, zero, flip * cos], -1)], dim=-2)
        return s * U @ Rp @ Vt, _unit(tp @ U.T)

    # case d' > 0: rotation by theta
    den_p = ((d1 + d3) * d2).clamp(min=1e-12)
    R_pos, t_pos = motions(
        alt * (root / den_p), ((d2 * d2 + d1 * d3) / den_p) * one, 1.0,
        (d1 - d3) * torch.stack([x1s, zero, -x3s], -1))
    # case d' < 0: rotation by phi with a reflection
    den_n = ((d1 - d3) * d2).clamp(min=1e-12)
    R_neg, t_neg = motions(
        alt * (root / den_n), ((d1 * d3 - d2 * d2) / den_n) * one, -1.0,
        (d1 + d3) * torch.stack([x1s, zero, x3s], -1))
    return torch.cat([R_pos, R_neg]), torch.cat([t_pos, t_neg])


class TwoViewResult(NamedTuple):
    success: torch.Tensor          # bool scalar
    used_homography: torch.Tensor  # bool scalar
    R: torch.Tensor                # [3, 3] camera2-from-camera1
    t: torch.Tensor                # [3] unit norm
    points3d: torch.Tensor         # [N, 3] in the frame of camera 1
    good: torch.Tensor             # [N] bool triangulated-point mask
    n_inliers: torch.Tensor


def draw_minimal_sets(w, n_hyp: int = N_HYPOTHESES, generator=None):
    """[n_hyp, 8] row indices, each set drawn without replacement among the
    rows where w (uniformly among all rows when fewer than 8 are set: the
    attempt is then discarded by its match count, but the draw must stay
    valid)."""
    p = torch.where(w.sum() >= 8, w.to(torch.float32), 1.0)
    return torch.multinomial(p.expand(n_hyp, -1), 8, replacement=False,
                             generator=generator)


def initialize_two_view(xy1, xy2, w, K, *, idx_H=None, idx_F=None,
                        generator=None) -> TwoViewResult:
    """The two-view bootstrap (Initializer::Initialize,
    src/Initializer.cpp:55).

    xy1/xy2: [N, 2] undistorted pixel coordinates of matched features;
    w: [N] bool match validity; K: [3, 3] intrinsics. idx_H / idx_F:
    [200, 8] minimal sets of the homography and the fundamental sweep; a set
    left out is drawn with `generator` (a torch.Generator on the tensors'
    device; None takes the global one)."""
    if idx_H is None:
        idx_H = draw_minimal_sets(w, generator=generator)
    if idx_F is None:
        idx_F = draw_minimal_sets(w, generator=generator)
    xn1, T1 = _normalize(xy1, w)
    xn2, T2 = _normalize(xy2, w)

    # --- homography sweep: H = T2^-1 Hn T1 ---
    Hs = _inv3(T2) @ _dlt_H(xn1[idx_H], xn2[idx_H]) @ T1
    scores, masks = _score_H(Hs, xy1, xy2, w)
    inH = masks[torch.argmax(scores)]
    # two refits on the inliers recover the precision a single f32 8-point
    # fit lacks; re-scoring refreshes the inlier set
    for _ in range(2):
        H = _dlt_H_masked(xy1, xy2, w & inH)
        SH, inH = _score_H(H, xy1, xy2, w)

    # --- fundamental sweep: F = T2^T Fn T1 ---
    Fs = T2.T @ _dlt_F(xn1[idx_F], xn2[idx_F]) @ T1
    scores, masks = _score_F(Fs, xy1, xy2, w)
    inF = masks[torch.argmax(scores)]
    for _ in range(2):
        F = _dlt_F_masked(xy1, xy2, w & inF)
        SF, inF = _score_F(F, xy1, xy2, w)

    use_H = SH / (SH + SF).clamp(min=1e-12) > 0.40  # src/Initializer.cpp:150-153

    # --- reconstruct from both models, select at the end ---
    Rs_f, ts_f = _decompose_E(K.T @ F @ K)
    Rs_h, ts_h = _decompose_H(H, K)
    Rs = torch.cat([Rs_f, Rs_h])  # [12, 3, 3]
    ts = torch.cat([ts_f, ts_h])
    from_H = torch.arange(12, device=xy1.device) >= 4
    w_model = torch.where(use_H, w & inH, w & inF)

    n_goods, parallaxes, Xs, goods = _check_rt(Rs, ts, xy1, xy2, w_model, K)
    # hypotheses of the model not selected are out
    n_goods = torch.where(torch.where(use_H, from_H, ~from_H), n_goods, -1)
    best = torch.argmax(n_goods)
    n_best = n_goods[best]

    min_good = (0.9 * w_model.sum()).to(torch.int32).clamp(min=50)
    # a clear winner: no other hypothesis within 0.75 of it (ReconstructF
    # :648-707)
    second = torch.sort(n_goods).values[-2]
    clear = second.to(torch.float32) < 0.75 * n_best.to(torch.float32)
    ok = (n_best >= min_good) & clear & (parallaxes[best] > MIN_PARALLAX_DEG)

    return TwoViewResult(success=ok, used_homography=use_H, R=Rs[best],
                         t=ts[best], points3d=Xs[best], good=goods[best],
                         n_inliers=n_best)
