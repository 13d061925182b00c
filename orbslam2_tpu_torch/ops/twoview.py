"""Two-view geometry, in part: the linear triangulation that local mapping
uses.

Counterpart of orbslam2_tpu/ops/twoview.py `triangulate_dlt`,
`_triangulate_gn` and `_adj3` (Initializer::Triangulate,
src/Initializer.cpp:951). The rest of that module, the H/F RANSAC of
monocular initialization, comes with mono init (ROADMAP.md queue 1,
item 11).

Every solve is a closed-form 3x3 adjugate: no decomposition, nothing read
back from the device.
"""
from __future__ import annotations

import torch


def _adj3(G):
    """Batched adjugate of [N, 3, 3] (transpose of the cofactor matrix)."""
    a, b, c = G[:, 0, 0], G[:, 0, 1], G[:, 0, 2]
    d, e, f = G[:, 1, 0], G[:, 1, 1], G[:, 1, 2]
    g, h, i = G[:, 2, 0], G[:, 2, 1], G[:, 2, 2]
    return torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], dim=1)


def _solve3(G, rhs):
    """G^-1 rhs for [N, 3, 3] G by the adjugate, with the determinant
    floored at 1e-20 in magnitude (as the JAX package's solves)."""
    adj = _adj3(G)
    det = torch.sum(G[:, 0, :] * adj[:, :, 0], dim=-1)
    det = torch.where(det.abs() > 1e-20, det, 1e-20)
    return torch.einsum("nij,nj->ni", adj, rhs) / det[:, None]


def triangulate_dlt(P1, P2, xy1, xy2):
    """Linear triangulation. P1, P2: [3, 4] projections (pixel or
    normalized), xy: [N, 2] -> [N, 3].

    The closed-form inhomogeneous DLT seed (normal equations of the [N, 4, 4]
    system) plus 2 Gauss-Newton steps on the reprojection residuals: the
    normal equations square the conditioning, and the GN steps, which work
    on pixel-scale residuals, restore the accuracy at large depth/baseline
    ratios. Points at infinity come out huge and are culled by the callers'
    parallax and cheirality gates."""
    rows = []
    for P, xy in ((P1, xy1), (P2, xy2)):
        rows.append(xy[:, 0:1] * P[2][None] - P[0][None])
        rows.append(xy[:, 1:2] * P[2][None] - P[1][None])
    A = torch.stack(rows, dim=1)  # [N, 4, 4]
    B, c = A[:, :, :3], A[:, :, 3]
    G = torch.einsum("nri,nrj->nij", B, B)
    rhs = -torch.einsum("nri,nr->ni", B, c)
    return _triangulate_gn(_solve3(G, rhs), (P1, P2), (xy1, xy2))


def _triangulate_gn(X, Ps, xys, iters: int = 2, damp: float = 1e-6):
    """Batched Gauss-Newton refinement of [N, 3] points against their
    reprojections in each [3, 4] view of Ps."""
    eye = torch.eye(3, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        H = torch.zeros(X.shape[:1] + (3, 3), dtype=X.dtype, device=X.device)
        g = torch.zeros_like(X)
        for P, xy in zip(Ps, xys):
            h = X @ P[:, :3].T + P[:, 3]            # [N, 3]
            z = torch.where(h[:, 2:].abs() > 1e-9, h[:, 2:], 1e-9)
            r = h[:, :2] / z - xy                    # [N, 2]
            # J = d(h01/h2)/dX = (P01*h2 - h01*P2) / h2^2   [N, 2, 3]
            J = (P[None, :2, :3] * z[..., None]
                 - h[:, :2, None] * P[None, 2, :3]) / (z ** 2)[..., None]
            H = H + torch.einsum("nri,nrj->nij", J, J)
            g = g + torch.einsum("nri,nr->ni", J, r)
        step = _solve3(H + damp * eye, g)
        # keep the (huge, gate-culled) degenerate points finite
        X = X - torch.where(torch.isfinite(step), step, 0.0)
    return X
