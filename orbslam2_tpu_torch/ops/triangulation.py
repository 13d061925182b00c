"""Batched triangulation with the reference's acceptance gates.

Counterpart of orbslam2_tpu/ops/triangulation.py: the numerical core of
LocalMapping::CreateNewMapPoints (src/LocalMapping.cpp:440-573), DLT
triangulation plus the parallax, cheirality, chi2-reprojection and
scale-consistency gates, over a batch of matched pairs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import constant
from . import twoview as TV


def intrinsic_matrix(fx: float, fy: float, cx: float, cy: float,
                     device: torch.device) -> torch.Tensor:
    """K [3,3] f32 on `device` (uploaded once per camera)."""
    return constant(("K", fx, fy, cx, cy), lambda: np.array(
        [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], np.float32), device)


def triangulate_gated(T1, T2, xy1, xy2, oct1, oct2, valid, sigma2_levels,
                      scale_factors, fx: float, fy: float, cx: float,
                      cy: float, scale_factor: float):
    """T1/T2: [3,4] Tcw. xy: [M,2] undistorted pixel pairs. Returns (X [M,3]
    world points, ok [M])."""
    K = intrinsic_matrix(fx, fy, cx, cy, T1.device)
    X = TV.triangulate_dlt(K @ T1, K @ T2, xy1, xy2)

    Ow1 = -T1[:, :3].T @ T1[:, 3]
    Ow2 = -T2[:, :3].T @ T2[:, 3]
    r1 = X - Ow1[None]
    r2 = X - Ow2[None]
    d1 = torch.linalg.vector_norm(r1, dim=-1)
    d2 = torch.linalg.vector_norm(r2, dim=-1)
    cos_par = torch.sum(r1 * r2, dim=-1) / torch.clamp(d1 * d2, min=1e-12)
    pc1 = X @ T1[:, :3].T + T1[:, 3]
    pc2 = X @ T2[:, :3].T + T2[:, 3]
    ok = (valid & torch.isfinite(X).all(-1) & (pc1[:, 2] > 0.05)
          & (pc2[:, 2] > 0.05) & (cos_par < 0.9998))

    sig = sigma2_levels

    def chi2(pc, xy, octv):
        z = torch.clamp(pc[:, 2], min=1e-9)
        u = fx * pc[:, 0] / z + cx
        v = fy * pc[:, 1] / z + cy
        e2 = (u - xy[:, 0]) ** 2 + (v - xy[:, 1]) ** 2
        return e2 / sig[octv.clamp(0, sig.shape[0] - 1).long()]

    ok = ok & (chi2(pc1, xy1, oct1) < 5.991) & (chi2(pc2, xy2, oct2) < 5.991)

    sf = scale_factors
    ratio_dist = d2 / torch.clamp(d1, min=1e-12)
    ratio_oct = (sf[oct1.clamp(0, sf.shape[0] - 1).long()]
                 / sf[oct2.clamp(0, sf.shape[0] - 1).long()])
    factor = 1.5 * scale_factor
    ok = ok & (ratio_dist < ratio_oct * factor) & (ratio_dist * factor > ratio_oct)
    return X, ok
