"""Tiny numpy mirrors of the SE(3) helpers for host-side bookkeeping.

Tracking's per-frame host logic composes a handful of single poses; doing it
with device tensors would pay a kernel launch and a readback per op. Device
code uses geometry/se3.py. Copied from orbslam2_tpu/geometry/se3_np.py.
"""
from __future__ import annotations

import numpy as np


def compose(Ta: np.ndarray, Tb: np.ndarray) -> np.ndarray:
    R = Ta[:, :3] @ Tb[:, :3]
    t = Ta[:, :3] @ Tb[:, 3] + Ta[:, 3]
    return np.hstack([R, t[:, None]]).astype(np.float32)


def inverse(T: np.ndarray) -> np.ndarray:
    Rt = T[:, :3].T
    return np.hstack([Rt, (-Rt @ T[:, 3])[:, None]]).astype(np.float32)


def identity() -> np.ndarray:
    return np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32)


def orthonormalize(T: np.ndarray) -> np.ndarray:
    """Project the rotation block onto SO(3) (nearest rotation by SVD).

    Chained f32 pose compositions leak scale into R: the constant-velocity
    recurrence T_pred = (T_k T_{k-1}^-1) T_k amplifies any det(R) != 1 seed
    geometrically (measured x2.4/frame on the synthetic room), and the
    optimizers' left-multiplicative exp(xi) updates can never remove it --
    det(exp(xi) R) == det(R). A scaled R acts like a focal-length error, so
    pose optimization stalls centimeters off. Every host-side pose
    composition that feeds a prediction or a stored pose must pass through
    here.
    """
    R = T[:, :3].astype(np.float64)
    U, _, Vt = np.linalg.svd(R)
    R_o = U @ Vt
    if np.linalg.det(R_o) < 0:
        R_o = U @ np.diag([1.0, 1.0, -1.0]) @ Vt
    out = np.hstack([R_o, T[:, 3:4].astype(np.float64)]).astype(np.float32)
    return out
