"""SO(3)/SE(3) Lie-group utilities on tensors (batch-friendly).

Counterpart of orbslam2_tpu/geometry/se3.py (the reference's g2o SE3Quat,
Thirdparty/g2o/g2o/types/se3quat.h): the functions pose optimization uses,
broadcast over leading batch dimensions, with Taylor fallbacks near theta=0.

Convention: poses are world->camera transforms Tcw = (R, t) with
x_cam = R @ x_world + t (src/Frame.cpp:276-305), stored as (..., 3, 4).
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation matrix."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(w)
    W2 = W @ W
    a = torch.where(theta2 > _EPS, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(theta2 > _EPS, (1.0 - torch.cos(theta)) / theta2,
                    0.5 - theta2 / 24.0)
    return _eye_like(W) + a * W + b * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_t = torch.sin(theta)
    big = sin_t.abs() > 1e-5
    scale = torch.where(
        big,
        theta / (2.0 * torch.where(big, sin_t, torch.ones_like(sin_t))),
        0.5 + theta * theta / 12.0,
    )
    return v * scale[..., None]


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3): exp((Jl v)^) translation coupling."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(w)
    W2 = W @ W
    b = torch.where(theta2 > _EPS, (1.0 - torch.cos(theta)) / theta2,
                    0.5 - theta2 / 24.0)
    c = torch.where(theta2 > _EPS, (theta - torch.sin(theta)) / (theta2 * theta),
                    1.0 / 6.0 - theta2 / 120.0)
    return _eye_like(W) + b * W + c * W2


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) twist [v, w] -> (..., 3, 4) transform [R | t], t = J_l(w) v."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (_so3_left_jacobian(w) @ v[..., None])[..., 0]
    return torch.cat([R, t[..., None]], dim=-1)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> (..., 6) twist [v, w]."""
    R, t = T[..., :3], T[..., 3]
    w = so3_log(R)
    Jl = _so3_left_jacobian(w)
    v = torch.linalg.solve(Jl, t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([R, t[..., None]], dim=-1)


def rot(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3]


def trans(T: torch.Tensor) -> torch.Tensor:
    return T[..., 3]


def compose(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """Ta @ Tb for (..., 3, 4) transforms."""
    Ra, ta = rot(Ta), trans(Ta)
    Rb, tb = rot(Tb), trans(Tb)
    return make_T(Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta)


def inverse(T: torch.Tensor) -> torch.Tensor:
    R, t = rot(T), trans(T)
    Rt = R.transpose(-1, -2)
    return make_T(Rt, -(Rt @ t[..., None])[..., 0])


def retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative update exp(xi) @ T (g2o
    VertexSE3Expmap::oplusImpl semantics)."""
    return compose(se3_exp(xi), T)


def camera_center(Tcw: torch.Tensor) -> torch.Tensor:
    """Ow = -R^T t, the camera center in world coords (src/Frame.cpp:287-305)."""
    R, t = rot(Tcw), trans(Tcw)
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]
