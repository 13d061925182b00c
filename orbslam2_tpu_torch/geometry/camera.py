"""Pinhole camera model: projection, radial-tangential (un)distortion.

Counterpart of orbslam2_tpu/geometry/camera.py (the reference's
Frame::UndistortKeyPoints, src/Frame.cpp:470-504, and the projection of
Frame::isInFrustum, src/Frame.cpp:307-386). Functions take tensors on any
device and broadcast over leading dims.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

UNDISTORT_ITERS = 8  # fixed-point iterations, as the JAX package runs


@dataclass(frozen=True)
class Intrinsics:
    """Static camera parameters."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 0.0  # stereo baseline * fx (reference key Camera.bf)
    width: int = 640
    height: int = 480

    @property
    def baseline(self) -> float:
        return self.bf / self.fx if self.fx else 0.0

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


def project(cam: Intrinsics, pts_cam: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame points -> (..., 2) pixels (no distortion: the
    reference projects undistorted keypoints)."""
    z = pts_cam[..., 2]
    inv_z = 1.0 / torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    u = cam.fx * pts_cam[..., 0] * inv_z + cam.cx
    v = cam.fy * pts_cam[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1)


def backproject(cam: Intrinsics, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """(..., 2) pixels + (...,) depth -> (..., 3) camera-frame points
    (Frame::UnprojectStereo, src/Frame.cpp:802-822)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def distort_normalized(cam: Intrinsics, xy: torch.Tensor) -> torch.Tensor:
    """Apply radial-tangential distortion to normalized coords (..., 2)."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_pixels(cam: Intrinsics, uv: torch.Tensor) -> torch.Tensor:
    """Invert distortion for raw pixel coords (..., 2) by fixed-point
    iteration (the algorithm inside cv::undistortPoints, with a fixed
    count of UNDISTORT_ITERS). Returns undistorted pixel coords."""
    if not cam.has_distortion:
        return uv
    x0 = (uv[..., 0] - cam.cx) / cam.fx
    y0 = (uv[..., 1] - cam.cy) / cam.fy
    xy0 = torch.stack([x0, y0], dim=-1)
    xy = xy0
    for _ in range(UNDISTORT_ITERS):
        d = distort_normalized(cam, xy) - xy
        xy = xy0 - d
    u = cam.fx * xy[..., 0] + cam.cx
    v = cam.fy * xy[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)


def undistorted_bounds(cam: Intrinsics) -> tuple[float, float, float, float]:
    """Image bounds after undistortion (Frame::ComputeImageBounds,
    src/Frame.cpp:506-549). Returns (min_x, max_x, min_y, max_y)."""
    if not cam.has_distortion:
        return 0.0, float(cam.width), 0.0, float(cam.height)
    corners = torch.tensor(
        [[0.0, 0.0], [cam.width, 0.0], [0.0, cam.height], [cam.width, cam.height]],
        dtype=torch.float32,
    )
    und = undistort_pixels(cam, corners).numpy()
    return (
        float(min(und[0, 0], und[2, 0])),
        float(max(und[1, 0], und[3, 0])),
        float(min(und[0, 1], und[1, 1])),
        float(max(und[2, 1], und[3, 1])),
    )
