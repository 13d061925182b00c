"""Stereo rectification from the reference's EuRoC-style YAML, without OpenCV.

The reference's EuRoC stereo driver builds rectification maps from the
LEFT.*/RIGHT.* opencv-matrix blocks of the settings YAML with
cv::initUndistortRectifyMap and remaps every image with cv::remap
(Examples/Stereo/stereo_EuRoC.cpp:35-90); the JAX package does the same
through cv2. Here the maps come from the same camera model in float64
numpy, and the remap reproduces OpenCV 5's cv2.remap with INTER_LINEAR on
float maps and a zero border (float32 interpolation; OpenCV 4's fixed-point
remap on 1/32-px coordinates rounds otherwise). Host IO path, numpy only.
"""
from __future__ import annotations

import numpy as np

from ..config import _parse_opencv_yaml


def undistort_rectify_map(K, D, R, P, size) -> tuple[np.ndarray, np.ndarray]:
    """cv2.initUndistortRectifyMap(K, D, R, P, size, CV_32F): for every
    pixel of the rectified image [rows, cols] = size[::-1], where to sample
    the raw image. D holds k1, k2, p1, p2 and optionally k3 (the
    radial-tangential model)."""
    cols, rows = size
    K, R, P = (np.asarray(m, np.float64) for m in (K, R, P))
    d = np.zeros(5)
    flat = np.asarray(D, np.float64).ravel()
    if len(flat) not in (4, 5):
        raise ValueError(f"distortion coefficients: {len(flat)}, expected 4 or 5")
    d[:len(flat)] = flat
    k1, k2, p1, p2, k3 = d
    iR = np.linalg.inv(P[:3, :3] @ R)
    j, i = np.meshgrid(np.arange(cols, dtype=np.float64), np.arange(rows, dtype=np.float64))
    ray = np.stack([j, i, np.ones_like(j)], -1) @ iR.T
    x, y = ray[..., 0] / ray[..., 2], ray[..., 1] / ray[..., 2]
    x2, y2, xy2 = x * x, y * y, 2 * x * y
    r2 = x2 + y2
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    u = K[0, 0] * (x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)) + K[0, 2]
    v = K[1, 1] * (y * kr + p1 * (r2 + 2 * y2) + p2 * xy2) + K[1, 2]
    return u.astype(np.float32), v.astype(np.float32)


def remap_linear(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """cv2.remap(img, map_x, map_y, INTER_LINEAR) of a 2-D u8 image with a
    zero border, as OpenCV 5 computes it: the fractions of the float32
    coordinates, one fused multiply-add in float32 along x on each of the
    two rows and one along y, rounded to nearest (ties to even); a
    neighbour outside the image reads 0. Each fused step is exact in
    float64 before its one rounding to float32."""
    h, w = img.shape
    # a NaN coordinate samples the border
    x = np.nan_to_num(np.asarray(map_x, np.float32), nan=-3.0)
    y = np.nan_to_num(np.asarray(map_y, np.float32), nan=-3.0)
    ix, iy = np.floor(x), np.floor(y)
    ax, ay = (x - ix).astype(np.float64), (y - iy).astype(np.float64)
    # a neighbour left of -1 or right of w reads the zero border all the same
    ix = np.clip(ix, -2, w).astype(np.int64) + 2
    iy = np.clip(iy, -2, h).astype(np.int64) + 2
    padded = np.zeros((h + 4, w + 4), np.float64)
    padded[2:-2, 2:-2] = img
    p00, p01 = padded[iy, ix], padded[iy, ix + 1]
    p10, p11 = padded[iy + 1, ix], padded[iy + 1, ix + 1]
    top = (p00 + ax * (p01 - p00)).astype(np.float32)
    bottom = (p10 + ax * (p11 - p10)).astype(np.float32)
    step = (bottom - top).astype(np.float64)
    v = (top.astype(np.float64) + ay * step).astype(np.float32)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def load_rectification(settings_yaml):
    """Returns (rectify_left, rectify_right, fx, fy, cx, cy, bf), or None if
    the YAML carries no LEFT./RIGHT. blocks (or no LEFT.height). The
    rectified intrinsics come from LEFT.P, the baseline term bf from
    -RIGHT.P[0, 3]."""
    y = _parse_opencv_yaml(settings_yaml)
    names = [f"{side}.{m}" for side in ("LEFT", "RIGHT") for m in "KDRP"]
    if any(not isinstance(y.get(n), np.ndarray) for n in names):
        return None
    rows, cols = int(y.get("LEFT.height", 0)), int(y.get("LEFT.width", 0))
    if rows == 0:
        return None
    maps = {side: undistort_rectify_map(y[f"{side}.K"], y[f"{side}.D"], y[f"{side}.R"],
                                        y[f"{side}.P"], (cols, rows))
            for side in ("LEFT", "RIGHT")}

    def rect_l(img):
        return remap_linear(img, *maps["LEFT"])

    def rect_r(img):
        return remap_linear(img, *maps["RIGHT"])

    P_l, P_r = y["LEFT.P"], y["RIGHT.P"]
    return (rect_l, rect_r, float(P_l[0, 0]), float(P_l[1, 1]), float(P_l[0, 2]),
            float(P_l[1, 2]), float(-P_r[0, 3]))
