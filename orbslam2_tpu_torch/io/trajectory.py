"""Trajectory writers in the reference's output formats.

- TUM:  `timestamp tx ty tz qx qy qz qw` per line, camera-to-world
  (System::SaveTrajectoryTUM / SaveKeyFrameTrajectoryTUM,
  src/System.cpp:307-408)
- KITTI: 12 numbers per line, row-major 3x4 camera-to-world matrix
  (System::SaveTrajectoryKITTI, src/System.cpp:409-462)

Pure numpy (host IO path — no device work).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def _R_to_quat_np(R: np.ndarray) -> np.ndarray:
    """3x3 -> (x, y, z, w), w >= 0."""
    m = R
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                      (m[1, 0] - m[0, 1]) / s, 0.25 * s])
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = np.array([0.25 * s, (m[0, 1] + m[1, 0]) / s,
                      (m[0, 2] + m[2, 0]) / s, (m[2, 1] - m[1, 2]) / s])
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = np.array([(m[0, 1] + m[1, 0]) / s, 0.25 * s,
                      (m[1, 2] + m[2, 1]) / s, (m[0, 2] - m[2, 0]) / s])
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = np.array([(m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s,
                      0.25 * s, (m[1, 0] - m[0, 1]) / s])
    q = q / np.linalg.norm(q)
    return q if q[3] >= 0 else -q


def invert_pose(Tcw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Tcw [3,4] -> (Rwc, twc = camera center)."""
    R, t = Tcw[:, :3], Tcw[:, 3]
    Rwc = R.T
    return Rwc, -Rwc @ t


def save_tum(path, timestamps, poses_cw):
    """poses_cw: [F, 3, 4] Tcw. Writes camera-to-world TUM lines."""
    lines = []
    for ts, T in zip(timestamps, poses_cw):
        Rwc, twc = invert_pose(np.asarray(T))
        q = _R_to_quat_np(Rwc)
        lines.append(
            f"{ts:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
            f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}"
        )
    Path(path).write_text("\n".join(lines) + "\n")



def save_kitti(path, poses_cw):
    """poses_cw: [F, 3, 4] Tcw. Writes camera-to-world KITTI lines."""
    lines = []
    for T in poses_cw:
        Rwc, twc = invert_pose(np.asarray(T))
        M = np.hstack([Rwc, twc[:, None]])
        lines.append(" ".join(f"{x:.9e}" for x in M.reshape(-1)))
    Path(path).write_text("\n".join(lines) + "\n")


def load_tum(path):
    """Returns (timestamps [F], centers [F, 3], quats [F, 4])."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    return data[:, 0], data[:, 1:4], data[:, 4:8]
