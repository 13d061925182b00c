"""Synthetic textured-room sequences with exact ground truth.

The room and corridor scenes of orbslam2_tpu/io/synth.py, copied (numpy
only) so that the port and chip_smoke.py can render the benchmark and loop
sequences on a machine without JAX: a textured room and a square corridor
circuit rendered by exact ray-plane intersection, their depth maps, and the
orbit, sweep, corridor-lap and in-room loop camera trajectories.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class RoomScene:
    """Textured 3-plane room rendered by exact ray-plane intersection with
    bilinear texture sampling — realistic subpixel imaging for e2e/ATE tests."""

    planes: list  # (origin, normal, bu, bv, texture, tex_scale[, extent])
    # extent (optional 7th element) = (umin, umax, vmin, vmax) bounds in
    # plane-local meters along (bu, bv): finite wall panels, which make
    # non-convex environments (corridor circuits) renderable
    K: np.ndarray
    width: int
    height: int

    def ray_depths(self, Tcw: np.ndarray):
        """Per-pixel hit (plane index, depth) for a camera pose."""
        R, t = Tcw[:3, :3], Tcw[:3, 3]
        Rwc = R.T
        C = -Rwc @ t
        H, W = self.height, self.width
        xs = (np.arange(W) - self.K[0, 2]) / self.K[0, 0]
        ys = (np.arange(H) - self.K[1, 2]) / self.K[1, 1]
        dirs_cam = np.stack(np.broadcast_arrays(
            xs[None, :, None] * np.ones((H, 1, 1)),
            ys[:, None, None] * np.ones((1, W, 1)),
            np.ones((H, W, 1))), -1)[..., 0, :]  # [H, W, 3]
        dirs = dirs_cam @ Rwc.T
        best_t = np.full((H, W), np.inf, np.float64)
        best_i = np.full((H, W), -1, np.int32)
        for i, p in enumerate(self.planes):
            o, n, bu, bv, tex, sc = p[:6]
            ext = p[6] if len(p) > 6 else None
            denom = dirs @ n
            tt = ((o - C) @ n) / np.where(np.abs(denom) > 1e-9, denom, 1e-9)
            hit = (tt > 0.3) & (np.abs(denom) > 1e-9)
            if ext is not None:
                X = C[None, None, :] + tt[..., None] * dirs
                lu = (X - o) @ bu
                lv = (X - o) @ bv
                hit &= ((lu >= ext[0]) & (lu <= ext[1])
                        & (lv >= ext[2]) & (lv <= ext[3]))
            # depth along camera z = t * dir_cam_z (dir_cam z = 1) => t is
            # the z-depth scale directly since dirs_cam[...,2]=1
            closer = hit & (tt < best_t)
            best_t = np.where(closer, tt, best_t)
            best_i = np.where(closer, i, best_i)
        return best_i, best_t, C, dirs


def _bilinear(tex, u, v):
    th, tw = tex.shape
    u = np.clip(u, 0, tw - 1.001)
    v = np.clip(v, 0, th - 1.001)
    u0 = u.astype(np.int64)
    v0 = v.astype(np.int64)
    fu = u - u0
    fv = v - v0
    return (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u0 + 1] * fu * (1 - fv)
            + tex[v0 + 1, u0] * (1 - fu) * fv + tex[v0 + 1, u0 + 1] * fu * fv)


def _corner_texture(rng, size=1024, min_block=5, max_block=19):
    """APERIODIC blocky random texture: random-width row/column partitions
    filled with random intensities. A regular grid (fixed block size) makes
    every corner repeat at one period — tracking then locks onto the
    neighboring block's identical corner once the prediction error reaches
    the period, and the error grows geometrically (observed runaway)."""
    def cuts():
        edges = [0]
        while edges[-1] < size:
            edges.append(edges[-1] + int(rng.integers(min_block, max_block)))
        edges[-1] = size
        return np.array(edges)

    rows = cuts()
    cols = cuts()
    cell = rng.uniform(20, 235, (len(rows) - 1, len(cols) - 1))
    ridx = np.searchsorted(rows, np.arange(size), side="right") - 1
    cidx = np.searchsorted(cols, np.arange(size), side="right") - 1
    tex = cell[np.ix_(ridx, cidx)]
    # light smoothing for gradients
    k = np.array([0.25, 0.5, 0.25])
    for ax in (0, 1):
        tex = (np.take(tex, np.clip(np.arange(size) - 1, 0, size - 1), ax) * k[0]
               + tex * k[1]
               + np.take(tex, np.clip(np.arange(size) + 1, 0, size - 1), ax) * k[2])
    return tex.astype(np.float32)


def _rich_texture(rng, size=1024):
    """Corner texture with per-cell photometric variation: the plain blocky
    texture's corners are locally near-identical (every 4-block junction
    looks alike), which makes BRIEF descriptors ambiguous enough that a
    0.7-ratio test (the reference's SearchByBoW) rejects most matches on a
    mono bootstrap map. Overlaying a smooth low-frequency field plus
    smoothed speckle makes each corner's 31x31 BRIEF support distinctive
    while keeping the corner geometry (FAST responses) intact."""
    tex = _corner_texture(rng, size)
    coarse = rng.uniform(-60, 60, (size // 64 + 2, size // 64 + 2))
    ramp = np.kron(coarse, np.ones((64, 64)))[:size, :size]
    k = np.ones(33) / 33.0
    ramp = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 0, ramp)
    ramp = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, ramp)
    speck = rng.uniform(-50, 50, (size, size))
    k2 = np.array([0.25, 0.5, 0.25])
    for _ in range(2):
        speck = np.apply_along_axis(
            lambda r: np.convolve(r, k2, "same"), 0, speck)
        speck = np.apply_along_axis(
            lambda r: np.convolve(r, k2, "same"), 1, speck)
    return np.clip(tex + ramp + speck, 5, 250).astype(np.float32)


def make_room(seed=0, width=640, height=480, fx=500.0, fy=500.0,
              depth=8.0, half_w=4.5, half_h=3.0,
              texture: str = "corner") -> RoomScene:
    rng = np.random.default_rng(seed)
    tex_fn = _rich_texture if texture == "rich" else _corner_texture
    K = np.array([[fx, 0, width / 2], [0, fy, height / 2], [0, 0, 1]], np.float32)
    texel = 60.0  # texture pixels per meter
    planes = []
    # back wall at z = depth
    planes.append((np.array([0.0, 0.0, depth]), np.array([0.0, 0.0, -1.0]),
                   np.array([1.0, 0.0, 0.0]), np.array([0.0, 1.0, 0.0]),
                   tex_fn(rng), texel))
    # left wall at x = -half_w and right wall at x = +half_w
    planes.append((np.array([-half_w, 0.0, 0.0]), np.array([1.0, 0.0, 0.0]),
                   np.array([0.0, 0.0, 1.0]), np.array([0.0, 1.0, 0.0]),
                   tex_fn(rng), texel))
    planes.append((np.array([half_w, 0.0, 0.0]), np.array([-1.0, 0.0, 0.0]),
                   np.array([0.0, 0.0, 1.0]), np.array([0.0, 1.0, 0.0]),
                   tex_fn(rng), texel))
    # floor y = +half_h, ceiling y = -half_h
    planes.append((np.array([0.0, half_h, 0.0]), np.array([0.0, -1.0, 0.0]),
                   np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0]),
                   tex_fn(rng), texel))
    planes.append((np.array([0.0, -half_h, 0.0]), np.array([0.0, 1.0, 0.0]),
                   np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0]),
                   tex_fn(rng), texel))
    return RoomScene(planes, K, width, height)


def make_corridor(seed=0, width=640, height=480, fx=500.0, fy=500.0,
                  outer=10.0, inner=5.0, half_h=2.0) -> RoomScene:
    """Square corridor circuit: an outer box (|x|,|z| <= outer) minus an
    inner box (|x|,|z| <= inner), textured walls + floor + ceiling. Unlike
    a single room, a camera travelling the circuit loses sight of early
    landmarks for most of the lap, so odometry drift ACCUMULATES — the
    loop-closure workload the reference is evaluated on (KITTI circuits).
    Requires finite plane extents (non-convex environment)."""
    rng = np.random.default_rng(seed)
    K = np.array([[fx, 0, width / 2], [0, fy, height / 2], [0, 0, 1]],
                 np.float32)
    ex = lambda half: (-half, half, -half_h, half_h)  # noqa: E731
    planes = []
    Y = np.array([0.0, 1.0, 0.0])
    # outer walls (normals point inward), finite panels
    for sgn in (-1.0, 1.0):
        # x = ±outer
        planes.append((np.array([sgn * outer, 0.0, 0.0]),
                       np.array([-sgn, 0.0, 0.0]),
                       np.array([0.0, 0.0, 1.0]), Y,
                       _corner_texture(rng), 45.0, ex(outer)))
        # z = ±outer
        planes.append((np.array([0.0, 0.0, sgn * outer]),
                       np.array([0.0, 0.0, -sgn]),
                       np.array([1.0, 0.0, 0.0]), Y,
                       _corner_texture(rng), 45.0, ex(outer)))
        # inner walls (normals point outward into the corridor)
        planes.append((np.array([sgn * inner, 0.0, 0.0]),
                       np.array([sgn, 0.0, 0.0]),
                       np.array([0.0, 0.0, 1.0]), Y,
                       _corner_texture(rng), 60.0, ex(inner)))
        planes.append((np.array([0.0, 0.0, sgn * inner]),
                       np.array([0.0, 0.0, sgn]),
                       np.array([1.0, 0.0, 0.0]), Y,
                       _corner_texture(rng), 60.0, ex(inner)))
    # floor (y = +half_h) and ceiling (y = -half_h)
    planes.append((np.array([0.0, half_h, 0.0]), np.array([0.0, -1.0, 0.0]),
                   np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0]),
                   _corner_texture(rng), 45.0,
                   (-outer, outer, -outer, outer)))
    planes.append((np.array([0.0, -half_h, 0.0]), np.array([0.0, 1.0, 0.0]),
                   np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0]),
                   _corner_texture(rng), 45.0,
                   (-outer, outer, -outer, outer)))
    return RoomScene(planes, K, width, height)


def corridor_trajectory(n_frames: int, radius=8.0, laps=1.0, helix=0.0):
    """Circular circuit of `radius` inside the corridor, camera facing its
    direction of travel (tangent): the classic revisit-after-a-lap
    loop-closure trajectory. Returns [F, 3, 4] Tcw.

    helix > 0 descends the camera by `helix` meters per lap (keep
    laps*helix well under make_corridor's half_h): each lap then maps
    fresh viewpoints beside the previous lap's ring, so drift accumulates
    again every lap and the loop machinery must close a loop per revisit."""
    poses = []
    for i in range(n_frames):
        th = 2.0 * np.pi * laps * i / max(n_frames - 1, 1)
        c, s = np.cos(th), np.sin(th)
        C = np.array([radius * s,
                      0.015 * np.sin(th * 5) + helix * th / (2.0 * np.pi),
                      radius * c])
        z_cam = np.array([c, 0.0, -s])          # tangent (direction of travel)
        y_cam = np.array([0.0, 1.0, 0.0])
        x_cam = np.cross(y_cam, z_cam)
        Rwc = np.stack([x_cam, y_cam, z_cam], axis=1)
        Rcw = Rwc.T
        tcw = -Rcw @ C
        poses.append(np.hstack([Rcw, tcw[:, None]]).astype(np.float32))
    return np.stack(poses)


def render_room(scene: RoomScene, Tcw: np.ndarray, noise=1.0, seed=0):
    best_i, best_t, C, dirs = scene.ray_depths(Tcw)
    img = np.full((scene.height, scene.width), 90.0, np.float32)
    for i, p in enumerate(scene.planes):
        o, n, bu, bv, tex, sc = p[:6]
        m = best_i == i
        if not m.any():
            continue
        X = C[None, :] + best_t[m][:, None] * dirs[m]
        u = ((X - o) @ bu) * sc + tex.shape[1] * 0.5
        v = ((X - o) @ bv) * sc + tex.shape[0] * 0.5
        img[m] = _bilinear(tex, u, v)
    if noise > 0:
        rng = np.random.default_rng(seed)
        img = img + rng.normal(0, noise, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.float32)


def depth_room(scene: RoomScene, Tcw: np.ndarray):
    best_i, best_t, _, _ = scene.ray_depths(Tcw)
    d = np.where(best_i >= 0, best_t, 0.0)
    return d.astype(np.float32)


def orbit_trajectory(n_frames: int, radius=0.8, forward=0.0, seed=0):
    """Smooth sideways arc with small yaw, keeping the scene in view.
    Returns [F, 3, 4] ground-truth Tcw poses."""
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        # camera center moves along x with slight z progress; yaw keeps
        # looking at scene center
        cx = radius * np.sin(s * np.pi * 0.5)
        cz = forward * s
        yaw = -0.25 * s  # radians
        cy, sy = np.cos(yaw), np.sin(yaw)
        Rwc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
        C = np.array([cx, 0.02 * np.sin(s * 6), cz], np.float32)
        Rcw = Rwc.T
        tcw = -Rcw @ C
        poses.append(np.hstack([Rcw, tcw[:, None]]).astype(np.float32))
    return np.stack(poses)


def sweep_trajectory(n_frames: int, step=0.07):
    """Constant-speed one-way lateral sweep facing the back wall: the
    monocular two-view-initialization + tracking workload, and the RGB-D
    workload that leaves the first keyframe's view. One-way: the
    reference's constant-velocity motion model loses tracking at zig-zag
    reversals, and its initializer keeps the FIRST frame as reference while
    >=100 matches persist, so parallax ACCUMULATES — step=0.07 m/frame
    over the rich-texture room with light noise is the measured recipe
    where the reference binary initializes once and tracks the whole
    sequence (BASELINE.md mono head-to-head). Returns [F, 3, 4] Tcw."""
    poses = []
    for i in range(n_frames):
        x = -0.5 * step * n_frames + step * i
        C = np.array([x, 0.03 * np.sin(i * 0.5), 0.0], np.float32)
        R = np.eye(3, dtype=np.float32)
        poses.append(np.hstack([R, (-R @ C)[:, None]]).astype(np.float32))
    return np.stack(poses)


def loop_trajectory(n_frames: int, radius=1.5, seed=0):
    """Closed circular path inside the room, camera facing outward: the end
    revisits the start (the loop-closure workload). Returns [F, 3, 4] Tcw."""
    poses = []
    for i in range(n_frames):
        a = 2 * np.pi * i / n_frames
        # camera center on the circle, looking radially outward
        C = np.array([radius * np.sin(a), 0.0, -radius * np.cos(a)], np.float32)
        yaw = a
        cy, sy = np.cos(yaw), np.sin(yaw)
        Rwc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
        Rcw = Rwc.T
        poses.append(np.hstack([Rcw, (-Rcw @ C)[:, None]]).astype(np.float32))
    return np.stack(poses)
