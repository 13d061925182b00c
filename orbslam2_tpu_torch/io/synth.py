"""Synthetic sequences with exact ground truth.

orbslam2_tpu/io/synth.py, copied (numpy only) so that the port and
chip_smoke.py can render the benchmark, loop and endurance sequences on a
machine without JAX: the scene of textured squares (make_scene, render,
make_sequence); a textured room, a square corridor circuit and two nested
corridor rings rendered by exact ray-plane intersection, and their depth
maps; the orbit, sweep, corridor-lap, two-ring and in-room loop camera
trajectories.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np


@dataclass
class SynthScene:
    pts: np.ndarray        # [M, 3] world points
    subtex: np.ndarray     # [M, S, S] per-square texture: makes each square's
    #                        corners DISTINCTIVE (uniform squares alias —
    #                        every bright-square corner gets the same rotated
    #                        BRIEF descriptor, which systematically mismatches
    #                        to neighboring squares and biases BA)
    size_world: np.ndarray  # [M] half-size in meters
    K: np.ndarray          # [3, 3]
    width: int
    height: int

    @property
    def intensity(self):  # mean brightness, kept for older callers
        return self.subtex.mean(axis=(1, 2))


def make_scene(seed=0, n_pts=600, width=640, height=480,
               fx=500.0, fy=500.0, depth_range=(4.0, 9.0),
               spread=(6.0, 4.5)) -> SynthScene:
    rng = np.random.default_rng(seed)
    pts = np.stack([
        rng.uniform(-spread[0], spread[0], n_pts),
        rng.uniform(-spread[1], spread[1], n_pts),
        rng.uniform(*depth_range, n_pts),
    ], -1).astype(np.float32)
    # unique 3x3 high-contrast texture per square
    subtex = rng.uniform(0, 255, (n_pts, 3, 3)).astype(np.float32)
    # push cells away from the background gray for strong corners
    subtex = np.where(subtex > 128, np.maximum(subtex, 180.0),
                      np.minimum(subtex, 70.0))
    size = rng.uniform(0.03, 0.07, n_pts).astype(np.float32)
    K = np.array([[fx, 0, width / 2], [0, fy, height / 2], [0, 0, 1]], np.float32)
    return SynthScene(pts, subtex, size, K, width, height)


def render(scene: SynthScene, Tcw: np.ndarray, noise=1.5, seed=0) -> np.ndarray:
    """Render one view. Painter's algorithm: far squares first."""
    R, t = Tcw[:3, :3], Tcw[:3, 3]
    pc = scene.pts @ R.T + t
    z = pc[:, 2]
    vis = z > 0.5
    uv = pc[:, :2] / np.maximum(z[:, None], 1e-6)
    u = scene.K[0, 0] * uv[:, 0] + scene.K[0, 2]
    v = scene.K[1, 1] * uv[:, 1] + scene.K[1, 2]
    half = scene.size_world * scene.K[0, 0] / np.maximum(z, 1e-6)
    img = np.full((scene.height, scene.width), 128.0, np.float32)
    S = scene.subtex.shape[1]
    order = np.argsort(-z)
    for i in order:
        if not vis[i]:
            continue
        h = half[i]
        x0, x1 = int(u[i] - h), int(u[i] + h) + 1
        y0, y1 = int(v[i] - h), int(v[i] + h) + 1
        if x1 <= 0 or y1 <= 0 or x0 >= scene.width or y0 >= scene.height:
            continue
        xs0, xs1 = max(x0, 0), min(x1, scene.width)
        ys0, ys1 = max(y0, 0), min(y1, scene.height)
        # nearest-neighbor sample of the square's SxS texture
        cx = np.clip(((np.arange(xs0, xs1) - x0) * S) // max(x1 - x0, 1), 0, S - 1)
        cy = np.clip(((np.arange(ys0, ys1) - y0) * S) // max(y1 - y0, 1), 0, S - 1)
        img[ys0:ys1, xs0:xs1] = scene.subtex[i][np.ix_(cy, cx)]
    if noise > 0:
        rng = np.random.default_rng(seed)
        img = img + rng.normal(0, noise, img.shape).astype(np.float32)
    return np.clip(img, 0, 255)


# each thread's last RoomScene.ray_depths: (scene, pose bytes, result)
_LAST_RAYS = threading.local()


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
        """Per-pixel hit (plane index, depth) for a camera pose. Each thread
        keeps its last result, so an image and the depth map of one pose
        (render_room, then depth_room) cast the rays once; the callers only
        read the arrays."""
        key = np.asarray(Tcw).tobytes()
        last = getattr(_LAST_RAYS, "hit", None)
        if last is not None and last[0] is self and last[1] == key:
            return last[2]
        hit = self._cast_rays(Tcw)
        _LAST_RAYS.hit = (self, key, hit)
        return hit

    def _cast_rays(self, Tcw: np.ndarray):
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


def make_corridor_rings(seed=0, width=640, height=480, fx=500.0, fy=500.0,
                        outer=16.0, shared=10.0, inner=5.0, half_h=2.0,
                        door=2.0) -> RoomScene:
    """TWO nested square corridor rings sharing the wall at |x|,|z| =
    shared, connected by a doorway in the x=+shared wall at |z| <= door.

    A route lapping ring 1, passing the door, lapping ring 2 and
    returning contains TWO distinct topological loops — the multi-closure
    regime of KITTI 00 — whereas a single ring admits exactly one
    explicit closure (see BASELINE.md round-5 endurance notes)."""
    rng = np.random.default_rng(seed)
    K = np.array([[fx, 0, width / 2], [0, fy, height / 2], [0, 0, 1]],
                 np.float32)
    planes = []
    Y = np.array([0.0, 1.0, 0.0])
    Z = np.array([0.0, 0.0, 1.0])
    X = np.array([1.0, 0.0, 0.0])

    def wall(o, n, bu, ext_u, sc):
        planes.append((np.asarray(o, float), np.asarray(n, float),
                       np.asarray(bu, float), Y, _corner_texture(rng), sc,
                       (ext_u[0], ext_u[1], -half_h, half_h)))

    # outer ring boundary at +-outer
    for sgn in (-1.0, 1.0):
        wall([sgn * outer, 0, 0], [-sgn, 0, 0], Z, (-outer, outer), 45.0)
        wall([0, 0, sgn * outer], [0, 0, -sgn], X, (-outer, outer), 45.0)
    # shared box at +-shared (two-sided planes; the ray tracer does not
    # cull by normal sign). The x=+shared wall carries doorway A (the
    # outbound transit) and the z=-shared wall doorway B (the return) —
    # separate doors let both transits run straight without the path
    # ever doubling back through itself.
    wall([-shared, 0, 0], [1, 0, 0], Z, (-shared, shared), 60.0)
    wall([0, 0, shared], [0, 0, -1], X, (-shared, shared), 60.0)
    wall([0, 0, -shared], [0, 0, 1], X, (-shared, -door), 60.0)
    wall([0, 0, -shared], [0, 0, 1], X, (door, shared), 60.0)
    wall([shared, 0, 0], [-1, 0, 0], Z, (-shared, -door), 60.0)
    wall([shared, 0, 0], [-1, 0, 0], Z, (door, shared), 60.0)
    # inner box at +-inner
    for sgn in (-1.0, 1.0):
        wall([sgn * inner, 0, 0], [sgn, 0, 0], Z, (-inner, inner), 60.0)
        wall([0, 0, sgn * inner], [0, 0, sgn], X, (-inner, inner), 60.0)
    # floor and ceiling
    planes.append((np.array([0.0, half_h, 0.0]), np.array([0.0, -1.0, 0.0]),
                   X, Z, _corner_texture(rng), 45.0,
                   (-outer, outer, -outer, outer)))
    planes.append((np.array([0.0, -half_h, 0.0]), np.array([0.0, 1.0, 0.0]),
                   X, Z, _corner_texture(rng), 45.0,
                   (-outer, outer, -outer, outer)))
    return RoomScene(planes, K, width, height)


def waypoint_trajectory(waypoints, n_frames: int, smooth: int = 41,
                        y_wobble: float = 0.015):
    """Constant-arc-length resampling of a 3D waypoint polyline with
    moving-average corner rounding; camera z = direction of travel.
    Returns [F, 3, 4] Tcw. The smoothing window bounds the angular rate
    through corners (90-degree turns spread over ~`smooth` frames)."""
    P = np.asarray(waypoints, np.float64)
    # drop zero-length segments: duplicated junction waypoints create
    # repeated arc-length values, which bunch dense samples at the
    # junction and defeat the corner smoothing exactly where it matters
    keep = np.concatenate(
        [[True], np.linalg.norm(np.diff(P, axis=0), axis=1) > 1e-9])
    P = P[keep]
    # densify the polyline, then resample at constant arc length
    seg = np.linalg.norm(np.diff(P, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    dense_s = np.linspace(0.0, cum[-1], max(n_frames * 4, 4000))
    D = np.stack([np.interp(dense_s, cum, P[:, k]) for k in range(3)], -1)
    # moving-average smooth (rounds corners, slows through them)
    w = max(int(smooth) * 4 | 1, 5)
    pad = w // 2
    Dp = np.concatenate([D[:1].repeat(pad, 0), D, D[-1:].repeat(pad, 0)])
    kern = np.ones(w) / w
    Ds = np.stack([np.convolve(Dp[:, k], kern, "valid") for k in range(3)], -1)
    # re-resample the smoothed curve at constant arc length
    seg2 = np.linalg.norm(np.diff(Ds, axis=0), axis=1)
    cum2 = np.concatenate([[0.0], np.cumsum(seg2)])
    s = np.linspace(0.0, cum2[-1], n_frames)
    C = np.stack([np.interp(s, cum2, Ds[:, k]) for k in range(3)], -1)
    C[:, 1] += y_wobble * np.sin(np.arange(n_frames) * 0.11)
    # heading from the tangent
    T = np.gradient(C, axis=0)
    T /= np.maximum(np.linalg.norm(T, axis=1, keepdims=True), 1e-9)
    poses = []
    up = np.array([0.0, 1.0, 0.0])
    for i in range(n_frames):
        z_cam = T[i]
        x_cam = np.cross(up, z_cam)
        x_cam /= max(np.linalg.norm(x_cam), 1e-9)
        y_cam = np.cross(z_cam, x_cam)
        Rwc = np.stack([x_cam, y_cam, z_cam], axis=1)
        Rcw = Rwc.T
        poses.append(np.hstack([Rcw, (-Rcw @ C[i])[:, None]]
                               ).astype(np.float32))
    return np.stack(poses)


def rings_trajectory(n_frames: int, r1=8.2, r2=15.0, lap1=1.1, lap2=1.25,
                     tail=0.35):
    """The two-loop route through make_corridor_rings: lap ring 1 (its
    revisit closes loop #1), exit the doorway, lap ring 2 (loop #2),
    return, and finish with a partial ring-1 lap. The revisit overlap of
    each lap spirals slightly INWARD (r shrinks ~0.5 m over the lap) so
    the overshoot past the start point crosses the earlier track
    laterally instead of doubling back through it — no cusp, bounded
    angular rate. Waypoints on circles around the origin; the door
    transit runs along +x at z = 0."""
    def spiral(r0, r1_, th0, th1, n):
        th = np.linspace(th0, th1, n)
        r = np.linspace(r0, r1_, n)
        return np.stack([r * np.sin(th), np.zeros_like(th),
                         r * np.cos(th)], -1)
    two_pi = 2.0 * np.pi
    half_pi = 0.5 * np.pi
    # Radii must clear the square bands' inscribed-circle limits: a
    # circle of radius r inside band {w_in < max|x|,|z| < w_out} needs
    # r/sqrt(2) > w_in. Ring 1 (5..10): r in (7.1, 10) -> 8.2 -> 7.8;
    # ring 2 (10..16): r in (14.2, 16) -> 15.0 -> 14.6.
    #
    # ring 1: `lap1` inward-spiralling laps STARTING 0.2 laps before door
    # A (door A sits on the +x axis, theta=pi/2) so the revisit overlap
    # past 1.0 lap ends just SHORT of the door, heading toward it — the
    # exit chord then continues forward (no reversal). Loop #1 closes
    # during that overlap.
    th0 = half_pi - 0.2 * two_pi
    a = spiral(r1, r1 - 0.4, th0, th0 + lap1 * two_pi, 160)
    ax, az = a[-1, 0], a[-1, 2]
    transit_out = np.array([[ax, 0.0, az], [10.2, 0.0, -0.3],
                            [r2, 0.0, 0.0]])
    # ring 2: enter at door A, spiral `lap2` laps — the revisit overlap
    # past 1.0 lap closes loop #2, and the extra quarter-lap delivers the
    # camera to door B (theta=pi, the -z axis) without reversing
    b = spiral(r2, r2 - 0.4, half_pi, half_pi + lap2 * two_pi, 220)
    bx, bz = b[-1, 0], b[-1, 2]
    r_tail = r1 - 0.4
    transit_back = np.array([[bx, 0.0, bz], [0.0, 0.0, -r_tail]])
    # tail: a partial ring-1 lap in the corrected map
    c = spiral(r_tail, r_tail, np.pi, np.pi + tail * two_pi, 60)
    pts = np.concatenate([a, transit_out, b, transit_back, c])
    return waypoint_trajectory(pts, n_frames)


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


def sweep_trajectory(n_frames: int, step=0.07, one_way=True, amplitude=1.8):
    """Constant-speed lateral sweep facing the back wall: the monocular
    two-view-initialization + tracking workload. One-way by default: the
    reference's constant-velocity motion model loses tracking at zig-zag
    reversals, and its initializer keeps the FIRST frame as reference while
    >=100 matches persist, so parallax ACCUMULATES — step=0.07 m/frame
    one-way over the rich-texture room with light noise is the measured
    recipe where the reference binary initializes once and tracks the whole
    sequence (BASELINE.md mono head-to-head). one_way=False restores the
    r2 zig-zag. Returns [F, 3, 4] Tcw."""
    poses = []
    if one_way:
        for i in range(n_frames):
            x = -0.5 * step * n_frames + step * i
            C = np.array([x, 0.03 * np.sin(i * 0.5), 0.0], np.float32)
            R = np.eye(3, dtype=np.float32)
            poses.append(np.hstack([R, (-R @ C)[:, None]]).astype(np.float32))
        return np.stack(poses)
    x, direction = 0.0, 1.0
    for i in range(n_frames):
        C = np.array([x, 0.04 * np.sin(i * 0.7), 0.0], np.float32)
        # gentle yaw into the direction of travel (keeps views overlapping)
        yaw = 0.05 * direction
        cy, sy = np.cos(yaw), np.sin(yaw)
        Rwc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
        Rcw = Rwc.T
        poses.append(np.hstack([Rcw, (-Rcw @ C)[:, None]]).astype(np.float32))
        x += direction * step
        if abs(x) > amplitude:
            direction = -direction
            x = np.clip(x, -amplitude, amplitude) + direction * step
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


def make_sequence(n_frames=60, seed=0, **scene_kw):
    """Convenience: scene + trajectory + rendered frames generator."""
    scene = make_scene(seed=seed, **scene_kw)
    poses = orbit_trajectory(n_frames)
    frames = [render(scene, poses[i], seed=seed * 1000 + i) for i in range(n_frames)]
    return scene, poses, frames
