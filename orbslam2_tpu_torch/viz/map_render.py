"""Headless map and frame renders: the top-down map (points, keyframes with
their viewing direction, covisibility edges, trajectory) and the frame
overlay (keypoints by tracking state).

Counterpart of orbslam2_tpu/viz/map_render.py, with the same two entry
points. Each is two steps: a scene function returns, in world (map) or
pixel (frame) coordinates, exactly the arrays the JAX function hands
matplotlib; the scene is then drawn on a raster.Canvas and written as a PNG
by io/png.write_png, to a filename or a binary file-like object (the live
viewer renders into memory).
"""
from __future__ import annotations

import numpy as np

from ..io.png import write_png
from .raster import Canvas, View, nice_ticks, text_width

MAP_PX = 900                   # the map image is square
MAP_MARGIN = (52, 16, 16, 40)  # plot area inset: left, top, right, bottom
ARROW = 0.12                   # keyframe viewing-direction arrow, world units
COVIS_MIN = 100                # covisibility weight of a drawn edge
GRAY, BLUE, GREEN, RED = "#777777", "#1f77b4", "#2ca02c", "#d62728"
YELLOW, LIME = "#ffff00", "#00ff00"
TITLE_PX = 14                  # the frame overlay's title bar


def map_scene(mp, trajectory=None, axes=(0, 2), show_covisibility=True,
              show_points=True) -> dict:
    """What render_map_topdown draws, in the world coordinates of `axes`:

    - "points" [P, 2]: the valid map points (None if not `show_points`);
    - "kf_centers" [K, 2] and "kf_tips" [K, 2]: each keyframe's centre
      -R^T t and the tip of its arrow, centre + 0.12 z_dir (z_dir the
      camera's z axis in the world, row 2 of Rcw);
    - "covis" [S, 2, 2]: a segment between the centres of keyframes k and
      j > k sharing at least 100 points (empty if not `show_covisibility`);
    - "trajectory" [F, 2]: the centres of the frame poses `trajectory`
      ([F, 3, 4] Tcw), or None.
    """
    a, b = axes
    pts = mp.pt_xyz[mp.pt_valid]
    kf_ids = mp.kf_ids
    poses = mp.kf_pose[kf_ids]
    centers = _centers(poses)
    tips = centers + ARROW * poses[:, 2, :3]
    segs = []
    if show_covisibility and len(kf_ids) > 1:
        for i, k in enumerate(kf_ids):
            w = mp.covisibility_weights(int(k))
            for j_pos, j in enumerate(kf_ids):
                if j <= k or w[j] < COVIS_MIN:
                    continue
                segs.append([[centers[i, a], centers[i, b]],
                             [centers[j_pos, a], centers[j_pos, b]]])
    traj = None
    if trajectory is not None and len(trajectory):
        traj = _centers(trajectory)[:, [a, b]]
    return {
        "axes": (a, b),
        "points": pts[:, [a, b]] if show_points else None,
        "n_points": len(pts),
        "kf_centers": centers[:, [a, b]],
        "kf_tips": tips[:, [a, b]],
        "covis": np.array(segs, np.float64).reshape(-1, 2, 2),
        "trajectory": traj,
    }


def _centers(poses) -> np.ndarray:
    """[N, 3] camera centres -R^T t of [N, 3, 4] Tcw poses, one pose at a
    time in the poses' own precision, as the JAX render computes them."""
    if not len(poses):
        return np.zeros((0, 3), np.float32)
    return np.stack([-T[:, :3].T @ T[:, 3] for T in poses])


def frame_scene(frame) -> dict:
    """What render_frame_overlay draws over the image: "detected" [n, 2]
    (valid keypoints without a map point) and "tracked" [m, 2] (with one),
    in raw pixel coordinates, and the title. A lazy block-driver frame whose
    features were never read back (xy_raw None) gives the title alone."""
    if frame.xy_raw is None:
        return {"title": f"frame {frame.frame_id}", "detected": None, "tracked": None}
    v = frame.valid
    tracked = v & (frame.pt_idx >= 0)
    return {"title": f"frame {frame.frame_id}: {tracked.sum()} tracked / {v.sum()} keypoints",
            "detected": frame.xy_raw[v & ~tracked], "tracked": frame.xy_raw[tracked]}


def map_view(scene: dict, center=None, span=6.0) -> View:
    """The plot area's transform: `center +- span` on both axes if a centre
    (a world point [3]) is given, else the bounding box of everything drawn
    with matplotlib's 5% margins."""
    left, top, right, bottom = MAP_MARGIN
    size = MAP_PX - max(left + right, top + bottom)
    if center is not None:
        a, b = scene["axes"]
        return View.centered(float(center[a]), float(center[b]), span, left, top, size)
    parts = [scene["kf_centers"], scene["kf_tips"]]
    parts += [p for p in (scene["points"], scene["trajectory"]) if p is not None]
    xy = np.concatenate([np.asarray(p, np.float64).reshape(-1, 2) for p in parts])
    return View.fit(xy[:, 0], xy[:, 1], left, top, size)


def draw_map(scene: dict, view: View) -> np.ndarray:
    """The scene as an [MAP_PX, MAP_PX, 3] u8 image: points, covisibility
    edges, trajectory, keyframe arrows and squares inside the plot area, the
    axes with ticks and letters, and the legend."""
    cv = Canvas(MAP_PX, MAP_PX)
    plot = Canvas(view.size, view.size)
    inner = View(view.a0, view.b0, view.extent, 0, 0, view.size)

    def px(xy):
        return inner.to_px(xy[:, 0], xy[:, 1])

    if scene["points"] is not None and len(scene["points"]):
        plot.dots(*px(scene["points"]), radius=1.0, color=GRAY, alpha=0.4)
    covis = scene["covis"]
    if len(covis):
        (x0, y0), (x1, y1) = px(covis[:, 0]), px(covis[:, 1])
        plot.segments(x0, y0, x1, y1, GREEN, alpha=0.5)
    if scene["trajectory"] is not None:
        plot.polyline(*px(scene["trajectory"]), RED, width=2.0)
    if len(scene["kf_centers"]):
        (x0, y0), (x1, y1) = px(scene["kf_centers"]), px(scene["kf_tips"])
        plot.arrows(x0, y0, x1, y1, BLUE, head=5.0)
        plot.squares(x0, y0, 2, BLUE)
    cv.px[view.top:view.top + view.size, view.left:view.left + view.size] = plot.px
    _axes(cv, view, scene["axes"])
    _legend(cv, view, scene)
    return cv.pixels()


def _axes(cv: Canvas, view: View, axes) -> None:
    """Frame, ticks with their values, and the axis letters."""
    l, t, s = view.left, view.top, view.size
    cv.rect(l - 1, t - 1, l + s, t + s, "#000000")
    (a_lo, a_hi), (b_lo, b_hi) = view.limits()
    for v in nice_ticks(a_lo, a_hi):
        x = int(np.floor(view.to_px(v, b_lo)[0]))
        cv.segments([x], [t + s], [x], [t + s + 4], "#000000")
        cv.text(x, t + s + 7, f"{v + 0.0:g}", "#000000", anchor="center")
    for v in nice_ticks(b_lo, b_hi):
        y = int(np.floor(view.to_px(a_lo, v)[1]))
        cv.segments([l - 5], [y], [l - 1], [y], "#000000")
        cv.text(l - 8, y - 3, f"{v + 0.0:g}", "#000000", anchor="right")
    cv.text(l + s // 2, t + s + 20, "xyz"[axes[0]], "#000000", scale=2, anchor="center")
    cv.text(6, t + s // 2 - 7, "xyz"[axes[1]], "#000000", scale=2)


def _legend(cv: Canvas, view: View, scene: dict) -> None:
    """The upper-right legend: the counts of points and keyframes, and the
    trajectory's colour."""
    rows = []
    if scene["points"] is not None and len(scene["points"]):
        rows.append((f"{scene['n_points']} points", GRAY))
    if len(scene["kf_centers"]):
        rows.append((f"{len(scene['kf_centers'])} keyframes", BLUE))
    if scene["trajectory"] is not None:
        rows.append(("trajectory", RED))
    if not rows:
        return
    w = max(text_width(s) for s, _ in rows) + 30
    right, top = view.left + view.size - 6, view.top + 6
    cv.fill(right - w, top, right, top + 12 * len(rows) + 6, "#ffffff")
    cv.rect(right - w, top, right, top + 12 * len(rows) + 6, "#cccccc")
    for i, (label, color) in enumerate(rows):
        y = top + 6 + 12 * i
        cv.squares([right - w + 9], [y + 3], 3, color)
        cv.text(right - w + 20, y, label, "#000000")


def draw_frame(img: np.ndarray, scene: dict) -> np.ndarray:
    """The overlay as [H + TITLE_PX, W, 3] u8: the title over the gray
    image, hollow yellow circles on detected-only keypoints and lime ones
    on tracked keypoints."""
    h, w = img.shape[:2]
    cv = Canvas(w, h + TITLE_PX)
    cv.image(img, 0, TITLE_PX)
    cv.text(4, 4, scene["title"], "#000000")
    if scene["detected"] is not None:
        for key, color, radius in (("detected", YELLOW, 3.0), ("tracked", LIME, 4.0)):
            xy = scene[key]
            cv.dots(xy[:, 0], xy[:, 1] + TITLE_PX, radius, color, filled=False)
    return cv.pixels()


def render_map_topdown(mp, trajectory=None, path="map.png", axes=(0, 2),
                       show_covisibility=True, show_points=True, center=None, span=6.0):
    """Top-down (x-z by default) map render, written as a PNG to `path` (a
    filename or a binary file-like object). mp: MapState; trajectory:
    optional [F, 3, 4] Tcw frame poses; center: optional world point to
    centre the view on (the Viewer's follow-camera mode,
    src/Viewer.cpp:128-138) with half-extent `span`."""
    scene = map_scene(mp, trajectory, axes, show_covisibility, show_points)
    write_png(path, draw_map(scene, map_view(scene, center, span)))
    return path


def render_frame_overlay(img, frame, path="frame.png"):
    """Keypoint overlay (the FrameDrawer's): lime = tracked map point,
    yellow = detected only; written as a PNG to `path`."""
    write_png(path, draw_frame(np.asarray(img), frame_scene(frame)))
    return path
