"""The map-merge cell of chip_smoke.py phase 9b through one package's
Systems on the CPU, and one line of what the merge did:

    JAX_PLATFORMS=cpu python tests/torch_merge_cell.py jax
    python tests/torch_merge_cell.py port --size 320 240

Two RGB-D sessions over the halves of the bench's 120-frame room sweep
(synth.make_room(seed=0), sweep_trajectory(120), renders with seed i and
depth): session A tracks frames 0-59, session B frames 40-99 (B's world is
its own first camera), each one frame at a time through track_rgbd with the
mapper inline; then B's map is merged into A's (map_merge.merge_maps). The
package is `jax` (orbslam2_tpu) or `port` (orbslam2_tpu_torch on the CPU);
the configuration is the bench's RGB-D row (profile_frame.bench_config:
the room's pinhole camera, bf = 250, ThDepth = 25, 1000 features) in both.
`--size W H` cuts the images (fx scales with the width), `--frames`,
`--a FIRST END` and `--b FIRST END` the sweep and its halves.

It prints both sessions' keyframes, the keyframe pair the alignment came
from and its RANSAC inliers, the merged keyframes and points, the frames of
the merged keyframes, the metric ATE (SE(3)-aligned) of each session's
keyframes and of the merged ones against the ground truth, each merged
keyframe's error with the map aligned on A's keyframes alone, and the
seconds each step took on this host.
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("package", choices=("jax", "port"))
    ap.add_argument("--size", type=int, nargs=2, default=(640, 480))
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--a", type=int, nargs=2, default=(0, 60))
    ap.add_argument("--b", type=int, nargs=2, default=(40, 100))
    ap.add_argument("--threads", type=int, default=0, help="torch CPU threads")
    a = ap.parse_args()

    inliers = []
    if a.package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from orbslam2_tpu import config as C
        from orbslam2_tpu import map_merge as MM
        from orbslam2_tpu.system import System
        ransac = MM.S3.sim3_ransac

        def recording(*args, **kw):  # JAX's merge returns no inlier count
            res = ransac(*args, **kw)
            inliers.append(int(res.n_inliers))
            return res
        MM.S3.sim3_ransac = recording
        kw = {}
    else:
        import torch
        if a.threads:
            torch.set_num_threads(a.threads)
        from orbslam2_tpu_torch import config as C
        from orbslam2_tpu_torch import map_merge as MM
        from orbslam2_tpu_torch.system import System
        kw = {"device": "cpu"}
    # host numpy: the renders and the evaluation are the same in both packages
    from orbslam2_tpu_torch.io import synth
    from orbslam2_tpu_torch.utils.evaluation import ate_rmse, camera_centers, umeyama

    w, h = a.size
    f = 500.0 * w / 640
    scene = synth.make_room(seed=0, width=w, height=h, fx=f, fy=f)
    gt = synth.sweep_trajectory(a.frames)
    cfg = C.with_camera(C.SlamConfig(sensor=C.Sensor.RGBD, th_depth=25.0),
                        fx=f, fy=f, cx=float(scene.K[0, 2]), cy=float(scene.K[1, 2]),
                        k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0, width=w, height=h,
                        bf=250.0 * w / 640)

    def session(first, end):
        slam = System(cfg, **kw)
        t0 = time.perf_counter()
        for i in range(first, end):
            img = np.clip(synth.render_room(scene, gt[i], seed=i), 0, 255).astype(np.uint8)
            slam.track_rgbd(img, synth.depth_room(scene, gt[i]), i / 30.0)
        return slam, time.perf_counter() - t0

    def keyframes(mp):
        ids = mp.kf_ids
        fids = np.round(mp.kf_timestamp[ids] * 30).astype(int)
        return camera_centers(mp.kf_pose[ids]), camera_centers(gt[fids]), fids

    def ate(mp):
        est, truth, _ = keyframes(mp)
        return ate_rmse(est, truth, with_scale=False)

    sys_a, sec_a = session(*a.a)
    sys_b, sec_b = session(*a.b)
    n_a, n_b = sys_a.map.n_keyframes, sys_b.map.n_keyframes
    ate_a, ate_b = ate(sys_a.map), ate(sys_b.map)
    t0 = time.perf_counter()
    if a.package == "jax":
        found = []
        find = MM.find_cross_map_alignment

        def finding(*args, **k):  # nor the alignment it used
            found.append(find(*args, **k))
            return found[-1]
        MM.find_cross_map_alignment = finding
        ok = MM.merge_maps(sys_a, sys_b.map)
        W = found[-1][1] if ok else None
    else:
        W = MM.merge_maps(sys_a, sys_b.map)
        inliers = [W["n_inliers"]] if W else []
    sec_m = time.perf_counter() - t0
    mp = sys_a.map
    est, truth, fids = keyframes(mp)
    ate_m = ate(mp)
    # every merged keyframe's error once the map is aligned on A's own
    _, R, t = umeyama(est[:n_a], truth[:n_a], with_scale=False)
    err = np.linalg.norm(est @ R.T + t - truth, axis=1)
    pair = (W["ka"], W["kb"]) if W else None
    print(f"{a.package} merge cell {w}x{h}, sweep {a.frames}, A {a.a[0]}-{a.a[1] - 1}, "
          f"B {a.b[0]}-{a.b[1] - 1}: keyframes A {n_a}, B {n_b}; alignment from keyframe "
          f"pair {pair} (scale {W['s'] if W else None}), RANSAC inliers "
          f"{inliers[-1] if inliers else None}; merged keyframes {mp.n_keyframes} "
          f"(frames {fids.tolist()}), points {mp.n_points}; metric ATE of the keyframes: "
          f"A alone {ate_a * 100:.3f} cm, B alone {ate_b * 100:.3f} cm, merged "
          f"{ate_m * 100:.3f} cm; each merged keyframe's error in cm with the map "
          f"aligned on A's {np.round(100 * err, 2).tolist()}; seconds: A {sec_a:.0f}, "
          f"B {sec_b:.0f}, merge {sec_m:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
