"""One RGB-D lap of the corridor circuit of tests/test_loop_closure_e2e.py
(make_corridor(seed=3) at 640x480, corridor_trajectory(240, radius=8),
renders with noise 2.5 and seed i) through one package's System on the
CPU, in one of the System's modes, and one line of what it tracked:

    JAX_PLATFORMS=cpu python tests/torch_corridor_lap.py jax piped-async
    python tests/torch_corridor_lap.py port sync

The package is `jax` (orbslam2_tpu) or `port` (orbslam2_tpu_torch on the
CPU). The mode is `piped` (run_sequence(pipelined=True), the block driver)
or `sync` (one frame at a time through track_rgbd), with `-async` for the
mapper on its worker. The configuration is the bench's RGB-D row
(profile_frame.bench_config: the room's pinhole camera, bf = 250,
ThDepth = 25, 1000 features) in both packages. `--frames`, `--size W H`
and `--corridor OUTER INNER --radius R` cut the lap (the 320x240 cut of the
tier-1 tests scales fx with the width).

It prints the frames tracked, the first frame whose state was not OK, the
keyframes created (the map's next keyframe id, as the endurance runs count
them) and live, the loops closed and the metric ATE, and the seconds the
lap took on this host.

`--laps L` runs the frames over L laps of the circuit (the endurance runs'
trajectory: `--frames 240 --laps 0.5` is the first 240 frames of their
480-frame lap). `--scene sweep` runs the bench's RGB-D room sweep instead
(make_room(seed=0), sweep_trajectory(frames), renders with seed i, as
chip_smoke.py renders rgbd-sweep-120): the keyframe counts of both packages,
with the mapper inline (`piped`) and on its worker (`piped-async`), are
ROADMAP F4's measurement:

    JAX_PLATFORMS=cpu python tests/torch_corridor_lap.py jax piped --scene sweep \
        --frames 120 --size 320 240

`--decisions FILE` writes every keyframe decision as JSON, [frame, taken,
pose inliers, live keyframes] a frame, so that two packages' runs can be
compared frame by frame.

`--digest FILE` writes one JSON line a frame: the frame's index and a hash
of its pose and of each of the map's arrays (the live keyframes' poses, the
live points' positions, `kf_pt` and the covisibility weights), taken as the
frame is recorded, with the loops closed and global BAs applied so far. Two runs' files part at the first frame, and the first
array, where the runs differ:

    python tests/torch_corridor_lap.py port piped --frames 170 --threads 4 \
        --digest /tmp/a.jsonl

With `--stages` (the port only) each line also lists, in call order, the
hashes after each step of the frame's keyframe work: the tracker's
`_create_keyframe` (the frame's pose as it enters and leaves) and the
mapper's prep, point culling, new points, fuse, local BA (each
`ba_solve`'s problem and result) and keyframe culling, so that the step
where two runs part can be read off.
"""
import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def map_digest(slam) -> dict:
    """Hashes of the last frame's pose and the map's arrays, one a key."""
    def h(a) -> str:
        a = np.ascontiguousarray(a)
        return hashlib.sha1(a.tobytes() + str(a.shape).encode()).hexdigest()[:16]

    m = slam.map
    frame = slam.tracker.last_frame
    pose = getattr(frame, "pose", None)
    with m.lock:
        kv, pv = m.kf_valid.copy(), m.pt_valid.copy()
        return {"pose": h(np.zeros(0) if pose is None else np.asarray(pose)),
                "kf_pose": h(m.kf_pose[kv]), "pt_xyz": h(m.pt_xyz[pv]),
                "kf_pt": h(m.kf_pt[kv]), "covis": h(m.covis_matrix()),
                "loops": slam.loop_closer.n_loops_closed,
                "gba_applied": slam.global_ba.n_applied}


def stage_hashes(slam, log: list) -> None:
    """Wrap the steps of the port's keyframe work so that each appends
    (step, hashes) to `log` when it returns (`--stages`)."""
    from orbslam2_tpu_torch import local_mapping

    def h(*arrays) -> str:
        return hashlib.sha1(b"".join(np.ascontiguousarray(a).tobytes()
                                     for a in arrays)).hexdigest()[:12]

    def map_hash() -> str:
        m = slam.map
        return h(m.kf_pose[m.kf_valid], m.pt_xyz[m.pt_valid], m.kf_pt[m.kf_valid])

    def wrap(obj, name, before=None):
        orig = getattr(obj, name)

        def run(*a, **kw):
            if before is not None:
                log.append((f"{name} in", before(*a)))
            out = orig(*a, **kw)
            log.append((name, before(*a) if before is not None else map_hash()))
            return out
        setattr(obj, name, run)

    tr, lm = slam.tracker, slam.local_mapper
    wrap(tr, "_create_keyframe", lambda frame: h(np.asarray(frame.pose)))
    for name in ("_fetch_prep", "cull_recent_points", "create_new_points",
                 "fuse_neighbors", "local_ba", "cull_keyframes"):
        wrap(lm, name)
    solve = local_mapping.BA.ba_solve

    def hashed_solve(prob, *a, **kw):
        res = solve(prob, *a, **kw)
        log.append(("ba_solve problem", h(*(t.cpu().numpy() for t in prob))))
        log.append(("ba_solve result", h(*(t.cpu().numpy() for t in res))))
        return res
    local_mapping.BA.ba_solve = hashed_solve


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("package", choices=("jax", "port"))
    ap.add_argument("mode", choices=("piped", "piped-async", "sync", "sync-async"))
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--radius", type=float, default=8.0)
    ap.add_argument("--size", type=int, nargs=2, default=(640, 480))
    ap.add_argument("--corridor", type=float, nargs=2, default=(10.0, 5.0))
    ap.add_argument("--laps", type=float, default=1.0)
    ap.add_argument("--scene", choices=("corridor", "sweep"), default="corridor")
    ap.add_argument("--decisions", help="write each frame's keyframe decision here (JSON)")
    ap.add_argument("--threads", type=int, default=0, help="torch CPU threads")
    ap.add_argument("--digest", help="write each frame's pose and map hashes here (JSON lines)")
    ap.add_argument("--stages", action="store_true",
                    help="with --digest: hashes after each step of the keyframe work")
    a = ap.parse_args()

    if a.package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from orbslam2_tpu import config as C
        from orbslam2_tpu.system import System
    else:
        import torch
        if a.threads:
            torch.set_num_threads(a.threads)
        from orbslam2_tpu_torch import config as C
        from orbslam2_tpu_torch.system import System
    # host numpy: the renders and the evaluation are the same in both packages
    from orbslam2_tpu_torch.io import synth
    from orbslam2_tpu_torch.utils.evaluation import ate_rmse, camera_centers

    w, h = a.size
    f = 500.0 * w / 640
    if a.scene == "sweep":
        scene = synth.make_room(seed=0, width=w, height=h, fx=f, fy=f)
        gt = synth.sweep_trajectory(a.frames)
        noise = {}
    else:
        scene = synth.make_corridor(seed=3, width=w, height=h, fx=f, fy=f,
                                    outer=a.corridor[0], inner=a.corridor[1])
        gt = synth.corridor_trajectory(a.frames, radius=a.radius, laps=a.laps)
        noise = {"noise": 2.5}
    items = [(i / 30.0, {"image": synth.render_room(scene, gt[i], seed=i, **noise),
                         "depth": synth.depth_room(scene, gt[i])})
             for i in range(a.frames)]
    cfg = C.with_camera(C.SlamConfig(sensor=C.Sensor.RGBD, th_depth=25.0),
                        fx=f, fy=f, cx=float(scene.K[0, 2]), cy=float(scene.K[1, 2]),
                        k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0, width=w, height=h,
                        bf=250.0 * w / 640)
    kw = {} if a.package == "jax" else {"device": "cpu"}
    slam = System(cfg, async_mapping=a.mode.endswith("async"), **kw)
    decisions = []
    if a.decisions:
        tracker, need = slam.tracker, slam.tracker._need_new_keyframe

        def logged(frame):
            taken = need(frame)
            decisions.append((int(round(frame.timestamp * 30)), bool(taken),
                              int(tracker.matches_inliers), int(slam.map.n_keyframes)))
            return taken
        tracker._need_new_keyframe = logged
    if a.digest:
        digest = open(a.digest, "w")
        append = slam.metrics.append
        steps: list = []
        if a.stages:
            stage_hashes(slam, steps)

        def hashed(**kw):
            append(**kw)
            digest.write(json.dumps({"frame": len(slam.metrics.records) - 1,
                                     **map_digest(slam), "stages": steps}) + "\n")
            digest.flush()
            steps.clear()
        slam.metrics.append = hashed

    t0 = time.perf_counter()
    if a.mode.startswith("piped"):
        tracked = slam.run_sequence(iter(items), pipelined=True)
    else:
        tracked = sum(slam.track_rgbd(d["image"], d["depth"], ts) is not None
                      for ts, d in items)
    slam.shutdown()
    seconds = time.perf_counter() - t0
    if a.digest:
        digest.close()
    if a.decisions:
        with open(a.decisions, "w") as f:
            json.dump(decisions, f)
    states = [r.state for r in slam.metrics.records]
    first_lost = next((i for i, s in enumerate(states) if s != "OK"), None)
    ts, est = slam.tracker.trajectory()
    fids = np.round(np.asarray(ts) * 30).astype(int)
    ate = (ate_rmse(camera_centers(est), camera_centers(gt[fids]), with_scale=False)
           if len(est) > 3 else float("nan"))
    where = (f"sweep {w}x{h} {a.frames} frames" if a.scene == "sweep" else
             f"corridor {w}x{h} {a.frames} frames radius {a.radius} laps {a.laps}")
    print(f"{a.package} {a.mode} {where}: "
          f"tracked {tracked}/{a.frames}, first frame not OK {first_lost}, keyframes "
          f"created {int(slam.map.next_kf_id)}, live {slam.map.n_keyframes}, loops "
          f"{slam.loop_closer.n_loops_closed}, metric ATE "
          f"{ate * 100:.3f} cm, {seconds:.0f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
