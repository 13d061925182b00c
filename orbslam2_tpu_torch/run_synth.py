"""End-to-end demo: run the full SLAM pipeline on a synthetic sequence.

Usage: python -m orbslam2_tpu_torch.run_synth [n_frames] [--device cuda|cpu] [--viewer]

Renders the textured room with exact ground truth, tracks an orbit through
it monocularly, and reports per-frame state plus the final ATE RMSE
(Sim3-aligned, the TUM-benchmark metric the reference is evaluated with).
Runs on the card (the default); without one it fails unless the CPU is
asked for. --viewer starts the live HTTP map and frame viewer and prints
its address. Counterpart of orbslam2_tpu/run_synth.py.
"""
from __future__ import annotations

import sys
import time


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    use_viewer = "--viewer" in argv
    if use_viewer:
        argv.remove("--viewer")
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    if device not in ("cuda", "cpu"):
        print(__doc__)
        return 2

    import numpy as np
    import torch
    if device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: run on the card, or pass --device cpu", file=sys.stderr)
        return 2
    from .config import SlamConfig, Sensor, with_camera
    from .io import synth
    from .system import System
    from .utils.evaluation import ate_rmse, camera_centers

    n_frames = int(argv[0]) if argv else 40

    scene = synth.make_room(seed=0)
    gt = synth.orbit_trajectory(n_frames)
    cfg = with_camera(
        SlamConfig(sensor=Sensor.MONOCULAR),
        fx=float(scene.K[0, 0]), fy=float(scene.K[1, 1]),
        cx=float(scene.K[0, 2]), cy=float(scene.K[1, 2]),
        k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
        width=scene.width, height=scene.height)

    slam = System(cfg, device=device, use_viewer=use_viewer)
    times = []
    for i in range(n_frames):
        img = synth.render_room(scene, gt[i], seed=i)
        t0 = time.perf_counter()
        pose = slam.track_monocular(img, i / 30.0)
        times.append(time.perf_counter() - t0)
        stats = slam.map_stats()
        print(f"frame {i:3d}  state={stats['state']:<15} "
              f"kfs={stats['keyframes']:3d} pts={stats['points']:5d} "
              f"inliers={stats['last_inliers']:4d} "
              f"{'pose ok' if pose is not None else 'no pose'}  "
              f"{times[-1] * 1e3:6.1f} ms", flush=True)

    slam.shutdown()  # stops the viewer, waits for a running global BA and applies it
    ts, est = slam.tracker.trajectory()
    if len(est) < 10:
        print("\nTRACKING FAILED: fewer than 10 frames tracked")
        return 1
    frame_ids = np.round(np.asarray(ts) * 30.0).astype(int)
    ate = ate_rmse(camera_centers(est), camera_centers(gt[frame_ids]))
    print(f"\ntracked {len(est)}/{n_frames} frames")
    print(f"ATE RMSE (Sim3-aligned): {ate * 100:.2f} cm")
    med = np.median(times[5:]) if len(times) > 5 else np.median(times)
    print(f"median frame time: {med * 1e3:.1f} ms ({1.0 / med:.1f} fps)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
