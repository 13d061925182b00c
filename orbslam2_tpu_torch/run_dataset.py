"""Dataset runner CLI — the reference's Examples/ drivers as one command.

    python -m orbslam2_tpu_torch.run_dataset mono_tum   <settings.yaml> <seq_dir>
    python -m orbslam2_tpu_torch.run_dataset rgbd_tum   <settings.yaml> <seq_dir> [assoc.txt]
    python -m orbslam2_tpu_torch.run_dataset stereo_kitti <settings.yaml> <seq_dir>
    python -m orbslam2_tpu_torch.run_dataset mono_kitti <settings.yaml> <seq_dir>
    python -m orbslam2_tpu_torch.run_dataset mono_euroc <settings.yaml> <mav0_dir>
    python -m orbslam2_tpu_torch.run_dataset stereo_euroc <settings.yaml> <mav0_dir>

Options: --out-dir DIR (trajectory outputs), --max-frames N, --device
cuda|cpu (default cuda: without a card the command fails unless the CPU is
asked for), --viewer (the live HTTP map and frame viewer, the reference's
Pangolin window; it prints its address). Counterpart of
orbslam2_tpu/run_dataset.py.
Tracks through System.run_sequence (the block driver), prints the
median/mean tracking time at the end (the reference drivers'
instrumentation, Examples/Monocular/mono_tum.cc:112-120) and saves
CameraTrajectory.txt, KeyFrameTrajectory.txt and, for KITTI,
CameraTrajectoryKITTI.txt (System::Save*).
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

MODES = {
    "mono_tum": ("MONOCULAR", "tum_mono"),
    "rgbd_tum": ("RGBD", "tum_rgbd"),
    "stereo_kitti": ("STEREO", "kitti_stereo"),
    "mono_kitti": ("MONOCULAR", "kitti_mono"),
    "mono_euroc": ("MONOCULAR", "euroc_mono"),
    "stereo_euroc": ("STEREO", "euroc_stereo"),
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    out_dir = Path(".")
    max_frames = None
    use_viewer = "--viewer" in argv
    if use_viewer:
        argv.remove("--viewer")
    if "--device" in argv:
        i = argv.index("--device"); device = argv[i + 1]; del argv[i:i + 2]
    if "--out-dir" in argv:
        i = argv.index("--out-dir"); out_dir = Path(argv[i + 1]); del argv[i:i + 2]
    if "--max-frames" in argv:
        i = argv.index("--max-frames"); max_frames = int(argv[i + 1]); del argv[i:i + 2]
    if len(argv) < 3 or argv[0] not in MODES or device not in ("cuda", "cpu"):
        print(__doc__)
        return 2
    mode, settings, seq = argv[0], argv[1], argv[2]
    assoc = argv[3] if len(argv) > 3 else None

    import numpy as np
    import torch
    if device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: run on the card, or pass --device cpu", file=sys.stderr)
        return 2
    from .config import Sensor, load_settings, with_camera
    from .io import datasets as D
    from .system import System

    sensor_name, loader = MODES[mode]
    cfg = load_settings(settings, Sensor[sensor_name])

    # EuRoC stereo: the raw cam0/cam1 images are unrectified — build the
    # rectification remaps from the YAML's LEFT.*/RIGHT.* blocks and take
    # the intrinsics from the rectified projection matrices, as the
    # reference driver does (Examples/Stereo/stereo_EuRoC.cpp:35-90).
    rectify = None
    if loader == "euroc_stereo":
        from .io.rectify import load_rectification
        rect = load_rectification(settings)
        if rect is not None:
            rect_l, rect_r, fx, fy, cx, cy, bf = rect
            rectify = (rect_l, rect_r)
            cfg = with_camera(cfg, fx=fx, fy=fy, cx=cx, cy=cy, bf=bf,
                              k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
        else:
            print("warning: no LEFT./RIGHT. rectification blocks in "
                  f"{settings}; feeding raw images", file=sys.stderr)

    slam = System(cfg, device=device, use_viewer=use_viewer)
    it = {"tum_mono": lambda: D.iter_tum_mono(seq),
          # raw sensor units: the tracker applies cfg.depth_map_factor once
          "tum_rgbd": lambda: D.iter_tum_rgbd(seq, assoc, depth_factor=1.0),
          "kitti_stereo": lambda: D.iter_kitti_stereo(seq),
          "kitti_mono": lambda: D.iter_kitti_mono(seq),
          "euroc_mono": lambda: D.iter_euroc(seq, stereo=False),
          "euroc_stereo": lambda: D.iter_euroc(seq, stereo=True)}[loader]()

    def bounded(it):
        for n, item in enumerate(it):
            if max_frames and n >= max_frames:
                return
            if rectify is not None:
                item[1]["image"] = rectify[0](item[1]["image"])
                item[1]["right"] = rectify[1](item[1]["right"])
            yield item

    t_start = time.perf_counter()
    tracked = slam.run_sequence(bounded(it), progress_every=50)
    slam.shutdown()
    total = time.perf_counter() - t_start
    n = len(slam.metrics.records)
    times = (np.array([r.track_ms for r in slam.metrics.records]) / 1e3
             if n else np.array([total]))

    out_dir.mkdir(parents=True, exist_ok=True)
    slam.save_trajectory_tum(out_dir / "CameraTrajectory.txt")
    slam.save_keyframe_trajectory_tum(out_dir / "KeyFrameTrajectory.txt")
    if "kitti" in mode:
        slam.save_trajectory_kitti(out_dir / "CameraTrajectoryKITTI.txt")
    print(f"\n{n} frames ({tracked} tracked); "
          f"median tracking time {np.median(times) * 1e3:.1f} ms; "
          f"mean {times.mean() * 1e3:.1f} ms; wall {total:.1f} s")
    print(f"map: {slam.map_stats()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
