"""Where a steady-state frame's time goes, on one CUDA device.

    python -m orbslam2_tpu_torch.utils.profile_frame [--sensor rgbd|stereo] [--out DIR]

Tracks the benchmark room (the configuration of bench.py's RGB-D or stereo
row: 640x480, 1000 features, bf=250, ThDepth=25) along the 48-frame orbit
through System.track_rgbd or track_stereo (the default System: the shipped
vocabulary, keyframe database and relocalizer on) and, after 12 warm frames,
measures three windows of 5 frames each:

1. unprofiled: the host clock around the frames (each ends in its
   readback, so the device work is included);
2. under torch.profiler (CPU and CUDA activity): device busy time, kernels
   and cudaLaunchKernel calls per frame, and the busy share of the
   unprofiled frame;
3. stage times: each of extract_orb, stereo_match, motion_model_core,
   refine_offsets, pose_optimize and local_points_core wrapped in
   torch.cuda.synchronize() on both sides.

Prints the card (nvidia-smi name and power limit) and one line per window;
with --out, writes the profiler's tables sorted by device and by CPU time
there. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace
from pathlib import Path

import torch

from .. import System, SlamConfig, Sensor, with_camera
from ..frontend import matcher as FM
from ..io import synth
from ..ops import features as F
from ..ops import pose_opt as PO
from ..ops import refine as RF
from ..ops import stereo as ST
from .cuda_timing import card_line

N_WARM, N_WINDOW = 12, 5
STAGES = ((F, "extract_orb"), (ST, "stereo_match"), (FM, "motion_model_core"),
          (RF, "refine_offsets"),
          (PO, "pose_optimize"), (FM, "local_points_core"))


def bench_config(scene, sensor: Sensor) -> SlamConfig:
    """The configuration of one of bench.py's full-system rows: the room's
    pinhole camera, defaults otherwise (1000 features, 8 levels); bf=250
    and ThDepth=25 with depth (RGB-D, stereo), ThDepth=35 monocular."""
    cfg = with_camera(
        SlamConfig(sensor=sensor,
                   th_depth=35.0 if sensor == Sensor.MONOCULAR else 25.0),
        fx=float(scene.K[0, 0]), fy=float(scene.K[1, 1]),
        cx=float(scene.K[0, 2]), cy=float(scene.K[1, 2]),
        k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
        width=scene.width, height=scene.height)
    if sensor == Sensor.MONOCULAR:
        return cfg
    return replace(cfg, camera=replace(cfg.camera, bf=250.0))


def _track(slam: System, frames, i: int):
    """Frame i through the entry point of the system's sensor."""
    entry = slam.track_rgbd if slam.cfg.sensor == Sensor.RGBD else slam.track_stereo
    return entry(*frames[i], i / 30.0)


def _frames(slam: System, frames, start: int) -> float:
    """Track N_WINDOW frames from `start`; host ms per frame."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(start, start + N_WINDOW):
        _track(slam, frames, i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / N_WINDOW


def _stage_times(slam: System, frames, start: int) -> tuple[dict, float]:
    """Synced ms per frame of each stage in STAGES, and of the frame."""
    stage = {name: 0.0 for _, name in STAGES}
    originals = [(mod, name, getattr(mod, name)) for mod, name in STAGES]

    def synced(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stage[name] += (time.perf_counter() - t) * 1e3
            return out
        return call

    for mod, name, fn in originals:
        setattr(mod, name, synced(name, fn))
    try:
        frame_ms = _frames(slam, frames, start)
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    return {k: v / N_WINDOW for k, v in stage.items()}, frame_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="directory for the profiler tables")
    ap.add_argument("--sensor", choices=("rgbd", "stereo"), default="rgbd")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    from ..bench import render_frames
    scene = synth.make_room(seed=0)
    sensor = Sensor.RGBD if args.sensor == "rgbd" else Sensor.STEREO
    cfg = bench_config(scene, sensor)
    # the image and the depth map or the right image, as the bench renders them
    gt = synth.orbit_trajectory(48)[:N_WARM + 3 * N_WINDOW]
    frames = [(d["image"], d["depth" if args.sensor == "rgbd" else "right"])
              for _, d in render_frames(scene, gt, args.sensor, cfg.camera.bf / cfg.camera.fx)]
    slam = System(cfg, device="cuda", vocabulary=None)
    print(f"sensor: {args.sensor}; vocabulary: {slam.vocabulary.n_words} words",
          flush=True)
    for i in range(N_WARM):
        _track(slam, frames, i)

    plain_ms = _frames(slam, frames, N_WARM)
    print(f"unprofiled: {plain_ms:.2f} ms per frame (frames {N_WARM}-"
          f"{N_WARM + N_WINDOW - 1})", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms = _frames(slam, frames, N_WARM + N_WINDOW)
    ka = prof.key_averages()
    kern = [e for e in ka if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3 / N_WINDOW
    n_kern = sum(e.count for e in kern) / N_WINDOW
    n_launch = sum(e.count for e in ka if e.key == "cudaLaunchKernel") / N_WINDOW
    print(f"profiled: {prof_ms:.2f} ms per frame; device busy {dev_ms:.2f} ms "
          f"({100 * dev_ms / plain_ms:.1f}% of the unprofiled frame); kernels "
          f"{n_kern:.0f}; cudaLaunchKernel calls {n_launch:.0f}", flush=True)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        for key, name in (("self_device_time_total", "device"),
                          ("self_cpu_time_total", "cpu")):
            (args.out / f"frame_profile_{args.sensor}_{name}.txt").write_text(
                ka.table(sort_by=key, row_limit=40, max_name_column_width=70))

    stage, frame_ms = _stage_times(slam, frames, N_WARM + 2 * N_WINDOW)
    print("stages (synced, ms per frame): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stage.items())
          + f"; frame {frame_ms:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
