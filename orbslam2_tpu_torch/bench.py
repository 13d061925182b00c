"""The port's bench: full-System tracked frames a second on one CUDA device.

    python3 -m orbslam2_tpu_torch.bench [--rows mono,rgbd,stereo,micro]
        [--repeats 3] [--frames N]

Counterpart of the JAX package's bench.py, row by row. The headline is the
whole System (initialization, tracking, the mapper on its worker with local
BA, keyframes, place recognition and loop machinery all live) on the
synthetic textured room with exact ground truth, driven through the block
driver: System(cfg, async_mapping=True).run_sequence(frames, pipelined=True).

Rows (each a fresh System a repeat, `repeats` times, default 3):

- mono: the 180-frame room orbit (ThDepth 35); its row is the headline;
- rgbd, stereo: the 48-frame orbit, bf = 250 (the right image rendered from
  the pose moved bf/fx along the camera's x axis, seed 10000 + i);
- micro: engine_step.tracking_step on a 640x480 make_scene frame against the
  map of frame 0, the pose read back every frame (a kernel bench, not a
  System bench).

A row's per-frame times are the track_ms of every record after the first 8
(bench.py's n_warm over all records); its median is the median of the
repeats' medians, beside their min and max. Before the repeats a row pays
its set-up once: the kernels' build (a no-op once built) and one throwaway
System over the row's first 12 frames; its seconds are `setup_s`, outside
the per-frame times. Each repeat also counts the hand kernels' launches by
caller (ops/cuda_kernels).

The first line of standard output is bench.py's JSON line for the mono row,
with the same keys (metric, value, unit, vs_baseline and its seven envelope
keys) plus `device`: the card's name and power limit (nvidia-smi) and the
number of CUDA devices. `value` is 1000 / the median ms, `vs_baseline` 33.7
/ the median ms (the C++ reference's CPU median, BASELINE.md), both 0.0
unless every repeat passes the tracking gate (`gate`). The envelope's
best_run_mean_ms and best_run_p90_ms keep bench.py's names and hold the mean
and p90 of the repeat whose median is the middle one: the port reports the
spread of its repeats, never the best of them. Then one line a row on
standard error. A row that raises prints its traceback, the other rows run,
and the exit code is 1. Needs a CUDA device (exits 2 without one); the row
functions take a device so that tests can drive them on the CPU. Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import System, Sensor
from .config import OrbParams
from .engine_step import tracking_step
from .io import synth
from .ops import cuda_kernels as CK
from .ops import features as F
from .utils import evaluation as EV
from .utils.profile_frame import bench_config

N_WARM = 8          # records left out of the per-frame times (bench.py's n_warm)
WARM_FRAMES = 12    # frames of the throwaway System of a row's set-up
REPEATS = 3
ROW_FRAMES = {"mono": 180, "rgbd": 48, "stereo": 48}
SENSORS = {"mono": Sensor.MONOCULAR, "rgbd": Sensor.RGBD, "stereo": Sensor.STEREO}
KERNELS = ("hamming_matrix", "hamming_best2", "bow_assign", "seg_sum")
REF_MEDIAN_MS = 33.7  # the C++ reference binary's CPU median (BASELINE.md)
MICRO_FRAMES, MICRO_WARM = 45, 4
TRACKED_SHARE, INIT_SHARE = 0.9, 0.3  # the tracking gate


def render_frames(scene, gt: np.ndarray, sensor: str, bf_over_fx: float) -> list:
    """The sequence items (timestamp, {"image", "depth"?, "right"?}) of a
    trajectory, as bench.py renders them, on 8 threads."""
    def u8(pose, seed):
        return np.clip(synth.render_room(scene, pose, seed=seed), 0, 255).astype(np.uint8)

    def item(i):
        data = {"image": u8(gt[i], i)}
        if sensor == "rgbd":
            data["depth"] = synth.depth_room(scene, gt[i])
        elif sensor == "stereo":
            right = gt[i].copy()
            right[:, 3] = right[:, 3] - np.array([bf_over_fx, 0, 0], np.float32)
            data["right"] = u8(right, 10_000 + i)
        return i / 30.0, data

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(item, range(len(gt))))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_stats(records, n_frames: int, tracked: int) -> dict:
    """A repeat's numbers from its metric records: median, mean and p90 of
    track_ms after the first N_WARM records; the first OK frame, the frames
    from it on (trackable) and before it (spent initializing)."""
    times = np.array([r.track_ms for r in records], np.float64)[N_WARM:]
    first_ok = next((i for i, r in enumerate(records) if r.state == "OK"), n_frames)
    return dict(tracked=tracked, n=n_frames, first_ok=first_ok,
                n_trackable=n_frames - first_ok, n_init=first_ok,
                median_ms=float(np.median(times)), mean_ms=float(times.mean()),
                p90_ms=float(np.percentile(times, 90)))


def gate(row: dict) -> bool:
    """bench.py's tracking gate, on every repeat of the row: at least 90% of
    the frames from the first OK one on tracked, and initialized within the
    first 30% of the frames (a run that never initializes fails)."""
    return all(r["tracked"] >= TRACKED_SHARE * r["n_trackable"]
               and r["n_init"] <= INIT_SHARE * r["n"] for r in row["runs"])


def _ate(slam: System, gt: np.ndarray, mono: bool) -> float:
    """ATE of the tracker's trajectory against the ground truth (Sim(3)-
    aligned for monocular), NaN under 10 poses, as bench.py computes it."""
    ts, poses = slam.tracker.trajectory()
    if len(poses) < 10:
        return float("nan")
    sel = np.clip(np.round(np.asarray(ts) * 30).astype(int), 0, len(gt) - 1)
    return EV.ate_rmse(EV.camera_centers(np.asarray(poses)),
                       EV.camera_centers(gt[sel]), with_scale=mono)


def full_system_row(sensor: str, n_frames: int, device, repeats: int = REPEATS,
                    scene=None, frames=None, warm_frames: int = WARM_FRAMES,
                    keep: bool = False) -> dict:
    """One full-System row: `repeats` fresh Systems over the room orbit of
    n_frames (on `scene`, the bench room by default; `frames`: its items
    already rendered), after a set-up of the kernels' build and one
    throwaway System over the first `warm_frames` frames. keep=True drains
    the last repeat's mapper without stopping it and returns that System
    under "system". Returns the row: each repeat's numbers under "runs",
    the median of their medians and its spread, `setup_s` and `gate`."""
    device = torch.device(device)
    scene = synth.make_room(seed=0) if scene is None else scene
    cfg = bench_config(scene, SENSORS[sensor])
    gt = synth.orbit_trajectory(n_frames)
    if frames is None:
        frames = render_frames(scene, gt, sensor, cfg.camera.bf / cfg.camera.fx)
    t0 = time.perf_counter()
    if device.type == "cuda":
        CK.build_kernels()
    if warm_frames:
        warm = System(cfg, device=device, async_mapping=True)
        try:
            warm.run_sequence(iter(frames[:warm_frames]), pipelined=True)
        finally:
            warm.shutdown()
    _sync(device)
    row = dict(sensor=sensor, n=n_frames, repeats=repeats,
               setup_s=time.perf_counter() - t0, runs=[])
    for rep in range(repeats):
        slam = System(cfg, device=device, async_mapping=True)
        CK.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            tracked = slam.run_sequence(iter(frames), pipelined=True)
            _sync(device)
        except BaseException:
            slam.shutdown()  # stop the mapping worker of a failed run
            raise
        wall = time.perf_counter() - t0
        if keep and rep == repeats - 1:
            slam.wait_for_mapping()
            row["system"] = slam
        else:
            slam.shutdown()  # drain the mapping worker before reading the map
        _sync(device)
        run = run_stats(slam.metrics.records, n_frames, tracked)
        run.update(keyframes=slam.map.n_keyframes, points=slam.map.n_points,
                   wall_s=wall, ate_m=_ate(slam, gt, sensor == "mono"),
                   state=slam.tracker.state.name,
                   counters=dict(slam.local_mapper.counters),
                   launches={k: dict(getattr(CK, k).launches_by) for k in KERNELS})
        row["runs"].append(run)
    medians = [r["median_ms"] for r in row["runs"]]
    middle = int(np.argsort(medians, kind="stable")[(len(medians) - 1) // 2])
    row.update(repeat_medians_ms=medians, median_ms=float(np.median(medians)),
               min_ms=min(medians), max_ms=max(medians), median_run=middle,
               gate=gate(row))
    return row


def headline(row: dict, device_info: dict) -> dict:
    """bench.py's first line for a row, plus `device`."""
    ok = row["gate"] and row["median_ms"] > 0
    mid = row["runs"][row["median_run"]]
    return {
        "metric": "tracked_frames_per_s_per_chip",
        "value": 1000.0 / row["median_ms"] if ok else 0.0,
        "unit": "fps",
        "vs_baseline": REF_MEDIAN_MS / row["median_ms"] if ok else 0.0,
        "envelope": {
            "repeat_medians_ms": row["repeat_medians_ms"],
            "min_ms": row["min_ms"],
            "median_ms": row["median_ms"],
            "max_ms": row["max_ms"],
            "best_run_mean_ms": mid["mean_ms"],
            "best_run_p90_ms": mid["p90_ms"],
            "ref_median_ms": REF_MEDIAN_MS,
        },
        "device": device_info,
    }


def row_line(row: dict) -> str:
    """A full-System row as one line: the median and the spread of its
    repeats, then per repeat what it tracked, its ATE and launches."""
    kind = "Sim(3)-aligned" if row["sensor"] == "mono" else "metric"
    mid = row["runs"][row["median_run"]]
    runs = "; ".join(
        f"repeat {i}: median {r['median_ms']:.3f} ms, tracked {r['tracked']}/"
        f"{r['n_trackable']} after {r['n_init']} init frames, keyframes {r['keyframes']}, "
        f"{kind} ATE {100 * r['ate_m']:.3f} cm, wall {r['wall_s']:.3f} s, launches "
        f"{json.dumps(r['launches'])}" for i, r in enumerate(row["runs"]))
    return (f"# FULL SYSTEM [{row['sensor']}], {row['n']} frames, {row['repeats']} "
            f"repeats: median {row['median_ms']:.3f} ms/frame (repeat medians "
            f"{[round(m, 3) for m in row['repeat_medians_ms']]}, min {row['min_ms']:.3f}, "
            f"max {row['max_ms']:.3f}; the middle repeat's mean {mid['mean_ms']:.3f}, p90 "
            f"{mid['p90_ms']:.3f}), set-up {row['setup_s']:.3f} s, gate "
            f"{'ok' if row['gate'] else 'FAILED'}; {runs}")


def frame0_map(img0, pts, u_s, v_s, half_px, params: OrbParams, height: int, width: int):
    """bench.py's microbench map: the features of frame 0, each bound to the
    scene point whose projection lies nearest, gated to within twice the
    point's half size. Returns (points, descriptors, octaves, gate)."""
    f0 = F.extract_orb(img0, params, height, width)
    d2 = ((u_s[None, :] - f0.xy[:, 0:1]) ** 2 + (v_s[None, :] - f0.xy[:, 1:2]) ** 2)
    j = torch.argmin(d2, dim=1)
    dj = d2.gather(1, j[:, None])[:, 0]
    keep = f0.valid & (dj < (2.0 * half_px[j]) ** 2)
    return pts[j], f0.desc, f0.octave, keep


def microbench(device, n_frames: int = MICRO_FRAMES) -> dict:
    """tracking_step on make_scene(seed=0) at 640x480 against the frozen
    map of frame 0: MICRO_WARM warm frames, then frames MICRO_WARM + 1 to
    n_frames - 1 from the ground-truth pose of frame 0, each pose read back
    before the next frame (bench.py's per-frame readback). Returns ms per
    frame (host clock), the median inlier count, each timed frame's pose
    and inliers, the warm frames' (pose, inliers) under "warm", the map's
    gate, and the hand kernels' launches in the timed frames."""
    device = torch.device(device)
    params = OrbParams()
    H, W = 480, 640
    fx = fy = 500.0
    cx, cy = 320.0, 240.0
    scene = synth.make_scene(seed=0, width=W, height=H, fx=fx, fy=fy)
    gt = synth.orbit_trajectory(n_frames)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    sf, sig2 = dev(F.scale_factors(params)), dev(F.sigma2_per_octave(params))
    pc = scene.pts @ gt[0][:, :3].T + gt[0][:, 3]
    u_s = fx * pc[:, 0] / pc[:, 2] + cx
    v_s = fy * pc[:, 1] / pc[:, 2] + cy
    half_px = scene.size_world * fx / pc[:, 2]
    mp = frame0_map(dev(synth.render(scene, gt[0], seed=0)), dev(scene.pts),
                    dev(u_s), dev(v_s), dev(half_px), params, H, W)
    imgs = [dev(synth.render(scene, gt[i], seed=i)) for i in range(1, n_frames)]

    def step(img, T):
        return tracking_step(img, T, *mp, sf, sig2, params, H, W, fx, fy, cx, cy, 0.0)

    T = dev(gt[0])
    warm = []
    for img in imgs[:MICRO_WARM]:
        T, n_inl, _ = step(img, T)
        warm.append((T, n_inl))
    warm = [(T.cpu().numpy(), int(n)) for T, n in warm]
    T = dev(gt[0])
    poses, inliers = [], []
    CK.reset_launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    for img in imgs[MICRO_WARM:]:
        T, n_inl, _ = step(img, T)
        poses.append(T.cpu().numpy())
        inliers.append(n_inl)
    per_frame = (time.perf_counter() - t0) / max(1, len(poses)) * 1e3
    inliers = [int(x) for x in inliers]
    return dict(ms_per_frame=per_frame, median_inliers=int(np.median(inliers)),
                frames=len(poses), poses=poses, inliers=inliers, warm=warm,
                map_gate=mp[3].cpu().numpy(),
                launches={k: dict(getattr(CK, k).launches_by) for k in KERNELS})


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="mono,rgbd,stereo,micro",
                    help="comma-separated rows of mono, rgbd, stereo, micro")
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--frames", type=int, default=None,
                    help="frames of every full-System row (default: mono 180, "
                         "RGB-D and stereo 48; the microbench 45)")
    args = ap.parse_args(argv)
    if args.frames is not None and args.frames <= max(N_WARM, MICRO_WARM + 1):
        ap.error(f"--frames: more than {max(N_WARM, MICRO_WARM + 1)} frames")
    if args.repeats < 1:
        ap.error("--repeats: at least 1")
    args.rows = args.rows.split(",")
    unknown = set(args.rows) - set(ROW_FRAMES) - {"micro"}
    if unknown:
        ap.error(f"unknown rows {sorted(unknown)}")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device: the bench runs only on the card", file=sys.stderr)
        return 2
    from .utils.cuda_timing import card
    device_info = card()
    failed = []
    for name in sorted(args.rows, key=[*ROW_FRAMES, "micro"].index):
        try:
            if name == "micro":
                m = microbench("cuda", args.frames or MICRO_FRAMES)
                print(f"# microbench (map-frozen tracking_step, the pose read back every "
                      f"frame): {m['ms_per_frame']:.3f} ms/frame over {m['frames']} "
                      f"frames, median inliers {m['median_inliers']}, launches "
                      f"{json.dumps(m['launches'])}", file=sys.stderr, flush=True)
                continue
            row = full_system_row(name, args.frames or ROW_FRAMES[name], "cuda",
                                  repeats=args.repeats)
            if name == "mono":
                # flushed at once: the headline survives a later row's failure
                print(json.dumps(headline(row, device_info)), flush=True)
            print(row_line(row), file=sys.stderr, flush=True)
        except Exception:
            traceback.print_exc()
            print(f"# {name} row failed", file=sys.stderr, flush=True)
            failed.append(name)
    print(f"# device {json.dumps(device_info)}; rows failed: {failed or 'none'}",
          file=sys.stderr, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
