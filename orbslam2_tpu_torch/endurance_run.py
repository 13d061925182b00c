"""Full-System endurance run over a multi-lap synthetic corridor circuit.

Counterpart of the JAX package's scripts/endurance_run.py: the production
combination (the block driver, the mapper on its worker with culling, loop
closing and the background global BA) over 1000+ frames of the corridor
circuit, where every revisit is a loop-closure chance. Frames are rendered
lazily, a few ahead on a small thread pool, so memory stays flat.

    python3 -m orbslam2_tpu_torch.endurance_run [--frames 1200] [--laps 2.5]
        [--sensor mono|rgbd|stereo] [--noise 2.5] [--radius 8.0]
        [--helix 0.0] [--scene corridor|rings] [--min-loops N]
        [--device cuda|cpu]

The default device is the card; without one the command fails unless the
CPU is asked for. The last line of standard output is one JSON object with
the keys of the JAX script (fps, ATE, map statistics, and per closure the
frame it fired at, the keyframe pair, the ATE just before and after the
correction, the essential-graph census the PGO consumed and the points
SearchAndFuse merged) plus `launches`, the hand kernels' launches by caller,
and `max_keyframes`, the configured keyframe capacity. `device` is the
card's name and power limit as nvidia-smi prints them, or "cpu".
`--min-loops N` exits non-zero unless at least N closures fired.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

RENDER_THREADS = 3   # frames rendered beside the tracker, mapper and GBA threads
RENDER_AHEAD = 12    # frames rendered before the tracker asks for them
FPS = 30.0


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=1200)
    ap.add_argument("--laps", type=float, default=2.5)
    ap.add_argument("--sensor", default="mono", choices=["mono", "rgbd", "stereo"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--noise", type=float, default=2.5)
    ap.add_argument("--radius", type=float, default=8.0)
    ap.add_argument("--helix", type=float, default=0.0,
                    help="camera descent per lap (m): each lap maps fresh "
                         "viewpoints and accumulates drift again")
    ap.add_argument("--scene", default="corridor", choices=["corridor", "rings"],
                    help="rings: two nested corridor rings joined by doorways "
                         "(make_corridor_rings), two topological loops; "
                         "--laps, --radius and --helix are ignored")
    ap.add_argument("--min-loops", type=int, default=0,
                    help="exit non-zero unless at least N closures fired")
    return ap.parse_args(argv)


def rendered_frames(synth, scene, gt, sensor, noise: float, baseline: float):
    """(timestamp, {"image", "depth"?, "right"?}) for every pose of `gt`,
    rendered as the JAX script renders them (the right camera shifted by the
    baseline along its x axis, seed 10000 + i), RENDER_AHEAD frames ahead."""
    from .config import Sensor

    def render(i):
        data = {"image": np.clip(synth.render_room(scene, gt[i], noise=noise, seed=i),
                                 0, 255).astype(np.uint8)}
        if sensor == Sensor.RGBD:
            data["depth"] = synth.depth_room(scene, gt[i])
        elif sensor == Sensor.STEREO:
            right = gt[i].copy()
            right[:, 3] = right[:, 3] - np.array([baseline, 0, 0], np.float32)
            data["right"] = np.clip(synth.render_room(scene, right, noise=noise,
                                                      seed=10_000 + i),
                                    0, 255).astype(np.uint8)
        return i / FPS, data

    with ThreadPoolExecutor(RENDER_THREADS) as pool:
        ahead = collections.deque()
        for i in range(len(gt)):
            ahead.append(pool.submit(render, i))
            if len(ahead) > RENDER_AHEAD:
                yield ahead.popleft().result()
        while ahead:
            yield ahead.popleft().result()


def run(args) -> dict:
    """One endurance run; returns the record that main() prints."""
    import torch

    from .config import Sensor
    from .io import synth
    from .ops import cuda_kernels as CK
    from .system import System
    from .utils.evaluation import ate_rmse, camera_centers
    from .utils.profile_frame import bench_config

    N = args.frames
    if args.scene == "rings":
        scene = synth.make_corridor_rings(seed=3)
        gt = synth.rings_trajectory(N)
    else:
        scene = synth.make_corridor(seed=3)
        gt = synth.corridor_trajectory(N, radius=args.radius, laps=args.laps,
                                       helix=args.helix)
    sensor = {"mono": Sensor.MONOCULAR, "rgbd": Sensor.RGBD,
              "stereo": Sensor.STEREO}[args.sensor]
    mono = sensor == Sensor.MONOCULAR
    # the JAX script's configuration: the scene's pinhole camera, ThDepth 35
    # (mono) or 25 and bf = 250 (with depth), defaults otherwise
    cfg = bench_config(scene, sensor)
    baseline = cfg.camera.bf / cfg.camera.fx

    slam = System(cfg, device=args.device, async_mapping=True)

    def measure_ate():
        ts, est = slam.tracker.trajectory()
        if len(est) < 10:
            return None
        fids = np.clip(np.round(np.asarray(ts) * FPS).astype(int), 0, N - 1)
        return float(ate_rmse(camera_centers(est), camera_centers(gt[fids]),
                              with_scale=mono))

    closures = record_closures(slam, measure_ate)
    CK.reset_launch_counts()
    t0 = time.perf_counter()
    tracked = slam.run_sequence(
        rendered_frames(synth, scene, gt, sensor, args.noise, baseline),
        pipelined=True, progress_every=200)
    slam.shutdown()
    if args.device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    recs = slam.metrics.records
    times = np.array([r.track_ms for r in recs])
    first_ok = next((i for i, r in enumerate(recs) if r.state == "OK"), len(recs))
    med = float(np.median(times[max(first_ok, 8):]))
    ate = measure_ate()
    if args.device == "cuda":
        from .utils.cuda_timing import card_line
        device = card_line()
    else:
        device = "cpu"
    return {
        "sensor": args.sensor, "frames": N, "laps": args.laps,
        "tracked": tracked, "first_ok": first_ok,
        "median_ms": round(med, 1),
        "fps": round(1000.0 / med, 2) if med > 0 else 0.0,
        "wall_s": round(wall, 1),
        "ate_m": round(ate, 4) if ate is not None else float("nan"),
        "keyframes": slam.map.n_keyframes,
        "points": slam.map.n_points,
        "kf_created_total": int(slam.map.next_kf_id),
        "kf_culled": int(slam.map.next_kf_id) - slam.map.n_keyframes,
        "loops": slam.loop_closer.n_loops_closed,
        "gba_applied": slam.global_ba.n_applied,
        "loop_fused": slam.loop_closer.n_loop_fused,
        "closures": closures,
        "device": device,
        "launches": {w.__name__: dict(w.launches_by) for w in CK._WRAPPERS},
        "max_keyframes": cfg.max_keyframes,
    }


def record_closures(slam, measure_ate) -> list:
    """Wrap the loop closer's `_correct_loop` so that each closure appends
    its record (the JAX script's: the frame it fired at, the keyframe pair,
    the scale, the ATE just before and just after the correction, the
    essential-graph census and the fused points) to the returned list."""
    closures = []
    lc = slam.loop_closer
    orig_correct = lc._correct_loop

    def wrapped_correct(kf, kc, s12, R12, t12):
        pre = measure_ate()
        r = orig_correct(kf, kc, s12, R12, t12)
        post = measure_ate()
        closures.append({
            "at_frame": len(slam.tracker.frame_log),
            "kf": int(kf), "kc": int(kc), "scale": round(float(s12), 4),
            "ate_pre_m": round(pre, 4) if pre is not None else None,
            "ate_post_m": round(post, 4) if post is not None else None,
            "pgo_edges": dict(lc.last_pgo_edges),
            "fused": int(lc.n_loop_fused),
        })
        return r

    lc._correct_loop = wrapped_correct
    return closures


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: run on the card, or pass --device cpu", file=sys.stderr)
        return 2
    out = run(args)
    print(json.dumps(out), flush=True)
    if args.min_loops and len(out["closures"]) < args.min_loops:
        print(f"FAILED: {len(out['closures'])} closures < --min-loops {args.min_loops}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
