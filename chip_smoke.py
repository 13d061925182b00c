"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line:
1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
   exits non-zero without a CUDA device (there is no CPU path);
2. builds the CUDA kernels from csrc/ (nvcc, into build/) and the host map
   library (g++), and prints the build time;
3. checks each kernel against its plain PyTorch version on the card, at the
   shapes the tracker gives it (exact equality for the Hamming matrix), and
   times both per call with CUDA events over back-to-back calls (launch
   cost included);
4. drives the port's main path: System(cfg, device="cuda").track_rgbd over
   the RGB-D benchmark room (640x480, 1000 features, bf=250, ThDepth=25):
   a 48-frame orbit, then a 120-frame sweep that creates keyframes; checks
   the tracked ratio, the metric ATE against the exact ground truth and the
   keyframe count, and that the main path launched every kernel;
5. reads each kernel's device time (and its plain version's) from a
   torch.profiler trace, after the main path so that tracing cannot slow it.

Then it prints the kernel table as one JSON line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises: the script exits
non-zero and prints no "ok" line. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_WARM = 8  # frames excluded from the per-frame time statistics
HAMMING_SHAPES = ((1024, 1024), (4096, 1024), (1000, 777))
ORBIT_FRAMES = 48
SWEEP_FRAMES = 120


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 50) -> float:
    """Mean time per call of fn() over reps back-to-back calls, from CUDA
    events: what a caller pays, launch cost included."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> float | None:
    """Mean device time per call of fn() (sum of its kernels' time) from a
    torch.profiler trace; None when the trace holds no device time. The
    trace records device activity only, so no aten-op event repeats a
    kernel's time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / 1e3 / reps if total_us > 0 else None


def check_hamming(CK) -> dict:
    """Kernel vs plain version on the card: exact at every shape."""
    rng = np.random.default_rng(0)
    rows = {}
    for A, B in HAMMING_SHAPES:
        a = torch.from_numpy(rng.integers(0, 2 ** 32, (A, 8), dtype=np.uint32)
                             .view(np.int32)).cuda()
        b = torch.from_numpy(rng.integers(0, 2 ** 32, (B, 8), dtype=np.uint32)
                             .view(np.int32)).cuda()
        got = CK.hamming_matrix(a, b)
        torch.cuda.synchronize()
        ref = CK.hamming_matrix_ref(a, b)
        torch.cuda.synchronize()
        err = int((got - ref).abs().max().item())
        if err != 0:
            raise AssertionError(f"hamming kernel disagrees at [{A},{B}]: "
                                 f"max abs err {err}")
        ms = time_ms(lambda: CK.hamming_matrix(a, b))
        plain_ms = time_ms(lambda: CK.hamming_matrix_ref(a, b))
        print(f"phase 3: hamming [{A},{B}] exact (max_abs_err 0): per call "
              f"(CUDA events, back-to-back) kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms", flush=True)
        rows[(A, B)] = dict(inputs=(a, b), err=err, ms=ms, plain_ms=plain_ms)
    return rows


def hamming_device_times(CK, rows: dict) -> None:
    """Device time per call of the kernel and the plain version from a
    profiler trace. Runs after the main path: tracing slows the process's
    later kernel launches."""
    def fmt(x):
        return "not measured" if x is None else f"{x:.4f} ms"
    for (A, B), row in rows.items():
        a, b = row["inputs"]
        row["dev"] = device_ms(lambda: CK.hamming_matrix(a, b))
        row["plain_dev"] = device_ms(lambda: CK.hamming_matrix_ref(a, b))
        print(f"phase 5: hamming [{A},{B}] device time (profiler): kernel "
              f"{fmt(row['dev'])}, plain {fmt(row['plain_dev'])}", flush=True)


def run_sequence(P, synth, evaluation, name: str, gt: np.ndarray, scene, cfg):
    """Track a rendered sequence through System.track_rgbd on the card."""
    frames = [(np.clip(synth.render_room(scene, gt[i], seed=i), 0, 255)
               .astype(np.uint8), synth.depth_room(scene, gt[i]))
              for i in range(len(gt))]
    slam = P.System(cfg, device="cuda")
    tracked = 0
    for i, (img, depth) in enumerate(frames):
        tracked += slam.track_rgbd(img, depth, i / 30.0) is not None
    ts, est = slam.tracker.trajectory()
    fids = np.round(np.asarray(ts) * 30).astype(int)
    ate = evaluation.ate_rmse(evaluation.camera_centers(est),
                              evaluation.camera_centers(gt[fids]),
                              with_scale=False)
    ms = np.array([r.track_ms for r in slam.metrics.records])[N_WARM:]
    kfs = slam.map.n_keyframes
    print(f"phase 4: {name}: tracked {tracked}/{len(gt)}, metric ATE "
          f"{ate * 100:.3f} cm, keyframes {kfs}, points {slam.map.n_points}, "
          f"ms/frame after {N_WARM} warm frames: median {np.median(ms):.2f} "
          f"mean {ms.mean():.2f} p90 {np.percentile(ms, 90):.2f}", flush=True)
    return tracked, ate, kfs


def main() -> int:
    if not torch.cuda.is_available():
        print("phase 1: no CUDA device: this script runs only on the card",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"phase 1: card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    import orbslam2_tpu_torch as P
    from orbslam2_tpu_torch import _build, native
    from orbslam2_tpu_torch.io import synth
    from orbslam2_tpu_torch.ops import cuda_kernels as CK
    from orbslam2_tpu_torch.utils import evaluation
    from orbslam2_tpu_torch.utils.profile_frame import bench_rgbd_config

    t0 = time.perf_counter()
    CK.build_kernels()
    if not native.available():
        raise RuntimeError("host map library (native/mapops.cpp) did not build")
    print(f"phase 2: built in {time.perf_counter() - t0:.2f} s "
          f"(compile seconds by library: {_build.build_seconds})", flush=True)

    ham = check_hamming(CK)

    # the RGB-D configuration of bench.py: room scene, bf=250, ThDepth=25
    scene = synth.make_room(seed=0)
    cfg = bench_rgbd_config(scene)

    CK.hamming_matrix.launches = 0
    tracked, ate, _ = run_sequence(P, synth, evaluation, "orbit",
                                   synth.orbit_trajectory(ORBIT_FRAMES), scene, cfg)
    if tracked < 0.9 * ORBIT_FRAMES or not ate <= 0.03:
        raise AssertionError(f"orbit: tracked {tracked}/{ORBIT_FRAMES}, "
                             f"ATE {ate * 100:.3f} cm (gates: 90%, 3 cm)")
    tracked, ate, kfs = run_sequence(P, synth, evaluation, "sweep",
                                     synth.sweep_trajectory(SWEEP_FRAMES), scene, cfg)
    if tracked < 0.9 * SWEEP_FRAMES or kfs < 3 or not ate <= 0.03:
        raise AssertionError(f"sweep: tracked {tracked}/{SWEEP_FRAMES}, "
                             f"{kfs} keyframes, ATE {ate * 100:.3f} cm "
                             f"(gates: 90%, 3 keyframes, 3 cm)")
    launches = CK.hamming_matrix.launches
    if launches <= 0:
        raise AssertionError("the main path never launched the hamming kernel")
    print(f"phase 4: hamming kernel launches on the main path: {launches}",
          flush=True)

    hamming_device_times(CK, ham)
    row = ham[(4096, 1024)]  # the local-map shape, the larger of the two
    # every number in this line is measured in this run; the shape it was
    # timed at goes as a string
    print(json.dumps({"kernels": [{
        "name": "hamming_matrix", "route": "cuda",
        "source": "orbslam2_tpu_torch/csrc/hamming.cu",
        "replaces": "orbslam2_tpu/ops/pallas_kernels.py:43",
        "launches": launches, "max_abs_err": max(r["err"] for r in ham.values()),
        "ms": row["ms"], "plain_ms": row["plain_ms"], "device_ms": row["dev"],
        "plain_device_ms": row["plain_dev"], "shape": "4096x1024"}]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
