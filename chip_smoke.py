"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line:
1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
   exits non-zero without a CUDA device (there is no CPU path);
2. builds the CUDA kernels from csrc/ (nvcc, into build/) and the host map
   library (g++), and prints the build time;
3. checks each kernel against its plain PyTorch version on the card, at the
   shapes the tracker gives it (exact equality for the Hamming matrix), and
   times both with CUDA events: per call over back-to-back calls (launch
   cost included), and on the device over calls queued behind a spin
   kernel (launch gaps hidden);
   3b. the Schur BA solver (ops/ba.ba_solve) on seeded problems at the
   local-BA cell (C=16, P=2048, E=8192) and the global-BA cell (C=128,
   P=8192, E=65536), held to the same call on the CPU (final cost within
   1e-3 relative, inlier masks equal on >= 99.5% of edges), with ms per
   solve from CUDA events and kernels per solve from a profiler trace;
4. drives the port's synchronous path, System(cfg, device="cuda")
   .track_rgbd with the mapper inline, over the RGB-D benchmark room
   (640x480, 1000 features, bf=250, ThDepth=25): a 48-frame orbit and a
   60-frame sweep; checks the tracked ratio, the metric ATE against the
   exact ground truth and the keyframe count;
   4b. drives the bench's path, System(cfg, device="cuda",
   async_mapping=True).run_sequence(frames, pipelined=True): the 48-frame
   orbit and the 120-frame sweep, with the same gates, at least one local
   BA solve and mapper Hamming launches on the sweep; prints the mapper's
   stage times and counters and the kernel launches split between tracker
   and mapper;
   4c. one block dispatch (Tracker._blk_dispatch: uploads, the 6-frame
   device call, the start of the readback) under
   torch.cuda.set_sync_debug_mode("error"): it must not wait for the card.

The launch counts are set to 0 just before each path and read just after.
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
BA_CELLS = (("local", 16, 2048, 8192), ("global", 128, 8192, 65536))
ORBIT_FRAMES = 48
SYNC_SWEEP_FRAMES = 60
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


def queued_ms(fn, reps: int = 10) -> float | None:
    """Device time per call of fn() from CUDA events around reps calls
    queued behind a spin kernel: the host has issued every call before the
    device starts the first, so the events span the kernels run back to
    back, without the host's launch gaps that time_ms includes. None when
    the spin ended before the host had issued them all."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # about 0.1 s of spinning
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps if queued else None


def fmt_ms(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def check_hamming(CK) -> dict:
    """Kernel vs plain version on the card: exact at every shape; the time
    per call with its launch (time_ms) and on the device (queued_ms)."""
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
        row = dict(err=err,
                   ms=time_ms(lambda: CK.hamming_matrix(a, b)),
                   plain_ms=time_ms(lambda: CK.hamming_matrix_ref(a, b)),
                   dev=queued_ms(lambda: CK.hamming_matrix(a, b)),
                   plain_dev=queued_ms(lambda: CK.hamming_matrix_ref(a, b)))
        print(f"phase 3: hamming [{A},{B}] exact (max_abs_err 0): per call "
              f"(CUDA events, back-to-back) kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms; device time (CUDA events, queued) "
              f"kernel {fmt_ms(row['dev'])}, plain {fmt_ms(row['plain_dev'])}",
              flush=True)
        rows[(A, B)] = row
    return rows


def check_ba(BA) -> None:
    """ba_solve on the card against the same call on the CPU, at both BA
    cells: cost within 1e-3 relative, inlier masks on >= 99.5% of edges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for name, C, P, E in BA_CELLS:
        arrays, intr = BA.synthetic_problem(C, P, E, seed=0)
        solver = "dense" if BA._use_dense_schur(C, P, "auto") else "cg"
        res = {}
        for dev in ("cpu", "cuda"):
            prob = BA.problem_from_numpy(arrays, torch.device(dev))
            r = BA.ba_solve(prob, *intr)
            res[dev] = (float(r.cost), r.e_inlier.cpu().numpy())
        (c_cpu, i_cpu), (c_gpu, i_gpu) = res["cpu"], res["cuda"]
        rel = abs(c_gpu - c_cpu) / max(abs(c_cpu), 1e-12)
        agree = float((i_cpu == i_gpu).mean())
        if not (rel <= 1e-3 and agree >= 0.995):
            raise AssertionError(f"ba_solve {name}: card cost {c_gpu}, CPU {c_cpu} "
                                 f"(rel {rel:.2e}), inliers agree {agree:.4f}")
        prob = BA.problem_from_numpy(arrays, torch.device("cuda"))
        ms = time_ms(lambda: BA.ba_solve(prob, *intr), reps=5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            BA.ba_solve(prob, *intr)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        n_kern = sum(e.count for e in kern)
        dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
        print(f"phase 3b: ba_solve {name} C={C} P={P} E={E} ({solver}): cost "
              f"card {c_gpu:.6g} CPU {c_cpu:.6g} (rel diff {rel:.2e}), inliers "
              f"agree on {100 * agree:.3f}% ({int(i_gpu.sum())}/{E}); "
              f"{ms:.2f} ms per solve (CUDA events), {n_kern} kernels and "
              f"{dev_ms:.2f} ms device time per solve (profiler)", flush=True)


def render_frames(synth, scene, gt):
    return [(np.clip(synth.render_room(scene, gt[i], seed=i), 0, 255)
             .astype(np.uint8), synth.depth_room(scene, gt[i]))
            for i in range(len(gt))]


def run_sequence(P, CK, synth, evaluation, name: str, gt: np.ndarray, scene,
                 cfg, pipelined: bool):
    """Track a rendered sequence on the card: synchronously through
    System.track_rgbd (mapper inline), or pipelined through
    System(async_mapping=True).run_sequence. Counts the path's Hamming
    launches from 0."""
    frames = render_frames(synth, scene, gt)
    slam = P.System(cfg, device="cuda", async_mapping=pipelined)
    CK.reset_launch_counts()
    if pipelined:
        tracked = slam.run_sequence(
            ((i / 30.0, {"image": img, "depth": d}) for i, (img, d) in enumerate(frames)),
            pipelined=True)
        slam.shutdown()
    else:
        tracked = sum(slam.track_rgbd(img, d, i / 30.0) is not None
                      for i, (img, d) in enumerate(frames))
    torch.cuda.synchronize()
    launches = dict(CK.hamming_matrix.launches_by)
    ts, est = slam.tracker.trajectory()
    fids = np.round(np.asarray(ts) * 30).astype(int)
    ate = evaluation.ate_rmse(evaluation.camera_centers(est),
                              evaluation.camera_centers(gt[fids]),
                              with_scale=False)
    ms = np.array([r.track_ms for r in slam.metrics.records])[N_WARM:]
    kfs = slam.map.n_keyframes
    lm = slam.local_mapper
    tag = "phase 4b" if pipelined else "phase 4"
    print(f"{tag}: {name}: tracked {tracked}/{len(gt)}, metric ATE "
          f"{ate * 100:.3f} cm, keyframes {kfs}, points {slam.map.n_points}, "
          f"ms/frame after {N_WARM} warm frames: median {np.median(ms):.2f} "
          f"mean {ms.mean():.2f} p90 {np.percentile(ms, 90):.2f}; hamming "
          f"launches {launches}", flush=True)
    if lm.stage_ms:
        stages = {s: np.array([d[s] for d in lm.stage_ms]) for s in lm.stage_ms[0]
                  if s != "kf"}
        print(f"{tag}: {name}: mapper counters {lm.counters}; stage ms per "
              "keyframe (median / mean / max): " + ", ".join(
                  f"{s} {np.median(v):.1f}/{v.mean():.1f}/{v.max():.1f}"
                  for s, v in stages.items())
              + "; ba_solve ms: " + ", ".join(f"{x:.1f}" for x in lm.ba_solve_ms),
              flush=True)
    if tracked < 0.9 * len(gt) or not ate <= 0.03:
        raise AssertionError(f"{tag} {name}: tracked {tracked}/{len(gt)}, "
                             f"ATE {ate * 100:.3f} cm (gates: 90%, 3 cm)")
    if name == "sweep" and kfs < 3:
        raise AssertionError(f"{tag} sweep: {kfs} keyframes (gate: 3)")
    return dict(launches=launches, counters=dict(lm.counters), kfs=kfs)


def check_block_sync_free(P, synth, scene, cfg) -> None:
    """One block dispatch under sync debug mode "error": uploads, the
    device call of 6 frames and the start of the readback must not wait for
    the card. The frames before it warm the device constants and leave the
    chain on the device."""
    gt = synth.orbit_trajectory(ORBIT_FRAMES)
    frames = render_frames(synth, scene, gt[:9])
    slam = P.System(cfg, device="cuda")
    for i in range(3):
        slam.track_rgbd(*frames[i], i / 30.0)
    chunk = [(i / 30.0, frames[i][0], frames[i][1]) for i in range(3, 9)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ctx = slam.tracker._blk_dispatch(chunk)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ctx["n_real"] = len(chunk)
    poses = [pose for _, pose in slam.tracker._blk_finish(ctx)]
    n_ok = sum(p is not None for p in poses)
    if n_ok != len(chunk):
        raise AssertionError(f"sync-free block: tracked {n_ok}/{len(chunk)}")
    print(f"phase 4c: one 6-frame block dispatch ran under sync debug mode "
          f"'error' without a host sync; its frames tracked {n_ok}/{len(chunk)}",
          flush=True)


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
    from orbslam2_tpu_torch.ops import ba as BA
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
    check_ba(BA)

    # the RGB-D configuration of bench.py: room scene, bf=250, ThDepth=25
    scene = synth.make_room(seed=0)
    cfg = bench_rgbd_config(scene)
    orbit, sweep = synth.orbit_trajectory(ORBIT_FRAMES), synth.sweep_trajectory
    args = (P, CK, synth, evaluation)
    sync = [run_sequence(*args, "orbit", orbit, scene, cfg, pipelined=False),
            run_sequence(*args, "sweep", sweep(SYNC_SWEEP_FRAMES), scene, cfg,
                         pipelined=False)]
    piped = [run_sequence(*args, "orbit", orbit, scene, cfg, pipelined=True),
             run_sequence(*args, "sweep", sweep(SWEEP_FRAMES), scene, cfg,
                          pipelined=True)]
    for what, runs in (("synchronous", sync), ("pipelined", piped)):
        if sum(sum(r["launches"].values()) for r in runs) <= 0:
            raise AssertionError(f"the {what} path never launched the hamming kernel")
    if piped[1]["counters"]["ba_solves"] < 1:
        raise AssertionError("pipelined sweep: no local BA solve")
    if piped[1]["launches"].get("mapper", 0) <= 0:
        raise AssertionError("pipelined sweep: the mapper never launched the "
                             "hamming kernel")
    launches_by = {}
    for r in piped:
        for who, n in r["launches"].items():
            launches_by[who] = launches_by.get(who, 0) + n
    launches = sum(launches_by.values())
    print(f"phase 4b: hamming kernel launches on the pipelined path: {launches} "
          f"{launches_by}; synchronous path: "
          f"{sum(sum(r['launches'].values()) for r in sync)}", flush=True)
    check_block_sync_free(P, synth, scene, cfg)

    row = ham[(4096, 1024)]  # the local-map shape, the larger of the two
    # every number in this line is measured in this run; the shape it was
    # timed at goes as a string
    print(json.dumps({"kernels": [{
        "name": "hamming_matrix", "route": "cuda",
        "source": "orbslam2_tpu_torch/csrc/hamming.cu",
        "replaces": "orbslam2_tpu/ops/pallas_kernels.py:43",
        "launches": launches, "launches_by": launches_by,
        "max_abs_err": max(r["err"] for r in ham.values()),
        "ms": row["ms"], "plain_ms": row["plain_ms"], "device_ms": row["dev"],
        "plain_device_ms": row["plain_dev"], "shape": "4096x1024"}]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
