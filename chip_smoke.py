"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line:
1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
   exits non-zero without a CUDA device (there is no CPU path);
2. builds the CUDA kernels from csrc/ (one nvcc per source, started
   together, into build/), the probe library (the empty kernel and the
   tensor-core rate loop) and the host map library (g++), and prints the
   build time;
3. checks each kernel against its plain PyTorch version on the card, exactly:
   `hamming_matrix` at [4096,1024], [1024,1024] and [1000,777];
   `hamming_best2` (index, best and second) at the same shapes under three
   kinds of mask (1% true, all true, and rows with no candidate, one
   candidate and tied best columns), and at the shapes and masks the stereo
   and the monocular path give it: [1024,1024] under a stereo row-band mask
   and [2048,2048] under the +-100 px window mask of monocular
   initialization. Times both with CUDA events: per call
   over back-to-back calls (launch cost included), and on the device over
   calls queued behind a spin kernel (launch gaps hidden), warm (the same
   buffers every call, in L2) and cold (more distinct buffers than L2
   holds); beside them an empty kernel of the same grid, the bound (bytes
   over 3.35 TB/s against this run's tensor-core instructions over the
   rate measured in this run), and for `hamming_matrix` the yardstick
   `library_ms`: one torch.matmul of the descriptors unpacked to +-1 fp16
   (unpacked outside the timed region; the package never calls it);
   3b. the Schur BA solver (ops/ba.ba_solve) on seeded problems at the
   local-BA cell (C=16, P=2048, E=8192) and the global-BA cell (C=128,
   P=8192, E=65536), held to the same call on the CPU (final cost within
   1e-3 relative, inlier masks equal on >= 99.5% of edges), with ms per
   solve from CUDA events and kernels per solve from a profiler trace;
4. drives the port's synchronous path, System(cfg, device="cuda")
   .track_rgbd with the mapper inline, over the RGB-D benchmark room
   (640x480, 1000 features, bf=250, ThDepth=25): the first 24 frames of the
   48-frame orbit and a 60-frame sweep; checks the tracked ratio, the
   metric ATE against the exact ground truth and the keyframe count;
   4b. drives the bench's path, System(cfg, device="cuda",
   async_mapping=True).run_sequence(frames, pipelined=True): the 48-frame
   orbit and the 120-frame sweep, with the same gates, at least one local
   BA solve and mapper launches of `hamming_best2` on the sweep; prints the
   mapper's stage times and counters and both kernels' launches split
   between tracker and mapper;
   4c. one block dispatch (Tracker._blk_dispatch: uploads, the 6-frame
   device call, the start of the readback) under
   torch.cuda.set_sync_debug_mode("error"): it must not wait for the card;
   once for RGB-D and once for stereo;
5. stereo, the bench's stereo row (48-frame orbit, the right image rendered
   0.5 m to the right with seed 10000 + i): pipelined with async mapping
   (at least 90% tracked, metric ATE <= 3 cm, 1 `hamming_matrix` and 2
   `hamming_best2` a tracked frame), and its first 24 frames synchronously
   through System.track_stereo;
6. monocular, the bench's headline row (180-frame orbit, ThDepth=35):
   pipelined with async mapping (initialized within the first 30% of the
   frames, at least 90% of the later frames tracked, Sim(3)-aligned ATE <= 8
   cm, at least 3 keyframes, one local BA solve and one triangulated point,
   `hamming_best2` launched by the initialization), and its first 40 frames
   synchronously through System.track_monocular (initialized, OK at the
   end). Prints the init frames, ms per init attempt and per tracked frame.

The launch counts are set to 0 just before each path and read just after;
both kernels must have been launched on the synchronous and on the pipelined
path of every sensor. Then it prints the kernel table as one JSON line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises: the script exits
non-zero and prints no "ok" line. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N_WARM = 8  # frames excluded from the per-frame time statistics
HAMMING_SHAPES = ((4096, 1024), (1024, 1024), (1000, 777))
BA_CELLS = (("local", 16, 2048, 8192), ("global", 128, 8192, 65536))
ORBIT_FRAMES = 48
SYNC_ORBIT_FRAMES = 24       # synchronous RGB-D and stereo: the orbit's start
SYNC_SWEEP_FRAMES = 60
SWEEP_FRAMES = 120
MONO_FRAMES = 180
SYNC_MONO_FRAMES = 40
# gates: (least tracked share, ATE limit in m); monocular ATE is
# Sim(3)-aligned and its share counts the frames after the first OK one.
# The monocular limit is four times the 2 cm of the 30-frame end-to-end
# test: every keyframe's local BA leaves the scale free, which keyframes the
# asynchronous mapper gets depends on timing, and over ten such runs on one
# H100 the ATE ranged from 0.79 to 3.84 cm (with the mapper inline, where
# nearly every frame becomes a keyframe, the JAX package reads 3.94 cm on
# this sequence on a CPU, this package 3.36 cm there and 7.12 cm on the
# card). A trajectory that collapsed would read 25 cm or more.
GATES = {"rgbd": (0.9, 0.03), "stereo": (0.9, 0.03), "mono": (0.9, 0.08)}
KERNELS = ("hamming_matrix", "hamming_best2")
T = None      # orbslam2_tpu_torch.utils.cuda_timing, imported in main()


def _bound(n_bytes: int, n_mma: int, mma_per_s: float) -> dict:
    """The least time the card could take: the bytes over the data-sheet
    memory rate against the tensor-core instructions over the measured rate."""
    by_bytes = 1e3 * n_bytes / T.HBM_BYTES_PER_S
    by_ops = 1e3 * n_mma / mma_per_s
    return dict(bound_ms=max(by_bytes, by_ops), bound_bytes_ms=by_bytes,
                bound_ops_ms=by_ops,
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def _times(row: dict, tag: str) -> str:
    return (f"{tag}: per call (CUDA events, back-to-back) kernel {row['ms']:.4f} "
            f"ms, plain {row['plain_ms']:.4f} ms; device time (CUDA events, "
            f"queued) warm {T.fmt_ms(row['dev'])}, cold {T.fmt_ms(row['cold'])}, "
            f"plain {T.fmt_ms(row['plain_dev'])}, empty kernel of the grid "
            f"{T.fmt_ms(row['floor'])}; bound {row['bound_ms']:.4f} ms by "
            f"{row['bound_by']} (bytes {row['bound_bytes_ms']:.4f}, tensor-core "
            f"issue {row['bound_ops_ms']:.4f})")


def check_hamming_matrix(CK, PH, lib, mma_per_s: float) -> dict:
    """`hamming_matrix` against its plain version on the card: exact at
    every shape, then its times, floor, bound and the matmul yardstick."""
    rng = np.random.default_rng(0)
    rows = {}
    for A, B in HAMMING_SHAPES:
        a = torch.from_numpy(PH.descriptors(rng, A)).cuda()
        b = torch.from_numpy(PH.descriptors(rng, B)).cuda()
        got = CK.hamming_matrix(a, b)
        torch.cuda.synchronize()
        ref = CK.hamming_matrix_ref(a, b)
        err = int((got - ref).abs().max().item())
        if err != 0:
            raise AssertionError(f"hamming_matrix disagrees at [{A},{B}]: "
                                 f"max abs err {err}")
        # the yardstick: +-1 fp16 bits, dot = 256 - 2 hamming (exact in fp16
        # products, f32 accumulation); only the matmul is timed
        shifts = torch.arange(32, device="cuda", dtype=torch.int32)
        pm1 = [(1 - 2 * ((d[:, :, None] >> shifts) & 1)).reshape(d.shape[0], 256)
               .to(torch.float16) for d in (a, b)]
        pm1[1] = pm1[1].T.contiguous()
        lib_err = int(((256 - (pm1[0] @ pm1[1]).to(torch.int32)) // 2 - ref)
                      .abs().max().item())
        if lib_err != 0:
            raise AssertionError(f"matmul yardstick disagrees at [{A},{B}]")
        keep = []
        n_sets = T.cold_count(4 * A * B)
        row = dict(err=err, shape=f"{A}x{B}",
                   ms=T.time_ms(lambda: CK.hamming_matrix(a, b)),
                   plain_ms=T.time_ms(lambda: CK.hamming_matrix_ref(a, b), reps=5),
                   dev=T.queued_ms(lambda: CK.hamming_matrix(a, b), reps=10),
                   cold=T.queued_ms(lambda: keep.append(CK.hamming_matrix(a, b)),
                                    reps=n_sets),
                   plain_dev=T.queued_ms(lambda: CK.hamming_matrix_ref(a, b), reps=3),
                   floor=PH.empty_kernel_ms(lib, -(-A // 64), -(-B // 64), 128),
                   library_ms=T.time_ms(lambda: pm1[0] @ pm1[1]),
                   library_dev=T.queued_ms(lambda: pm1[0] @ pm1[1], reps=10),
                   **_bound(4 * A * B + 32 * (A + B),
                            2 * -(-A // 16) * -(-B // 8), mma_per_s))
        del keep
        print(_times(row, f"phase 3: hamming_matrix [{A},{B}] exact (max_abs_err 0)")
              + f"; torch.matmul of +-1 fp16 bits per call {row['library_ms']:.4f} "
              f"ms, device {T.fmt_ms(row['library_dev'])}", flush=True)
        rows[(A, B)] = row
    return rows


def best2_row(CK, PH, lib, mma_per_s: float, kind: str, a_np, b_np, cand_np,
              cold: bool, reps: int) -> dict:
    """One case of `hamming_best2` against its plain version on the card:
    index, best and second exact, then its times, floor and bound. The
    bound counts the mma of the 16x64 chunks whose mask is not empty: the
    others are skipped."""
    A, B = cand_np.shape
    a, b, cand = (torch.from_numpy(x).cuda() for x in (a_np, b_np, cand_np))
    got = CK.hamming_best2(a, b, cand)
    torch.cuda.synchronize()
    ref = CK.hamming_best2_ref(a, b, cand)
    err = max(int((x - y).abs().max().item()) for x, y in zip(got, ref))
    if err != 0:
        raise AssertionError(f"hamming_best2 disagrees at [{A},{B}], {kind} "
                             f"mask: max abs err {err} over idx, best, second")
    padded = torch.nn.functional.pad(cand, (0, -B % 64, 0, -A % 16))
    chunks = int(padded.view(-(-A // 16), 16, -(-B // 64), 64)
                 .any(dim=3).any(dim=1).sum().item())
    n_sets = T.cold_count(A * B)
    masks = [cand.clone() for _ in range(n_sets)] if cold else None
    row = dict(err=err, shape=f"{A}x{B}", density=float(cand_np.mean()),
               ms=T.time_ms(lambda: CK.hamming_best2(a, b, cand)),
               plain_ms=T.time_ms(lambda: CK.hamming_best2_ref(a, b, cand),
                                  reps=max(2, reps // 2)),
               dev=T.queued_ms(lambda: CK.hamming_best2(a, b, cand), reps=reps),
               cold=None if masks is None else T.queued_cold_ms(
                   lambda i: CK.hamming_best2(a, b, masks[i]), n_sets),
               plain_dev=T.queued_ms(lambda: CK.hamming_best2_ref(a, b, cand), reps=3),
               floor=PH.empty_kernel_ms(lib, -(-A // 16), 1, 512),
               unfused_dev=T.queued_ms(lambda: CK.masked_best2(
                   CK.hamming_matrix(a, b), cand), reps=reps),
               **_bound(A * B + 32 * (A + B) + 12 * A, 16 * chunks, mma_per_s))
    print(_times(row, f"phase 3: hamming_best2 [{A},{B}] {kind} mask "
                      f"({100 * row['density']:.2f}% true) exact on idx, best, "
                      "second (max_abs_err 0)")
          + f"; hamming_matrix + plain reduction, device warm "
          f"{T.fmt_ms(row['unfused_dev'])}", flush=True)
    return row


def check_hamming_best2(CK, PH, lib, mma_per_s: float) -> dict:
    """`hamming_best2` at every shape and mask kind (cold on the sparse
    mask), and at the stereo and the monocular-initialization case."""
    rows = {}
    for A, B in HAMMING_SHAPES:
        for kind, a_np, b_np, cand_np in PH.best2_cases(A, B, seed=0):
            rows[(A, B, kind)] = best2_row(CK, PH, lib, mma_per_s, kind, a_np, b_np,
                                           cand_np, cold=kind == "sparse", reps=10)
    for kind, a_np, b_np, cand_np in PH.best2_path_cases(seed=0):
        rows[(*cand_np.shape, kind)] = best2_row(CK, PH, lib, mma_per_s, kind, a_np,
                                                 b_np, cand_np, cold=True, reps=10)
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
        ms = T.time_ms(lambda: BA.ba_solve(prob, *intr), reps=5)
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


_RENDERED: dict = {}


def render_sequence(synth, scene, name: str, gt: np.ndarray, sensor: str):
    """The sequence items (timestamp, {"image", "depth"?, "right"?}) of one
    trajectory for one sensor, as bench.py renders them (the right image from
    the pose shifted 0.5 m along the camera's x axis, seed 10000 + i).
    Rendered once per (trajectory, sensor) with 8 threads; a shorter run of
    the same trajectory takes its first frames."""
    key = (name, len(gt), sensor)
    if key in _RENDERED:
        return _RENDERED[key]

    def u8(pose, seed):
        return np.clip(synth.render_room(scene, pose, seed=seed), 0, 255).astype(np.uint8)

    def item(i):
        data = {"image": u8(gt[i], i)}
        if sensor == "rgbd":
            data["depth"] = synth.depth_room(scene, gt[i])
        elif sensor == "stereo":
            right = gt[i].copy()
            right[:, 3] = right[:, 3] - np.array([0.5, 0, 0], np.float32)
            data["right"] = u8(right, 10_000 + i)
        return i / 30.0, data

    with ThreadPoolExecutor(8) as pool:
        _RENDERED[key] = list(pool.map(item, range(len(gt))))
    return _RENDERED[key]


def run_sequence(P, CK, evaluation, tag: str, name: str, items, gt: np.ndarray,
                 cfg, sensor: str, pipelined: bool, whole: bool = True):
    """Track a rendered sequence on the card: synchronously through the
    sensor's entry point (System.track_rgbd / track_stereo / track_monocular,
    mapper inline), or pipelined through System(async_mapping=True)
    .run_sequence. Counts the path's launches of both Hamming kernels from 0
    and applies the sensor's gates; a run that is not the `whole` sequence
    (the start of the monocular orbit) must initialize and end OK, and is
    not held to the 30% and the ATE gate."""
    n = len(items)
    slam = P.System(cfg, device="cuda", async_mapping=pipelined)
    entry = {"rgbd": lambda ts, d: slam.track_rgbd(d["image"], d["depth"], ts),
             "stereo": lambda ts, d: slam.track_stereo(d["image"], d["right"], ts),
             "mono": lambda ts, d: slam.track_monocular(d["image"], ts)}[sensor]
    CK.reset_launch_counts()
    t0 = time.perf_counter()
    if pipelined:
        tracked = slam.run_sequence(iter(items), pipelined=True)
        slam.shutdown()
    else:
        tracked = sum(entry(ts, d) is not None for ts, d in items)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {w.__name__: dict(w.launches_by)
                for w in (CK.hamming_matrix, CK.hamming_best2)}
    recs = slam.metrics.records
    first_ok = next((i for i, r in enumerate(recs) if r.state == "OK"), n)
    ts, est = slam.tracker.trajectory()
    fids = np.round(np.asarray(ts) * 30).astype(int)
    ate = (evaluation.ate_rmse(evaluation.camera_centers(est),
                               evaluation.camera_centers(gt[fids]),
                               with_scale=sensor == "mono")
           if len(est) >= 3 else float("nan"))
    # the frames after initialization, less the warm ones
    ms = np.array([r.track_ms for r in recs])[first_ok + 1:][N_WARM:]
    kfs = slam.map.n_keyframes
    lm = slam.local_mapper
    kind = "Sim(3)-aligned" if sensor == "mono" else "metric"
    print(f"{tag}: {name}: tracked {tracked}/{n} ({n - first_ok} from the first "
          f"OK frame on), {kind} ATE {ate * 100:.3f} cm, keyframes {kfs}, points "
          f"{slam.map.n_points}, ms/frame after {N_WARM} warm tracked frames: "
          f"median {np.median(ms):.2f} mean {ms.mean():.2f} p90 "
          f"{np.percentile(ms, 90):.2f}; {seconds:.1f} s in all; kernel launches "
          f"{launches}", flush=True)
    if sensor == "mono":
        init_ms = np.array([r.track_ms for r in recs])[:first_ok + 1]
        print(f"{tag}: {name}: {first_ok} init frames of {n}; ms per init attempt "
              f"(all {len(init_ms)}): median {np.median(init_ms):.2f} mean "
              f"{init_ms.mean():.2f} max {init_ms.max():.2f}", flush=True)
    if lm.stage_ms:
        stages = {s: np.array([d[s] for d in lm.stage_ms]) for s in lm.stage_ms[0]
                  if s != "kf"}
        print(f"{tag}: {name}: mapper counters {lm.counters}; stage ms per "
              "keyframe (median / mean / max): " + ", ".join(
                  f"{s} {np.median(v):.1f}/{v.mean():.1f}/{v.max():.1f}"
                  for s, v in stages.items())
              + "; ba_solve ms: " + ", ".join(f"{x:.1f}" for x in lm.ba_solve_ms),
              flush=True)
    share, ate_limit = GATES[sensor]
    if first_ok > (0.3 * n if whole else n - 2):
        raise AssertionError(f"{tag} {name}: first OK frame {first_ok} of {n} "
                             "(gate: within the first 30%)")
    if tracked < share * (n - first_ok) or not (ate <= ate_limit or not whole):
        raise AssertionError(
            f"{tag} {name}: tracked {tracked}/{n - first_ok}, ATE {ate * 100:.3f} cm "
            f"(gates: {100 * share:.0f}%, {100 * ate_limit:.0f} cm)")
    if slam.tracker.state.name != "OK":
        raise AssertionError(f"{tag} {name}: state {slam.tracker.state.name} at the end")
    for kernel in KERNELS:
        if launches[kernel].get("tracker", 0) <= 0:
            raise AssertionError(f"{tag} {name}: the tracker never launched {kernel}")
    return dict(launches=launches, counters=dict(lm.counters), kfs=kfs,
                tracked=tracked, first_ok=first_ok)


def check_block_sync_free(P, items, cfg, sensor: str) -> None:
    """One block dispatch under sync debug mode "error": uploads, the
    device call of 6 frames and the start of the readback must not wait for
    the card. The frames before it warm the device constants and leave the
    chain on the device."""
    slam = P.System(cfg, device="cuda")
    gray = slam._gray
    for ts, d in items[:3]:
        slam.tracker.process_image(
            gray(d["image"]), ts, depth_map=d.get("depth"),
            right_img=gray(d["right"]) if "right" in d else None)
    chunk = [(ts, gray(d["image"]), d.get("depth"),
              gray(d["right"]) if "right" in d else None) for ts, d in items[3:9]]
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
        raise AssertionError(f"sync-free {sensor} block: tracked {n_ok}/{len(chunk)}")
    print(f"phase 4c: one 6-frame {sensor} block dispatch ran under sync debug "
          f"mode 'error' without a host sync; its frames tracked {n_ok}/{len(chunk)}",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("phase 1: no CUDA device: this script runs only on the card",
              file=sys.stderr)
        return 2
    import orbslam2_tpu_torch as P
    from orbslam2_tpu_torch import _build, native
    from orbslam2_tpu_torch.io import synth
    from orbslam2_tpu_torch.ops import ba as BA
    from orbslam2_tpu_torch.ops import cuda_kernels as CK
    from orbslam2_tpu_torch.utils import cuda_timing, evaluation
    from orbslam2_tpu_torch.utils import probe_hamming as PH
    from orbslam2_tpu_torch.utils.profile_frame import bench_config

    global T
    T = cuda_timing
    card = T.card_line()
    print(f"phase 1: card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # every nvcc and the g++ at once
        probe = pool.submit(PH.probe_lib)
        host = pool.submit(native.available)
        CK.build_kernels()
        lib = probe.result()
        if not host.result():
            raise RuntimeError("host map library (native/mapops.cpp) did not build")
    print(f"phase 2: built in {time.perf_counter() - t0:.2f} s "
          f"(compile seconds by library: {_build.build_seconds})", flush=True)

    mma_per_s = PH.mma_per_second(lib)
    if mma_per_s is None:
        raise AssertionError("the tensor-core rate loop was not measured")
    print(f"phase 3: mma.sync m16n8k256 .b1 .and.popc: {mma_per_s:.4g} a second "
          f"over {torch.cuda.get_device_properties(0).multi_processor_count} SMs",
          flush=True)
    ham = check_hamming_matrix(CK, PH, lib, mma_per_s)
    best2 = check_hamming_best2(CK, PH, lib, mma_per_s)
    check_ba(BA)

    # the configurations of bench.py's three rows on the room scene
    scene = synth.make_room(seed=0)
    cfgs = {"rgbd": bench_config(scene, P.Sensor.RGBD),
            "stereo": bench_config(scene, P.Sensor.STEREO),
            "mono": bench_config(scene, P.Sensor.MONOCULAR)}
    orbit = synth.orbit_trajectory(ORBIT_FRAMES)
    mono_orbit = synth.orbit_trajectory(MONO_FRAMES)

    def run(tag, name, gt, sensor, pipelined, n=None):
        items = render_sequence(synth, scene, name, gt, sensor)[:n]
        return run_sequence(P, CK, evaluation, tag, f"{sensor}-{name}-{len(items)}",
                            items, gt, cfgs[sensor], sensor, pipelined,
                            whole=sensor != "mono" or n is None)

    sweep = synth.sweep_trajectory
    sync = [run("phase 4", "orbit", orbit, "rgbd", False, SYNC_ORBIT_FRAMES),
            run("phase 4", "sweep", sweep(SYNC_SWEEP_FRAMES), "rgbd", False)]
    piped = [run("phase 4b", "orbit", orbit, "rgbd", True),
             run("phase 4b", "sweep", sweep(SWEEP_FRAMES), "rgbd", True)]
    for runs in (sync, piped):
        if runs[1]["kfs"] < 3:
            raise AssertionError(f"RGB-D sweep: {runs[1]['kfs']} keyframes (gate: 3)")
    if piped[1]["counters"]["ba_solves"] < 1:
        raise AssertionError("pipelined sweep: no local BA solve")
    if piped[1]["launches"]["hamming_best2"].get("mapper", 0) <= 0:
        raise AssertionError("pipelined sweep: the mapper never launched hamming_best2")
    check_block_sync_free(P, render_sequence(synth, scene, "orbit", orbit, "rgbd"),
                          cfgs["rgbd"], "rgbd")
    check_block_sync_free(P, render_sequence(synth, scene, "orbit", orbit, "stereo"),
                          cfgs["stereo"], "stereo")

    # phase 5, stereo: every tracked frame runs stereo_match (hamming_best2
    # under the row-band mask) beside the two matchers of the RGB-D frame
    stereo = [run("phase 5", "orbit", orbit, "stereo", True),
              run("phase 5", "orbit", orbit, "stereo", False, SYNC_ORBIT_FRAMES)]
    for r in stereo:
        a = r["launches"]["hamming_matrix"]["tracker"]
        b = r["launches"]["hamming_best2"]["tracker"]
        if a < r["tracked"] - 1 or b < 2 * a:
            raise AssertionError(f"stereo: {a} hamming_matrix and {b} hamming_best2 "
                                 f"launches by the tracker over {r['tracked']} tracked "
                                 "frames (gate: 1 and 2 a tracked frame)")
    # phase 6, monocular: initialization launches hamming_best2 under the
    # +-100 px window mask, counted apart from the tracker
    mono = [run("phase 6", "orbit", mono_orbit, "mono", True),
            run("phase 6", "orbit", mono_orbit, "mono", False, SYNC_MONO_FRAMES)]
    for r in mono:
        if r["launches"]["hamming_best2"].get("mono_init", 0) <= 0:
            raise AssertionError("mono: the initialization never launched hamming_best2")
    c = mono[0]["counters"]
    if mono[0]["kfs"] < 3 or c["ba_solves"] < 1 or c["points_created"] <= 0:
        raise AssertionError(f"pipelined mono: {mono[0]['kfs']} keyframes, counters {c} "
                             "(gates: 3 keyframes, 1 BA solve, 1 triangulated point)")

    def total(runs, kernel: str) -> dict:
        by = {}
        for r in runs:
            for who, n in r["launches"][kernel].items():
                by[who] = by.get(who, 0) + n
        return by

    # the main path is the bench's entry point, pipelined with async
    # mapping, once per sensor row (and the RGB-D sweep, which maps)
    main_path = piped + [stereo[0], mono[0]]
    others = sync + [stereo[1], mono[1]]
    launches_by = {kernel: total(main_path, kernel) for kernel in KERNELS}
    print(f"phase 6: kernel launches on the pipelined paths of all sensors: "
          f"{launches_by}; synchronous paths: "
          f"{({k: total(others, k) for k in KERNELS})}", flush=True)

    # every number in these lines is measured in this run, at the shape the
    # main path gives the kernel (named as a string): motion_model_core's
    # [1024,1024] for hamming_matrix, local_points_core's [4096,1024] for
    # hamming_best2 (on the 1% mask); its stereo and init cases follow under
    # "other_shapes"
    def entry(name: str, source: str, row: dict, rows: dict, library_ms) -> dict:
        return {"name": name, "route": "cuda", "source": source,
                "replaces": "orbslam2_tpu/ops/pallas_kernels.py:43",
                "launches": sum(launches_by[name].values()),
                "launches_by": launches_by[name],
                "max_abs_err": max(r["err"] for r in rows.values()),
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "device_ms": row["dev"], "cold_device_ms": row["cold"],
                "plain_device_ms": row["plain_dev"], "floor_ms": row["floor"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": library_ms, "shape": row["shape"]}

    row_a, row_b = ham[(1024, 1024)], best2[(4096, 1024, "sparse")]
    entry_b = entry("hamming_best2", "orbslam2_tpu_torch/csrc/hamming_best2.cu", row_b,
                    best2, None)  # no single PyTorch call computes it
    entry_b["other_shapes"] = [
        {"mask": kind, "shape": r["shape"], "density": r["density"], "ms": r["ms"],
         "device_ms": r["dev"], "cold_device_ms": r["cold"], "floor_ms": r["floor"],
         "plain_device_ms": r["plain_dev"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"]}
        for (_, _, kind), r in best2.items() if kind in ("stereo-band", "init-window")]
    print(json.dumps({"kernels": [
        entry("hamming_matrix", "orbslam2_tpu_torch/csrc/hamming.cu", row_a, ham,
              row_a["library_ms"]), entry_b]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
