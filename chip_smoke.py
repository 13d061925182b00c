"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line:
1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
   exits non-zero without a CUDA device (there is no CPU path);
2. builds the CUDA kernels from csrc/ (one nvcc per source, started
   together, into build/), the probe libraries (the empty kernel and the
   tensor-core rate loop; the first `bow_assign` kernel) and the host map
   library (g++), and prints the build time; then runs every exactness
   and guard-row check of phases 3 and 3c, untimed, once in a subprocess
   under CUDA_LAUNCH_BLOCKING=1 (`--kernel-checks`), so that a launch that
   faults is named by its caller; a non-zero exit there fails the script;
3. checks each kernel against its plain PyTorch version on the card,
   exactly, each output written between guard rows of a sentinel that must
   be intact after a synchronize:
   `hamming_matrix` at [4096,1024], [1024,1024] and [1000,777];
   `hamming_best2` (index, best and second) at the same shapes under three
   kinds of mask (1% true, all true, and rows with no candidate, one
   candidate and tied best columns), and at the shapes and masks the stereo
   and the monocular path give it: [1024,1024] under a stereo row-band mask
   and [2048,2048] under the +-100 px window mask of monocular
   initialization, and [1024,1024] and [2048,1024] under the same-node
   mask of `match_by_bow` on the default vocabulary; and (checked only) all
   true at the vocabulary trainer's shapes [4096,1], [4096,10], [4096,11]
   and [100000,10]. Times `hamming_matrix` at its shapes and
   `hamming_best2` on the 1% mask and the path masks (the other masks give
   the same times, PERF.md) with CUDA events: per call
   over back-to-back calls (launch cost included), and on the device over
   calls queued behind a spin kernel (launch gaps hidden), warm (the same
   buffers every call, in L2) and cold (more distinct buffers than L2
   holds); beside them an empty kernel of the same grid, the bound (bytes
   over 3.35 TB/s against this run's tensor-core instructions over the
   rate measured in this run), and for `hamming_matrix` the yardstick
   `library_ms`: one torch.matmul of the descriptors unpacked to +-1 fp16
   (unpacked outside the timed region; the package never calls it);
   3c. `bow_assign` (the vocabulary descent over the children-block table,
   csrc/bow_assign.cu) against both plain versions (the block walk and the
   JAX layout) on the full default vocabulary (168,840 nodes), exactly
   (words, ok, gate), inside guard rows: M = 1024 descriptors of an
   extracted room frame and M = 2048 of a frame extracted at the monocular
   initialization's budget; checked only, seeded random sets of both
   sizes, a tenth of the rows invalid, the ragged M = 1 and 1023 and M =
   100,000 over a tree trained on the host with leaves above its last level
   and nodes of fewer than k children; the frames'
   times warm and cold in turns with the first kernel
   (csrc/bow_assign_twotrip_probe.cu) and its variants, the empty
   kernel of its grid, its byte bound (the distinct bytes this run's
   descents stand on) and the plain version's time;
   3d. `ops/pnp.pnp_ransac` on a seeded problem (128 points, 40 of them
   outliers, padded to the frame's 1024 rows): at least 70 inliers, at most
   2 outliers among them, the pose within 2 cm and 0.5 degrees of the truth,
   the inlier count within 3 of the same call on the CPU with the same
   minimal sets; ms per call, kernels per call and waits for the card;
   3b. the Schur BA solver (ops/ba.ba_solve) on seeded problems at the
   local-BA cell (C=16, P=2048, E=8192) and the global-BA cell (C=128,
   P=8192, E=65536), held to the same call on the CPU (final cost within
   1e-3 relative, inlier masks equal on >= 99.5% of edges), with ms per
   solve from CUDA events and kernels per solve from a profiler trace;
   3e. the vocabulary trainer (in this process after phase 10, while the
   laps of phase 8 run on): the first 5 scenes of the JAX script's
   descriptor set (one of each image mode, 1000 features) extracted on the
   card by train_vocab.gather_descriptors, a k=10, 3-level tree trained
   on the card (io/vocabulary.train_vocabulary(device="cuda")), equal to
   the host trainer's on the same descriptors on every array;
   `hamming_best2` and `bow_assign` launched under the caller "vocab";
   `hamming_best2` timed at the root split's shape [N,10], all true; then
   the host-bookkeeping probe (utils/bench_host_ops.py) at K = 50 and 150
   keyframes, its table printed, no gate;
4. drives the port's synchronous path, System(cfg, device="cuda")
   .track_rgbd with the mapper inline, over the RGB-D benchmark room
   (640x480, 1000 features, bf=250, ThDepth=25): the first 12 frames of the
   48-frame orbit and the first 60 frames of the 120-frame sweep (kept as
   session A of phase 9b); checks the tracked ratio, the metric ATE against
   the exact ground truth and the keyframe count;
   4b. drives the bench's path, System(cfg, device="cuda",
   async_mapping=True).run_sequence(frames, pipelined=True), over the
   120-frame sweep, with the same gates, at least one local BA solve and
   mapper launches of `hamming_best2`; prints the mapper's stage times and
   counters and the kernels' launches split between tracker and mapper
   (the pipelined orbits of RGB-D and stereo run from disk in phase 9c);
   4c. one block dispatch (Tracker._blk_dispatch: uploads, the 6-frame
   device call, the start of the readback) under
   torch.cuda.set_sync_debug_mode("error"): it must not wait for the card;
   once for RGB-D and once for stereo;
5. stereo, the bench's stereo row (48-frame orbit, the right image rendered
   0.5 m to the right with seed 10000 + i): its first 12 frames
   synchronously through System.track_stereo (1 `hamming_matrix` and 2
   `hamming_best2` a tracked frame);
6. monocular, the bench's headline row (180-frame orbit, ThDepth=35):
   pipelined with async mapping (initialized within the first 30% of the
   frames, at least 90% of the later frames tracked, Sim(3)-aligned ATE <= 8
   cm, at least 3 keyframes, one local BA solve and one triangulated point,
   `hamming_best2` launched by the initialization), and its first 40 frames
   synchronously through System.track_monocular (initialized, OK at the
   end). Prints the init frames, ms per init attempt and per tracked frame;
7. relocalization and localization mode, on the Systems that phases 4b and
   6 left (their mappers drained, not stopped). RGB-D, after the pipelined
   sweep: every keyframe made is registered in the keyframe database and
   has its gate nodes; 3 blank frames leave the tracker LOST; an early
   viewpoint of the sweep, rendered with new seeds, relocalizes within 4
   frames, within 5 cm and 1 degree of the ground truth; the next 12 frames
   of the sweep all track; then activate_localization_mode() and 24 more
   frames: all tracked, no keyframe and no point added, the temporal points
   of the motion model used. Monocular, after the pipelined orbit: the
   same blackout, the viewpoint of the best-covered keyframe relocalizes
   within 4 frames with the viewing direction within cos > 0.99 of the
   truth. Prints every relocalization attempt (candidates, BoW matches, PnP
   inliers, inliers after LM, bindings after rescue, ms);
8. loop closing and the background global BA on a lap of the corridor
   circuit (synth.make_corridor(seed=3), 640x480, the 240-frame
   corridor_trajectory of radius 8, images with noise 2.5), the cells of
   tests/test_loop_closure_e2e.py, each lap in a process of its own
   (`--loop-lap SENSOR`): the monocular lap, the longest phase, starts
   after phase 3 and runs beside phases 4 to 10, the RGB-D lap starts after
   phase 7b and runs beside phases 9 and 10. Both laps go one frame
   at a time through the sensor's entry point
   (run_sequence(pipelined=False)): the block driver loses track on this
   lap in both packages (tests/torch_corridor_lap.py; PERF.md). RGB-D
   with the mapper on its worker (the loop closer on the worker's stream,
   the global BA on its own thread and CUDA stream; shutdown() applies it):
   at least 235 of 240 frames tracked, a loop closed, a global BA applied,
   metric ATE under 3 cm; monocular with the mapper inline: at least 230
   tracked, a loop closed, a global BA applied, points fused, at least one
   post-fuse loop connection in the essential graph, a pre-loop
   Sim(3)-aligned ATE over 2.5 cm (the drift that makes the lap a
   loop-closure workload) and a final one under 6 cm and under the
   pre-loop one. Prints each closure (keyframe pair, BoW matches, RANSAC
   inliers, inliers after the Sim(3) refinement, support matches, fused
   points, essential-graph edges and loop connections, ms per part of
   LoopCloser.process), ms per global-BA chunk and solve, the ATE before
   and after the first correction and at the end, the kernels'
   launches by caller, and the first frame that was not OK after the
   initialization with the gate that dropped it (LapRecorder; a failed
   lap names them); `hamming_best2` must have
   been launched by the loop closer (caller "loop") on both laps;
9. map checkpoints, map merging and the dataset drivers, after phase 7b,
   beside both laps:
   9a. checkpoint (rgbd-sweep-120): save_map of the System phase 7 left
   (ms and MB) into a temporary directory; a fresh System(cfg, device="cuda",
   async_mapping=True, use_viewer=True, viewer_port=0).load_map (ms): the
   keyframe and point counts kept, the tracker LOST, every keyframe
   registered (`bow_assign` launched under "checkpoint"); the viewpoint of
   sweep frame 10 with new seeds relocalizes within 4 frames, within 5 cm
   and 1 degree of the truth, and the next 12 frames all track; then the
   live viewer of that System: every route fetched (PNG signatures, the
   page, a 404), /stats.json equal to map_stats() plus the menu,
   localization mode and the toggles flipped through /set, /reset last and
   applied by the next frame (a new map, its first keyframe), shutdown()
   leaves no viewer; prints the viewer's render ms;
   9b. merge (rgbd-sweep-120 halves): session A is phase 4's synchronous
   sweep (frames 0-59), session B a new System over frames 40-99 (its world
   its own first camera); after map_merge.merge_maps an alignment at scale
   1, n_a + n_b keyframes from both halves, `hamming_best2` launched under
   "merge", the merged keyframes' metric ATE under 1.5 times the JAX
   package's reading of the cell (tests/torch_merge_cell.py); prints the
   keyframe pair, the RANSAC inliers and the ms of alignment and merge;
   9c. dataset drivers: rgbd-orbit-48 written as a TUM RGB-D directory
   (colour PNGs with equal channels, u16 depth at factor 5000, rgb.txt,
   depth.txt, associations, a settings YAML) and stereo-orbit-48 as a KITTI
   directory (image_0, image_1, times.txt), PNGs by io/png.write_png;
   each through run_dataset.main with its default device (the block driver,
   the mapper inline): at least 90% tracked and a metric ATE of at most 3
   cm from CameraTrajectory.txt (io/trajectory.load_tum), the keyframe and
   KITTI trajectory files well formed, 1 `hamming_matrix` and 1 (RGB-D) or
   2 (stereo) `hamming_best2` a tracked frame.
10. the port's entry points and the distributed solvers (torch.distributed),
   in this process after 9c, while the laps of phase 8 run on:
   10a. graft_entry.entry() (tracking_step on a 480x640 frame against a
   1024-point map, the JAX entry's seeded draws) on the card against the
   same entry on the CPU: pose within 1e-4, inliers within 2,
   `hamming_best2` launched under the caller "entry"; ms per call;
   10b. `python3 -m orbslam2_tpu_torch.graft_entry --dryrun 1`, a 1-rank
   NCCL group on cuda:0 (a process started after 10a, beside 10c's and
   10e), with the gates of graft_entry.dryrun_multichip:
   the collectives of a short sharded BA and PGO solve, by count; the
   512-vertex pose graph within 1e-3 of the single-process solve; the
   512/65536/1048576 crossover BA timed at 1 rank and sharded; the
   128/8192/65536 BA at the single-process optimum (cost within 5%, more
   than 90% inliers, inlier counts within 2%);
   10c. the same with `--dryrun 2 --backend gloo --device cuda`, two ranks
   sharing cuda:0 (gloo stages each collective through the host, and 10b
   and 10e share the card with them: the times are correctness runs, not a
   scaling figure); after 10e, the global BA's
   distributed branch at 2 gloo ranks on cuda:0 (`--gba-rank R STORE MAP`)
   on the map that 9a saved, against the single-process GlobalBA on the
   same map: dispatched over 2 ranks, rank 1 joined all 5 chunks, applied
   poses and final cost within max(1e-4, twice the spread of the
   single-process results: the default GBA's and those pinned to CG on the
   map as saved and with its points nudged one float32 ulp up and down);
   10d. 9b's merged map: its global BA problem through dist_ba_solve over a
   1-rank NCCL group against ba_solve(solver="cg") (2 + 3 LM iterations,
   12 CG steps): poses within 1e-3, inliers above 70% of the valid edges,
   after the write-back the merged keyframes' metric ATE under 9b's gate.
   The phase lines print the collectives and the ms of each solve.
   10e. the endurance run's plumbing, in this process while the dry runs of
   10b and 10c run: endurance_run.main(["--sensor",
   "rgbd", "--frames", "96", "--laps", "0.2"]) (the block driver, the
   mapper on its worker, the loop closer and the global BA over the first
   96 frames of the 480-frame corridor lap at 640x480): its JSON line has
   the JAX script's keys plus `launches` and `max_keyframes`, its launches
   are the ones counted in this process, its device is this card; at least
   90 frames tracked, both Hamming kernels launched by the tracker,
   `hamming_best2` by the mapper, one `bow_assign` a keyframe made.

The launch counts are set to 0 just before each path and read just after;
both Hamming kernels must have been launched on the synchronous and on the
pipelined path of every sensor, `bow_assign` by the mapper of every pipelined
path that makes keyframes, by the relocalizer in phase 7 and by the load in
9a, each time with the vocabulary's packed table (no call may pack it on the
fly), `hamming_best2` by the entry of 10a, all three by the endurance
run of 10e, and `hamming_best2` and `bow_assign` by the trainer of 3e. Then
it prints the seconds
of each phase (the laps of phase 8 run beside phases 4 to 10 and print
their own), the kernel table as one JSON
line, and as the last line {"ok": true, "device": {...}}. Any failed check
raises: the script exits non-zero and prints no "ok" line. Imports nothing
of JAX.

    python3 chip_smoke.py --lap-start SENSOR RUNS FRAMES [--deterministic]

is a probe that a default run never enters: the first FRAMES frames of
phase 8's lap of SENSOR (rendered once) through RUNS fresh Systems built as
phase 8 builds them, one line a run (the initialization frame, the map
scale and final cost of the initialization's BA and of the first two local
BAs, the first frame not OK and the gate that dropped it), with
--deterministic under torch.use_deterministic_algorithms(True,
warn_only=True), printing the warnings it collects.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N_WARM = 8  # frames excluded from the per-frame time statistics
HAMMING_SHAPES = ((4096, 1024), (1024, 1024), (1000, 777))
BA_CELLS = (("local", 16, 2048, 8192), ("global", 128, 8192, 65536))
# phase 3b and 3f: the pose graph of the endurance runs' closures (2,821
# edges) over their most keyframes
PGO_CELL = (421, 2821)
# the global BA's chunk: (iters1, iters2) of each of its ba_solve calls
GBA_CHUNK = (1, 2)
FP32_OPS_PER_S, FP64_OPS_PER_S = 67e12, 34e12  # H100 SXM, outside the tensor cores
ORBIT_FRAMES = 48
SYNC_ORBIT_FRAMES = 12       # synchronous RGB-D and stereo: the orbit's start
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
KERNELS = ("hamming_matrix", "hamming_best2", "bow_assign", "seg_sum")
N_BLANK = 3            # blank frames of the blackout
RELOC_TRIES = 4        # frames a relocalization may take
RELOC_ON_FRAMES = 12   # frames tracked on after it
LOCALIZATION_FRAMES = 24
RGBD_REVISIT = 10      # the sweep frame whose viewpoint is revisited
RELOC_GATE_CM, RELOC_GATE_DEG = 5.0, 1.0  # RGB-D: the relocalized pose
RESCUE_WIDTH, RESCUE_POINTS = 1024, 80   # phase 7b: rows and features a frame
# phase 8: the corridor lap of tests/test_loop_closure_e2e.py and its gates
LOOP_FRAMES, LOOP_RADIUS, LOOP_NOISE = 240, 8.0, 2.5
# both laps and phase 9, from the start of the processes of the RGB-D lap and
# of phase 9
LOOP_TIMEOUT_S = 900
# the mapper of each lap: RGB-D on its worker (the loop closer on the worker's
# stream, the global BA on a third thread), monocular inline, where the test's
# drift premise and improvement gate were set
LOOP_ASYNC = {"rgbd": True, "mono": False}
# phase 8b: (sensor, runs, frames) of the lap's start, rerun in fresh Systems
# in the process of that sensor's lap, after the lap; the runs must agree
LAP_REPEAT = ("mono", 4, 40)
LOOP_GATES = {"rgbd": dict(tracked=235, ate=0.03),
              "mono": dict(tracked=230, ate=0.06, pre_loop=0.025)}
# phase 9
CHECKPOINT_REVISIT_SEEDS = 4000  # new renders of the revisited viewpoint
# 9b: the halves of the 120-frame sweep; session A is phase 4's synchronous
# sweep (frames 0-59), session B a new System over frames 40-99
MERGE_B = (40, 100)
# the merged keyframes' metric ATE: 1.5 times the JAX package's 5.124 cm on
# the same cell on a CPU at 640x480 (tests/torch_merge_cell.py), where the
# sessions alone read 1.1 and 0.7 cm: the alignment comes from one keyframe
# pair
MERGE_ATE_GATE = 1.5 * 0.05124
VIEWER_WAIT_S = 30  # for the viewer's first renders
# 10e: the endurance run's cut and the keys of the JAX package's
# scripts/endurance_run.py line; the port adds `launches` and `max_keyframes`
ENDURANCE_SMOKE = ["--sensor", "rgbd", "--frames", "96", "--laps", "0.2"]
ENDURANCE_KEYS = ("sensor", "frames", "laps", "tracked", "first_ok", "median_ms", "fps",
                  "wall_s", "ate_m", "keyframes", "points", "kf_created_total",
                  "kf_culled", "loops", "gba_applied", "loop_fused", "closures", "device")
ENDURANCE_MIN_TRACKED = 90
# 10c: the single-process CG GBAs, on the map as saved (None) and with every
# point one float32 ulp towards +inf and -inf; with the default GBA, their
# spread is the float32 resolution of the map's solve
GBA_CG_NUDGES = (None, np.inf, -np.inf)
# phase 3: the widths and heights the vocabulary trainer gives hamming_best2
# (a k-means++ seeding step [N, 1], an assignment [N, k] at k = 10 and the
# default vocabulary's 11, the root of a large training set), all true
VOCAB_BEST2_SHAPES = ((4096, 1), (4096, 10), (4096, 11), (100000, 10))
VOCAB_BOW_ROWS = 100000   # bow_assign over a freshly trained tree
# phase 3e: the trainer on the card, one scene of each image mode
VOCAB_SCENES, VOCAB_FEATURES, VOCAB_K, VOCAB_LEVELS = 5, 1000, 10, 3
VOCAB_FIELDS = ("node_desc", "node_children", "node_word", "word_node", "word_weight")
HOST_OPS_KEYFRAMES = (50, 150)
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


def check_hamming_matrix(CK, PH, lib, mma_per_s: float, timed: bool = True) -> dict:
    """`hamming_matrix` against its plain version on the card: exact at
    every shape, written between guard rows that must stay intact; then,
    if `timed`, its times, floor, bound and the matmul yardstick."""
    rng = np.random.default_rng(0)
    rows = {}
    for A, B in HAMMING_SHAPES:
        a = torch.from_numpy(PH.descriptors(rng, A)).cuda()
        b = torch.from_numpy(PH.descriptors(rng, B)).cuda()
        buf = PH.guarded(A, torch.int32, (B,))
        got = CK.hamming_matrix(a, b, out=buf[1])
        PH.check_guards(f"hamming_matrix [{A},{B}]", [buf])
        ref = CK.hamming_matrix_ref(a, b)
        err = int((got - ref).abs().max().item())
        if err != 0:
            raise AssertionError(f"hamming_matrix disagrees at [{A},{B}]: "
                                 f"max abs err {err}")
        if not timed:
            print(f"phase 3: hamming_matrix [{A},{B}] exact, guard rows intact",
                  flush=True)
            continue
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
              cold: bool, reps: int, timed: bool = True) -> dict:
    """One case of `hamming_best2` against its plain version on the card:
    index, best and second exact, each written between guard rows that
    must stay intact; then, if `timed`, its times, floor and bound. The
    bound counts the mma of the 16x64 chunks whose mask is not empty: the
    others are skipped."""
    A, B = cand_np.shape
    a, b, cand = (torch.from_numpy(x).cuda() for x in (a_np, b_np, cand_np))
    bufs = [PH.guarded(A, torch.int32) for _ in range(3)]
    got = CK.hamming_best2(a, b, cand, out=[view for _, view in bufs])
    PH.check_guards(f"hamming_best2 [{A},{B}] {kind}", bufs)
    ref = CK.hamming_best2_ref(a, b, cand)
    err = max(int((x - y).abs().max().item()) for x, y in zip(got, ref))
    if err != 0:
        raise AssertionError(f"hamming_best2 disagrees at [{A},{B}], {kind} "
                             f"mask: max abs err {err} over idx, best, second")
    if not timed:
        print(f"phase 3: hamming_best2 [{A},{B}] {kind} mask exact, guard rows "
              "intact", flush=True)
        return dict(err=err)
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


def check_hamming_best2(CK, PH, lib, mma_per_s: float, voc, timed: bool = True) -> dict:
    """`hamming_best2` at every shape and mask kind (timed, warm and cold,
    on the sparse mask), at the stereo and the monocular-initialization
    case, under the same-node mask of `match_by_bow` on vocabulary `voc`,
    and all true at the vocabulary trainer's shapes (checked only)."""
    rows = {}
    for A, B in HAMMING_SHAPES:
        # the full and edge masks are checked, not timed: their warm times
        # equal the sparse mask's (PERF.md)
        for kind, a_np, b_np, cand_np in PH.best2_cases(A, B, seed=0):
            rows[(A, B, kind)] = best2_row(CK, PH, lib, mma_per_s, kind, a_np, b_np,
                                           cand_np, cold=kind == "sparse", reps=10,
                                           timed=timed and kind == "sparse")
    for kind, a_np, b_np, cand_np in PH.best2_path_cases(seed=0, voc=voc):
        rows[(*cand_np.shape, kind)] = best2_row(CK, PH, lib, mma_per_s, kind, a_np,
                                                 b_np, cand_np, cold=True, reps=10,
                                                 timed=timed)
    rng = np.random.default_rng(1)
    for A, B in VOCAB_BEST2_SHAPES:  # checked only; 3e times the trainer's root
        rows[(A, B, "all-true")] = best2_row(
            CK, PH, lib, mma_per_s, "all-true", PH.descriptors(rng, A),
            PH.descriptors(rng, B), np.ones((A, B), bool), cold=False, reps=10,
            timed=False)
    return rows


def early_leaf_tree():
    """A tree trained on the host (k=10, 4 levels, 2,000 seeded random
    descriptors) with leaves above the last level and nodes of fewer than
    k children, as a fresh training gives them."""
    from orbslam2_tpu_torch.io.vocabulary import train_vocabulary
    rng = np.random.default_rng(2)
    voc = train_vocabulary(rng.integers(0, 2 ** 32, (2000, 8), dtype=np.uint32),
                           k=10, levels=4, seed=0)
    depth = np.zeros(len(voc.node_desc), int)
    for i, ch in enumerate(voc.node_children):
        depth[ch[ch >= 0]] = depth[i] + 1
    n_children = (voc.node_children >= 0).sum(axis=1)
    if not ((depth[voc.word_node] < voc.levels).any()
            and ((n_children > 0) & (n_children < voc.k)).any()):
        raise AssertionError("the trained tree has no early leaf or short child list")
    return voc


def check_bow_assign(PH, lib, twotrip, voc, frames: dict, timed: bool = True) -> dict:
    """`bow_assign` against both plain versions on the full vocabulary,
    inside guard rows: the extracted frames' descriptors (with every tenth
    valid row declared invalid), then, checked only, the seeded random
    sets, the ragged M = 1 and 1023, and M = 100,000 over a freshly trained
    tree; the frames timed (if `timed`) in turns with the first kernel and
    the variants."""
    rows = {}
    cases = [(f"room-frame-{len(d)}", d, v & (np.arange(len(d)) % 10 != 0), timed)
             for d, v in frames.values()]
    # the seeded random sets are checked, not timed: their times equal the
    # room frames' of the same M (PERF.md)
    cases += [(*c, False) for c in PH.bow_cases(voc, seed=0)]
    cases += [(*c, False) for c in PH.bow_cases(voc, seed=1, sizes=(1, 1023))]
    cases = [(voc, *c) for c in cases]
    tree = early_leaf_tree()
    cases += [(tree, f"trained-tree-{kind}", d, v, False)
              for kind, d, v in PH.bow_cases(tree, seed=2, sizes=(VOCAB_BOW_ROWS,))]
    for tree_of, kind, desc, valid, timed_case in cases:
        if timed_case:
            print("phase 3c: ", end="")
        rows[kind] = PH.bow_row(lib, twotrip, tree_of, kind, np.ascontiguousarray(desc),
                                valid, timed=timed_case)
        if not timed_case:
            print(f"phase 3c: bow_assign M={len(desc)} ({kind}, {len(tree_of.node_desc)} "
                  "nodes) exact against both plain versions, the first kernel and the "
                  "variants; guard rows intact", flush=True)
    return rows


def check_vocab(CK, PH, lib, mma_per_s: float) -> dict:
    """Phase 3e: the vocabulary trainer on the card. Gathers the JAX
    script's first scenes (one of each image mode) with extract_orb on the
    card, trains with io/vocabulary.train_vocabulary(device="cuda") (every
    split distance on `hamming_best2`, the idf pass on `bow_assign`, both
    launched under "vocab") and holds the tree to the host trainer's on the
    same descriptors, exactly. Then times `hamming_best2` at the root split's
    shape, [N, k] all true, warm and cold against its floor and bound.
    Returns the run's launches and the timed row."""
    from orbslam2_tpu_torch import train_vocab
    from orbslam2_tpu_torch.io.vocabulary import train_vocabulary
    tag = "phase 3e"
    t0 = time.perf_counter()
    desc = train_vocab.gather_descriptors(VOCAB_SCENES, VOCAB_FEATURES, "cuda")
    t_gather = time.perf_counter() - t0
    CK.reset_launch_counts()
    seconds: dict = {}
    card = train_vocabulary(desc, k=VOCAB_K, levels=VOCAB_LEVELS, seed=0, device="cuda",
                            seconds=seconds)
    torch.cuda.synchronize()
    launches = launch_counts(CK)
    t0 = time.perf_counter()
    host = train_vocabulary(desc, k=VOCAB_K, levels=VOCAB_LEVELS, seed=0)
    host_s = time.perf_counter() - t0
    differ = [f for f in VOCAB_FIELDS if not np.array_equal(getattr(card, f), getattr(host, f))]
    if differ:
        raise AssertionError(f"{tag}: the card's tree differs from the host's in {differ}")
    for kernel in ("hamming_best2", "bow_assign"):
        if launches[kernel].get("vocab", 0) <= 0:
            raise AssertionError(f"{tag}: the trainer never launched {kernel}")
    words = np.ascontiguousarray(desc, np.uint32).view(np.int32)
    row = best2_row(CK, PH, lib, mma_per_s, "vocab-root", words, words[:VOCAB_K],
                    np.ones((len(words), VOCAB_K), bool), cold=True, reps=10)
    print(f"{tag}: train_vocabulary on the card, {len(desc)} descriptors of "
          f"{VOCAB_SCENES} scenes (gathered in {t_gather:.1f} s), k={VOCAB_K}, "
          f"{VOCAB_LEVELS} levels: {len(card.node_desc)} nodes, {card.n_words} words, "
          f"equal to the host trainer's tree on {', '.join(VOCAB_FIELDS)}; split "
          f"{seconds['split']:.2f} s and idf pass {seconds['idf']:.2f} s on the card, "
          f"host trainer {host_s:.2f} s; launches {launches}", flush=True)
    return dict(launches=launches, row=row)


def seg_sum_cases(BA, PG) -> list:
    """(name, plan index, segments, row shape, dtype) of `seg_sum` at the
    shapes the main path gives it, on the indices of the phase 3b problems:
    the local cell's Hcc, Hpp, coupling G and edge count, the global cell's
    Hcc and G (1,048,576 mostly empty segments), the pose graph's blocks
    and b; and a ragged case (unsorted, repeated and empty segments, a
    row of 5) in float32 and float64."""
    cases = []
    for name, C, P, E in BA_CELLS:
        arrays, _ = BA.synthetic_problem(C, P, E, seed=0)
        e_cam = arrays["e_cam"].astype(np.int64)
        e_pt = arrays["e_pt"].astype(np.int64)
        cases += [(f"{name} Hcc", e_cam, C, (6, 6), np.float32),
                  (f"{name} G", e_pt * C + e_cam, P * C, (6, 3), np.float32)]
        if name == "local":
            cases += [(f"{name} Hpp", e_pt, P, (3, 3), np.float32),
                      (f"{name} count", e_pt, P, (), np.float32)]
    K, E = PGO_CELL
    pgo = PG.synthetic_problem(K, E, seed=0)
    cases += [("pgo Hd", pgo[4], K, (7, 7), np.float32), ("pgo b", pgo[5], K, (7,), np.float32)]
    ragged = np.random.default_rng(1).integers(0, 333, 1001)
    cases += [("ragged", ragged, 400, (5,), np.float32),
              ("ragged f64", ragged, 400, (5,), np.float64)]
    return cases


def check_seg_sum(CK, PH, BA, PG, lib, timed: bool = True) -> dict:
    """Phase 3f: `seg_sum` on the card against its plain version on the CPU
    copy of the same inputs, bit for bit, each output written between guard
    rows that must stay intact; then, if `timed`, its times warm and cold,
    its empty kernel, its byte bound, the plain version on the card and
    `index_add_` (the library call) into a zeroed output."""
    rng = np.random.default_rng(0)
    rows = {}
    # the kernel's grid: a block a 256 (segment, column) pairs, at most 8 an SM
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, idx, n, tail, dtype in seg_sum_cases(BA, PG):
        x_np = rng.standard_normal((len(idx), *tail)).astype(dtype)
        x, i_dev = torch.from_numpy(x_np).cuda(), torch.from_numpy(idx).cuda()
        plan = CK.seg_plan(i_dev, n)
        buf = PH.guarded(n, x.dtype, tail)
        got = CK.seg_sum(x, plan, out=buf[1])
        PH.check_guards(f"seg_sum {name}", [buf])
        ref = CK.seg_sum_ref(torch.from_numpy(x_np), torch.from_numpy(idx), n)
        got = got.cpu()
        err = float((got - ref).abs().max()) if n else 0.0
        if not torch.equal(got, ref):
            raise AssertionError(f"seg_sum {name}: differs from the plain version on "
                                 f"the CPU (max abs err {err})")
        shape = f"{len(idx)}x{'x'.join(map(str, tail)) or '1'} -> {n}"
        if not timed:
            print(f"phase 3f: seg_sum {name} [{shape}] equal to the CPU bit for bit, "
                  "guard rows intact", flush=True)
            continue
        d = int(np.prod(tail, dtype=np.int64))
        es = x.element_size()
        n_bytes = len(idx) * (d * es + 4) + 4 * (n + 1) + n * d * es
        by_bytes = 1e3 * n_bytes / T.HBM_BYTES_PER_S
        by_ops = 1e3 * len(idx) * d / (FP32_OPS_PER_S if es == 4 else FP64_OPS_PER_S)
        n_sets = T.cold_count(n_bytes)
        xs = [x.clone() for _ in range(n_sets)]
        outs = [torch.empty_like(buf[1]) for _ in range(n_sets)]
        zero = torch.zeros_like(buf[1])
        row = dict(err=err, shape=shape,
                   ms=T.time_ms(lambda: CK.seg_sum(x, plan, out=outs[0])),
                   plain_ms=T.time_ms(lambda: CK.seg_sum_ref(x, i_dev, n), reps=20),
                   dev=T.queued_ms(lambda: CK.seg_sum(x, plan, out=outs[0]), reps=10),
                   cold=T.queued_cold_ms(
                       lambda i: CK.seg_sum(xs[i], plan, out=outs[i]), n_sets),
                   plain_dev=T.queued_ms(lambda: CK.seg_sum_ref(x, i_dev, n), reps=10),
                   floor=PH.empty_kernel_ms(lib, min(-(-n * d // 256), 8 * sms), 1, 256),
                   library_ms=T.time_ms(lambda: zero.index_add_(0, i_dev, x)),
                   library_dev=T.queued_ms(lambda: zero.index_add_(0, i_dev, x), reps=10),
                   bound_ms=max(by_bytes, by_ops), bound_bytes_ms=by_bytes,
                   bound_ops_ms=by_ops,
                   bound_by="bytes" if by_bytes >= by_ops else "operations")
        del xs, outs
        print(f"phase 3f: seg_sum {name} [{shape}] {np.dtype(dtype).name} equal to the "
              f"CPU bit for bit (max_abs_err 0), guard rows intact; per call (CUDA "
              f"events, back-to-back) kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
              f"ms, index_add_ {row['library_ms']:.4f} ms; device time (queued) warm "
              f"{T.fmt_ms(row['dev'])}, cold {T.fmt_ms(row['cold'])}, plain "
              f"{T.fmt_ms(row['plain_dev'])}, index_add_ {T.fmt_ms(row['library_dev'])}, "
              f"empty kernel of the grid {T.fmt_ms(row['floor'])}; bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} ({n_bytes} bytes; adds "
              f"{row['bound_ops_ms']:.4f} ms)", flush=True)
        rows[name] = row
    return rows


def _rot_deg(dR: np.ndarray) -> float:
    """Angle of a rotation matrix in degrees, from its skew part (exact for
    small angles, where the trace's arccos loses every digit)."""
    skew = [dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]
    return float(np.degrees(np.arcsin(min(1.0, np.linalg.norm(skew) / 2))))


def check_pnp(PNP) -> None:
    """pnp_ransac on the card: a seeded problem with 40 outliers among 128
    points in 1024 padded rows, against the truth and against the same call
    on the CPU with the same minimal sets."""
    import warnings
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(5)
    n, N = 128, 1024
    Xn = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(4, 9, n)], -1).astype(np.float32)
    T_gt = np.hstack([np.eye(3), np.array([[0.1], [0.0], [0.2]])]).astype(np.float32)
    pc = Xn @ T_gt[:, :3].T + T_gt[:, 3]
    uvn = np.stack([500 * pc[:, 0] / pc[:, 2] + 320,
                    500 * pc[:, 1] / pc[:, 2] + 240], -1).astype(np.float32)
    out = rng.choice(n, 40, replace=False)
    uvn[out] = rng.uniform([0, 0], [640, 480], (40, 2))
    X, uv = np.zeros((N, 3), np.float32), np.zeros((N, 2), np.float32)
    X[:n], uv[:n] = Xn, uvn
    valid = np.arange(N) < n
    gen = torch.Generator()
    gen.manual_seed(1)
    idx = PNP.draw_minimal_sets(torch.from_numpy(valid), gen)
    intr = (500.0, 500.0, 320.0, 240.0)

    def call(dev):
        a = [torch.from_numpy(x).to(dev) for x in (X, uv, np.ones(N, np.float32), valid)]
        return lambda: PNP.pnp_ransac(*a, *intr, idx=idx.to(dev))

    on_cpu, on_card = call("cpu"), call("cuda")
    res_c, res = on_cpu(), on_card()
    inl = res.inliers.cpu().numpy()
    n_inl, n_cpu = int(res.n_inliers), int(res_c.n_inliers)
    Tc = res.T.cpu().numpy().astype(np.float64)
    dR = Tc[:, :3] @ T_gt[:, :3].T
    deg = _rot_deg(dR)
    cm = 100 * np.linalg.norm(Tc[:, :3].T @ Tc[:, 3] - T_gt[:, :3].T @ T_gt[:, 3])
    ms = T.time_ms(on_card, reps=5)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        on_card()
        torch.cuda.synchronize()
    n_kern = sum(e.count for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            on_card()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    waits = sum("synchroniz" in str(w.message) for w in caught)
    print(f"phase 3d: pnp_ransac, 128 points with 40 outliers in 1024 rows, 256 "
          f"hypotheses: {n_inl} inliers on the card ({int(inl[out].sum())} of the "
          f"outliers), {n_cpu} on the CPU with the same minimal sets; pose "
          f"{cm:.3f} cm and {deg:.4f} degrees from the truth; {ms:.2f} ms per call "
          f"(CUDA events, back-to-back), {n_kern} kernels per call (profiler), "
          f"{waits} waits for the card per call (sync debug mode 'warn')", flush=True)
    if not (n_inl >= 70 and inl[out].sum() <= 2 and cm <= 2.0 and deg <= 0.5
            and abs(n_inl - n_cpu) <= 3):
        raise AssertionError("pnp_ransac: gates 70 inliers, 2 outliers, 2 cm, 0.5 "
                             "degrees, within 3 of the CPU")


def _same(a, b) -> bool:
    """Two results (tuples of tensors) equal bit for bit."""
    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_ba(BA, PG, CK) -> dict:
    """ba_solve on the card against the same call on the CPU, at both BA
    cells: cost within 1e-3 relative, inlier masks on >= 99.5% of edges;
    a second card solve equal to the first bit for bit. The same for the
    pose graph of PGO_CELL (the card's pair equal, the cost within 1% of
    the CPU's). Returns seg_sum's launches per local BA, per global BA
    chunk (GBA_CHUNK) and per pose-graph optimization."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    per_call = {}
    for name, C, P, E in BA_CELLS:
        arrays, intr = BA.synthetic_problem(C, P, E, seed=0)
        solver = "dense" if BA._use_dense_schur(C, P, "auto") else "cg"
        res = {}
        for dev in ("cpu", "cuda"):
            prob = BA.problem_from_numpy(arrays, torch.device(dev))
            CK.reset_launch_counts()
            r = BA.ba_solve(prob, *intr)
            res[dev] = (float(r.cost), r.e_inlier.cpu().numpy())
        per_call[f"{name} BA"] = CK.seg_sum.launches
        again = BA.ba_solve(prob, *intr)
        repeats = _same(r, again)
        (c_cpu, i_cpu), (c_gpu, i_gpu) = res["cpu"], res["cuda"]
        rel = abs(c_gpu - c_cpu) / max(abs(c_cpu), 1e-12)
        agree = float((i_cpu == i_gpu).mean())
        if not (rel <= 1e-3 and agree >= 0.995 and repeats):
            raise AssertionError(f"ba_solve {name}: card cost {c_gpu}, CPU {c_cpu} "
                                 f"(rel {rel:.2e}), inliers agree {agree:.4f}; the "
                                 f"card's second solve equal to its first: {repeats}")
        if name == "global":
            CK.reset_launch_counts()
            BA.ba_solve(prob, *intr, iters1=GBA_CHUNK[0], iters2=GBA_CHUNK[1])
            per_call["GBA chunk"] = CK.seg_sum.launches
        ms = T.time_ms(lambda: BA.ba_solve(prob, *intr), reps=5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            BA.ba_solve(prob, *intr)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        n_kern = sum(e.count for e in kern)
        dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
        print(f"phase 3b: ba_solve {name} C={C} P={P} E={E} ({solver}): cost "
              f"card {c_gpu:.6g} CPU {c_cpu:.6g} (rel diff {rel:.2e}), inliers "
              f"agree on {100 * agree:.3f}% ({int(i_gpu.sum())}/{E}); a second card "
              f"solve equal bit for bit; {ms:.2f} ms per solve (CUDA events), {n_kern} "
              f"kernels and {dev_ms:.2f} ms device time per solve (profiler); "
              f"{per_call[f'{name} BA']} seg_sum launches a solve", flush=True)
    K, E = PGO_CELL
    args = PG.synthetic_problem(K, E, seed=0)
    out = {}
    for dev in ("cpu", "cuda"):
        CK.reset_launch_counts()
        out[dev] = PG.optimize_pose_graph(*(torch.from_numpy(np.array(a)).to(dev)
                                            for a in args))
    per_call["PGO"] = CK.seg_sum.launches
    on_card = [torch.from_numpy(np.array(a)).cuda() for a in args]
    repeats = _same(out["cuda"], PG.optimize_pose_graph(*on_card))
    cost_cpu, cost_gpu = float(out["cpu"][3][-1]), float(out["cuda"][3][-1])
    rel = abs(cost_gpu - cost_cpu) / max(abs(cost_cpu), 1e-12)
    ms = T.time_ms(lambda: PG.optimize_pose_graph(*on_card), reps=3)
    print(f"phase 3b: optimize_pose_graph K={K} E={E}: cost {float(out['cuda'][3][0]):.6g} "
          f"-> card {cost_gpu:.6g}, CPU {cost_cpu:.6g} (rel diff {rel:.2e}); a second "
          f"card solve equal bit for bit: {repeats}; {ms:.2f} ms per solve (CUDA "
          f"events); {per_call['PGO']} seg_sum launches a solve", flush=True)
    if not (repeats and rel <= 1e-2 and cost_gpu < float(out["cuda"][3][0])):
        raise AssertionError("optimize_pose_graph: gates: the card's pair equal, the "
                             "cost within 1% of the CPU's and lowered")
    return per_call


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

    def item(i):
        data = {"image": _u8(synth, scene, gt[i], i)}
        if sensor == "rgbd":
            data["depth"] = synth.depth_room(scene, gt[i])
        elif sensor == "stereo":
            right = gt[i].copy()
            right[:, 3] = right[:, 3] - np.array([0.5, 0, 0], np.float32)
            data["right"] = _u8(synth, scene, right, 10_000 + i)
        return i / 30.0, data

    with ThreadPoolExecutor(8) as pool:
        _RENDERED[key] = list(pool.map(item, range(len(gt))))
    return _RENDERED[key]


def run_sequence(P, CK, evaluation, tag: str, name: str, items, gt: np.ndarray,
                 cfg, sensor: str, pipelined: bool, whole: bool = True,
                 keep: bool = False):
    """Track a rendered sequence on the card: synchronously through the
    sensor's entry point (System.track_rgbd / track_stereo / track_monocular,
    mapper inline), or pipelined through System(async_mapping=True)
    .run_sequence. Counts the path's kernel launches from 0 and applies the
    sensor's gates; keep=True drains the mapping worker instead of stopping
    it and returns the live System under "system"; a run that is not the `whole` sequence
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
        if keep:
            slam.wait_for_mapping()
        else:
            slam.shutdown()
    else:
        tracked = sum(entry(ts, d) is not None for ts, d in items)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts(CK)
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
    for kernel in KERNELS[:2]:
        if launches[kernel].get("tracker", 0) <= 0:
            raise AssertionError(f"{tag} {name}: the tracker never launched {kernel}")
    # every BA solve assembled its normal equations with seg_sum
    if sum(launches["seg_sum"].values()) < lm.counters["ba_solves"]:
        raise AssertionError(f"{tag} {name}: {launches['seg_sum']} seg_sum launches for "
                             f"{lm.counters['ba_solves']} BA solves")
    # every keyframe the mapper took ran the vocabulary descent once
    if launches["bow_assign"].get("mapper", 0) < lm.counters["keyframes"]:
        raise AssertionError(f"{tag} {name}: {launches['bow_assign']} bow_assign "
                             f"launches for {lm.counters['keyframes']} mapped keyframes")
    return dict(launches=launches, counters=dict(lm.counters), kfs=kfs,
                tracked=tracked, first_ok=first_ok, system=slam if keep else None)


def launch_counts(CK) -> dict:
    """Each kernel's launches by caller since the counts were reset. Fails
    if a `bow_assign` call of that run packed its table on the fly: the
    main path hands the kernel the vocabulary's packed table."""
    if CK.bow_assign.packed_on_the_fly:
        raise AssertionError(f"{CK.bow_assign.packed_on_the_fly} bow_assign calls "
                             "packed the children-block table on the fly")
    return {name: dict(getattr(CK, name).launches_by) for name in KERNELS}


def _se3(T: np.ndarray) -> np.ndarray:
    """[3, 4] pose -> [4, 4] float64."""
    return np.vstack([T, [0, 0, 0, 1]]).astype(np.float64)


def _u8(synth, scene, pose, seed):
    return np.clip(synth.render_room(scene, pose, seed=seed), 0, 255).astype(np.uint8)


def _print_attempts(tag: str, relocalizer, since: int) -> None:
    for a in relocalizer.attempts[since:]:
        tried = "; ".join(
            f"keyframe {t['kf']}: {t['bow_matches']} BoW matches, {t['pnp_inliers']} "
            f"PnP inliers, {t['lm_inliers']} after LM, {t['bound']} bindings after "
            f"{t['rescue_passes']} rescue passes" for t in a["tried"])
        print(f"{tag}: relocalization attempt on frame {a['frame_id']}: "
              f"{a['candidates']} candidates, {'ok' if a['ok'] else 'failed'}, "
              f"{a['ms']:.1f} ms" + (f" ({tried})" if tried else ""), flush=True)


def _blackout(tag: str, slam, track, shape, t0: float) -> float:
    """Feed N_BLANK featureless frames; the tracker must end LOST. Returns
    the next timestamp."""
    blank = np.full(shape, 128, np.uint8)
    for j in range(N_BLANK):
        track(blank, t0 + j / 30.0)
    if slam.tracking_state.name != "LOST":
        raise AssertionError(f"{tag}: state {slam.tracking_state.name} after "
                             f"{N_BLANK} blank frames (expected LOST)")
    return t0 + N_BLANK / 30.0


def check_registration(tag: str, slam) -> None:
    """Every keyframe made was registered; every live one is in the database
    and has gate nodes."""
    lm, mp = slam.local_mapper, slam.map
    made = lm.counters["keyframes"] + (2 if slam.cfg.sensor.name == "MONOCULAR" else 1)
    live = [int(k) for k in mp.kf_ids]
    missing = [k for k in live if not slam.kf_db.registered[k]
               or not (mp.kf_bow_node[k] >= 0).any()]
    words = [int((slam.kf_db.word_ids[k] >= 0).sum()) for k in live]
    print(f"{tag}: {lm.counters['kfs_registered']} keyframes registered of {made} made "
          f"(the initial map's and the mapper's); {len(live)} live, all in the "
          f"database with gate nodes: {not missing}; distinct words per keyframe "
          f"{min(words)} to {max(words)}", flush=True)
    if lm.counters["kfs_registered"] < made or missing:
        raise AssertionError(f"{tag}: registered {lm.counters['kfs_registered']} of "
                             f"{made}, live keyframes not registered: {missing}")


def check_reloc_rgbd(CK, synth, scene, slam, gt) -> dict:
    """Phase 7 on the RGB-D System the pipelined sweep left: blackout,
    relocalization, tracking on, localization mode."""
    tag = "phase 7 rgbd"
    check_registration(tag, slam)
    world = np.linalg.inv(_se3(gt[0]))  # the map's world is the first camera

    def track(img, ts, i=RGBD_REVISIT):
        return slam.track_rgbd(img, synth.depth_room(scene, gt[i]), ts)

    CK.reset_launch_counts()
    t = _blackout(tag, slam, track, (scene.height, scene.width), len(gt) / 30.0)
    n_att = len(slam.relocalizer.attempts)
    pose = None
    for j in range(RELOC_TRIES):
        pose = track(_u8(synth, scene, gt[RGBD_REVISIT], 999 + j), t)
        t += 1 / 30.0
        if pose is not None:
            break
    _print_attempts(tag, slam.relocalizer, n_att - N_BLANK + 1)
    if pose is None:
        raise AssertionError(f"{tag}: no relocalization within {RELOC_TRIES} frames")
    truth = (_se3(gt[RGBD_REVISIT]) @ world)[:3]
    cm = 100 * np.linalg.norm(pose[:, :3].T @ pose[:, 3]
                              - truth[:, :3].T @ truth[:, 3])
    deg = _rot_deg(pose[:, :3].astype(np.float64) @ truth[:, :3].T)
    print(f"{tag}: relocalized on revisit frame {j + 1} of {RELOC_TRIES} at the "
          f"viewpoint of sweep frame {RGBD_REVISIT}: {cm:.3f} cm and {deg:.4f} "
          f"degrees from the ground truth", flush=True)
    if cm > RELOC_GATE_CM or deg > RELOC_GATE_DEG:
        raise AssertionError(f"{tag}: relocalized pose off by {cm:.2f} cm, {deg:.3f} "
                             f"degrees (gates: {RELOC_GATE_CM} cm, {RELOC_GATE_DEG} "
                             "degree)")

    def follow(first: int, n: int, seed0: int, what: str):
        nonlocal t
        ok = 0
        for i in range(first, first + n):
            ok += track(_u8(synth, scene, gt[i], seed0 + i), t, i) is not None
            t += 1 / 30.0
        if ok != n:
            raise AssertionError(f"{tag}: {what}: tracked {ok}/{n}")
        return ok

    first = RGBD_REVISIT + 1
    n_on = follow(first, RELOC_ON_FRAMES, 2000, "the frames after relocalization")
    slam.wait_for_mapping()
    kfs, pts = slam.map.n_keyframes, slam.map.n_points
    slam.activate_localization_mode()
    temporal0 = slam.tracker.n_temporal_frames
    n_loc = follow(first + RELOC_ON_FRAMES, LOCALIZATION_FRAMES, 3000,
                   "localization mode")
    temporal = slam.tracker.n_temporal_frames - temporal0
    slam.deactivate_localization_mode()
    slam.shutdown()
    launches = launch_counts(CK)
    print(f"{tag}: tracked {n_on}/{RELOC_ON_FRAMES} frames after the "
          f"relocalization; localization mode: tracked {n_loc}/{LOCALIZATION_FRAMES}, "
          f"keyframes {kfs} -> {slam.map.n_keyframes}, points {pts} -> "
          f"{slam.map.n_points}, {temporal} frames with temporal points; kernel "
          f"launches {launches}", flush=True)
    if (slam.map.n_keyframes, slam.map.n_points) != (kfs, pts) or temporal <= 0:
        raise AssertionError(f"{tag}: localization mode changed the map or never "
                             "used temporal points")
    return launches


def check_reloc_mono(CK, synth, scene, slam, gt) -> dict:
    """Phase 7 on the monocular System the pipelined orbit left: blackout,
    then the viewpoint of the keyframe that observes the most points."""
    tag = "phase 7 mono"
    check_registration(tag, slam)
    mp = slam.map
    live = [int(k) for k in mp.kf_ids]
    best = max(live, key=lambda k: int((mp.kf_pt[k] >= 0).sum()))
    revisit = int(round(float(mp.kf_timestamp[best]) * 30))
    # the map's world is the camera of keyframe 0, the initialization's
    # reference frame (its row keeps its timestamp if it was culled)
    ref = int(round(float(mp.kf_timestamp[0]) * 30))

    def track(img, ts):
        return slam.track_monocular(img, ts)

    CK.reset_launch_counts()
    t = _blackout(tag, slam, track, (scene.height, scene.width), len(gt) / 30.0)
    n_att = len(slam.relocalizer.attempts)
    pose = None
    for j in range(RELOC_TRIES):
        pose = track(_u8(synth, scene, gt[revisit], 999 + j), t)
        t += 1 / 30.0
        if pose is not None:
            break
    slam.shutdown()
    launches = launch_counts(CK)
    _print_attempts(tag, slam.relocalizer, n_att - N_BLANK + 1)
    if pose is None:
        raise AssertionError(f"{tag}: no relocalization within {RELOC_TRIES} frames")
    # viewing direction in the ground truth's world (the map's scale is free)
    cos = float((pose[2, :3] @ gt[ref][:, :3]) @ gt[revisit][2, :3])
    print(f"{tag}: relocalized on revisit frame {j + 1} of {RELOC_TRIES} at the "
          f"viewpoint of orbit frame {revisit} (keyframe {best}): viewing direction "
          f"cos {cos:.5f}; kernel launches {launches}", flush=True)
    if cos <= 0.99:
        raise AssertionError(f"{tag}: viewing direction cos {cos:.4f} (gate: 0.99)")
    return launches


def rescue_world(P, device: str):
    """(relocalizer, query frame, query pose) of a constructed map on
    `device`, at the frame width of the main path (1024 rows, 80 of them
    features). Keyframe 0 sees 80 points from the origin; the query sees
    them from 5 cm beside it, with the descriptors of features 35 to 69
    corrupted by 70 bits: past TH_LOW = 50, so that matching by BoW leaves
    about 45 inliers, under the 50 of the acceptance gate, but inside the
    ORBdist = 100 of the projective rescue. Keyframe 1 is a decoy: it
    carries 50 of the query's own descriptors, the corrupted ones among
    them, so the database ranks it first, but its points lie elsewhere and
    its PnP finds no pose. The minimal
    sets of every PnP call come from a numpy generator, the same on every
    device."""
    from orbslam2_tpu_torch.frontend.frame import Frame
    from orbslam2_tpu_torch.io.vocabulary import default_vocabulary
    from orbslam2_tpu_torch.map.keyframe_db import KeyFrameDatabase
    from orbslam2_tpu_torch.map.mapstate import MapState
    from orbslam2_tpu_torch.relocalization import Relocalizer
    N, n = RESCUE_WIDTH, RESCUE_POINTS
    rng = np.random.default_rng(3)
    cfg = P.with_camera(P.SlamConfig(sensor=P.Sensor.MONOCULAR), fx=500.0, fy=500.0,
                        cx=320.0, cy=240.0, width=640, height=480)
    cam = cfg.camera
    voc = default_vocabulary()
    mp = MapState(cfg, N)
    db = KeyFrameDatabase(cfg, mp, voc.n_words)
    reloc = Relocalizer(cfg, mp, voc, db, device=device)

    def project(T, X):
        Xc = X @ T[:, :3].T + T[:, 3]
        return np.stack([cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx,
                         cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy], -1).astype(np.float32)

    def pad(a, fill=0):
        out = np.full((N,) + a.shape[1:], fill, a.dtype)
        out[:len(a)] = a
        return out

    def points():
        return np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                         rng.uniform(4, 8, n)], -1).astype(np.float32)

    def keyframe(X, desc, frame_id):
        ids = mp.add_points(X, desc.view(np.int32), ref_kf=frame_id, first_kf=frame_id)
        dist = np.linalg.norm(X, axis=-1)
        mp.pt_max_dist[ids], mp.pt_min_dist[ids] = dist, dist / 10.0
        mp.pt_normal[ids] = X / dist[:, None]
        T = np.eye(3, 4, dtype=np.float32)
        k = mp.add_keyframe(T, float(frame_id), frame_id, pad(project(T, X)),
                            np.zeros(N, np.int32), np.zeros(N, np.float32),
                            pad(desc).view(np.int32), np.arange(N) < n, pad(ids, -1))
        vec, nodes = reloc.frame_bow(mp.kf_desc[k], mp.kf_feat_valid[k])
        mp.kf_bow_node[k] = nodes
        db.add(k, vec)
        return k

    X = points()
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    keyframe(X, desc, 0)
    qdesc = desc.copy()
    for i in range(35, 70):
        bits = np.unpackbits(qdesc[i].view(np.uint8))
        bits[rng.choice(256, 70, replace=False)] ^= 1
        qdesc[i] = np.packbits(bits).view(np.uint32)
    decoy = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    decoy[:15], decoy[35:70] = qdesc[:15], qdesc[35:70]
    keyframe(points(), decoy, 1)
    T_q = np.hstack([np.eye(3), [[0.05], [0.02], [0.0]]]).astype(np.float32)
    uv = pad(project(T_q, X))
    frame = Frame(frame_id=100, timestamp=9.0, xy=uv, xy_raw=uv.copy(),
                  octave=np.zeros(N, np.int32), angle=np.zeros(N, np.float32),
                  response=np.ones(N, np.float32), desc=pad(qdesc).view(np.int32),
                  valid=np.arange(N) < n, depth=np.full(N, -1.0, np.float32),
                  ur=np.full(N, -1.0, np.float32))
    _numpy_draws(reloc)
    return reloc, frame, T_q


def port_kit(P, device: str):
    """The classes `narrow_rescue_world` builds with, of this package on
    `device` (a test hands it the JAX package's instead)."""
    import types
    from orbslam2_tpu_torch.frontend.frame import Frame
    from orbslam2_tpu_torch.io.vocabulary import default_vocabulary
    from orbslam2_tpu_torch.map.keyframe_db import KeyFrameDatabase
    from orbslam2_tpu_torch.map.mapstate import MapState
    from orbslam2_tpu_torch.relocalization import Relocalizer
    voc = default_vocabulary()
    return types.SimpleNamespace(
        C=P, Frame=Frame, Map=MapState, desc=lambda d: d.view(np.int32),
        db=lambda cfg, mp: KeyFrameDatabase(cfg, mp, voc.n_words),
        reloc=lambda cfg, mp, db: Relocalizer(cfg, mp, voc, db, device=device))


# the narrow rescue's world: points matched by BoW, rescued by the coarse
# pass, and trapped there by a decoy; bits flipped from a point's descriptor
# for its query feature (TH_LOW = 50, the passes' ORBdist 100 and 64)
NARROW_CLEAN, NARROW_COARSE, NARROW_TRAPPED = 35, 5, 25
NARROW_BITS = {"coarse": 70, "true": 62, "decoy": 54}
NARROW_DECOY_PX = 7.0


def narrow_rescue_world(kit, rows: int):
    """(relocalizer, query frame, query pose) of a constructed map that only
    the relocalizer's narrow second rescue pass (window 3, ORBdist 64)
    brings to the 50-inlier gate. Keyframe 0 sees 65 points from the origin;
    the query sees them from 5 cm beside it, in `rows` feature rows:

    - 35 features carry their point's descriptor: BoW matches them, and
      PnP and the pose optimization keep 35 inliers, under the gate;
    - 5 are 70 bits off: only the coarse pass (window 10, ORBdist 100)
      binds them;
    - 25 are 62 bits off, and each has a decoy 7 px away that is 54 bits
      off: the coarse pass binds the decoy (the lower distance in its
      10 px window), 65 bindings reach the gate's count, and the pose
      optimization drops the 25 decoys (7 px is outside its chi2 cut),
      which leaves 40, between the 30 and 50 of the narrow pass's branch.
      The narrow pass's 3 px window holds only the true feature, which its
      ORBdist of 64 accepts: 65 inliers.

    `kit` names the package's classes (`port_kit`)."""
    rng = np.random.default_rng(5)
    n_pts = NARROW_CLEAN + NARROW_COARSE + NARROW_TRAPPED
    C = kit.C
    cfg = C.with_camera(C.SlamConfig(sensor=C.Sensor.MONOCULAR), fx=500.0, fy=500.0,
                        cx=320.0, cy=240.0, width=640, height=480)
    cam = cfg.camera
    mp = kit.Map(cfg, rows)
    db = kit.db(cfg, mp)
    reloc = kit.reloc(cfg, mp, db)

    def project(T, X):
        Xc = X @ T[:, :3].T + T[:, 3]
        return np.stack([cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx,
                         cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy], -1).astype(np.float32)

    def pad(a, fill=0):
        out = np.full((rows,) + a.shape[1:], fill, a.dtype)
        out[:len(a)] = a
        return out

    def flipped(d, n_bits):
        bits = np.unpackbits(d.copy().view(np.uint8))
        bits[rng.choice(256, n_bits, replace=False)] ^= 1
        return np.packbits(bits).view(np.uint32)

    X = np.stack([rng.uniform(-1.8, 1.8, n_pts), rng.uniform(-1.3, 1.3, n_pts),
                  rng.uniform(4, 8, n_pts)], -1).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
    ids = mp.add_points(X, kit.desc(desc), ref_kf=0, first_kf=0)
    dist = np.linalg.norm(X, axis=-1)
    mp.pt_max_dist[ids], mp.pt_min_dist[ids] = dist, dist / 10.0
    mp.pt_normal[ids] = X / dist[:, None]
    T_kf = np.eye(3, 4, dtype=np.float32)
    k = mp.add_keyframe(T_kf, 0.0, 0, pad(project(T_kf, X)), np.zeros(rows, np.int32),
                        np.zeros(rows, np.float32), kit.desc(pad(desc)),
                        np.arange(rows) < n_pts, pad(ids, -1))
    vec, nodes = reloc.frame_bow(mp.kf_desc[k], mp.kf_feat_valid[k])
    mp.kf_bow_node[k] = nodes
    db.add(k, vec)

    T_q = np.hstack([np.eye(3), [[0.05], [0.02], [0.0]]]).astype(np.float32)
    uv = project(T_q, X)
    qdesc = desc.copy()
    coarse = range(NARROW_CLEAN, NARROW_CLEAN + NARROW_COARSE)
    trapped = range(NARROW_CLEAN + NARROW_COARSE, n_pts)
    for i in coarse:
        qdesc[i] = flipped(desc[i], NARROW_BITS["coarse"])
    decoy_uv, decoy_desc = [], []
    for i in trapped:
        qdesc[i] = flipped(desc[i], NARROW_BITS["true"])
        a = rng.uniform(0, 2 * np.pi)
        decoy_uv.append(uv[i] + NARROW_DECOY_PX * np.array([np.cos(a), np.sin(a)]))
        decoy_desc.append(flipped(desc[i], NARROW_BITS["decoy"]))
    xy = pad(np.concatenate([uv, np.asarray(decoy_uv, np.float32)]))
    n_feat = n_pts + len(decoy_uv)
    frame = kit.Frame(frame_id=100, timestamp=9.0, xy=xy, xy_raw=xy.copy(),
                      octave=np.zeros(rows, np.int32), angle=np.zeros(rows, np.float32),
                      response=np.ones(rows, np.float32),
                      desc=kit.desc(pad(np.concatenate([qdesc, np.stack(decoy_desc)]))),
                      valid=np.arange(rows) < n_feat, depth=np.full(rows, -1.0, np.float32),
                      ur=np.full(rows, -1.0, np.float32))
    return reloc, frame, T_q


def check_reloc_rescue(P, CK) -> None:
    """Phase 7b: the relocalizer's harder branches on the card, which the
    revisits of phase 7 never reach: a first candidate whose PnP fails, a
    second whose BoW matches stay under the 50-inlier gate, the projective
    rescue ([1024,1024] search_by_projection on `hamming_best2`) and the
    pose optimization after it. Held to the same call on the CPU with the
    same minimal sets: the same verdict and bindings, the pose within 1e-3."""
    tag = "phase 7b"
    cpu, frame_cpu, T_q = rescue_world(P, "cpu")
    card, frame, _ = rescue_world(P, "cuda")
    ok_cpu = cpu.relocalize(frame_cpu)
    CK.reset_launch_counts()
    ok = card.relocalize(frame)
    torch.cuda.synchronize()
    launches = launch_counts(CK)
    for where, r in (("card", card), ("CPU", cpu)):
        _print_attempts(f"{tag} ({where})", r, 0)
    if not (ok and ok_cpu):
        raise AssertionError(f"{tag}: relocalized on the card {ok}, on the CPU {ok_cpu}")
    tried = card.attempts[-1]["tried"]
    same = bool((frame.pt_idx == frame_cpu.pt_idx).all())
    d_pose = float(np.abs(frame.pose - frame_cpu.pose).max())
    cm = 100 * float(np.linalg.norm(frame.pose[:, 3] - T_q[:, 3]))
    print(f"{tag}: constructed map, {RESCUE_POINTS} features in {RESCUE_WIDTH} rows: "
          f"{len(tried)} candidates tried, {tried[-1]['rescue_passes']} rescue passes "
          f"lifted {tried[-1]['lm_inliers']} inliers to {tried[-1]['final_inliers']} "
          f"({tried[-1]['bound']} bindings); bindings equal to the CPU's: {same}; pose "
          f"within {d_pose:.2e} of the CPU's, translation {cm:.3f} cm from the truth; "
          f"{card.attempts[-1]['ms']:.1f} ms; kernel launches {launches}", flush=True)
    first, last = tried[0], tried[-1]
    if not (len(tried) == 2 and first["pnp_inliers"] < 10
            and 15 <= last["bow_matches"] < 50 <= last["bound"]
            and last["rescue_passes"] >= 1 and same and d_pose <= 1e-3 and cm <= 2.0
            and [t["kf"] for t in tried] == [t["kf"] for t in cpu.attempts[-1]["tried"]]):
        raise AssertionError(f"{tag}: gates: a failed first candidate, 15 to 49 BoW "
                             "matches on the second, a rescue pass, 50 bindings, the "
                             "CPU's bindings and pose (1e-3), 2 cm")
    # one descent for the frame; a gated match per candidate and one
    # search_by_projection per rescue pass
    if (launches["bow_assign"].get("reloc", 0) != 1
            or launches["hamming_best2"].get("reloc", 0) != 2 + last["rescue_passes"]):
        raise AssertionError(f"{tag}: kernel launches {launches}")
    check_narrow_rescue(P, CK)


def _numpy_draws(reloc) -> None:
    """Minimal sets of every PnP call from a seeded numpy generator, the
    same on every device."""
    draws = np.random.default_rng(17)
    reloc.minimal_sets = lambda valid: np.stack(
        [draws.choice(np.flatnonzero(valid), 4, replace=False) for _ in range(256)])


def check_narrow_rescue(P, CK) -> None:
    """Phase 7b, the narrow second rescue pass (window 3, ORBdist 64), which
    no rendered sequence reaches: `narrow_rescue_world` on the card against
    the same call on the CPU with the same minimal sets. Gates: both
    relocalize after both passes, the same bindings, the pose within 1e-3
    of the CPU's and 2 cm of the truth, one descent, and one gated match
    and two searches by projection on `hamming_best2`."""
    tag = "phase 7b narrow"
    cpu, frame_cpu, T_q = narrow_rescue_world(port_kit(P, "cpu"), RESCUE_WIDTH)
    card, frame, _ = narrow_rescue_world(port_kit(P, "cuda"), RESCUE_WIDTH)
    _numpy_draws(cpu)
    _numpy_draws(card)
    ok_cpu = cpu.relocalize(frame_cpu)
    CK.reset_launch_counts()
    ok = card.relocalize(frame)
    torch.cuda.synchronize()
    launches = launch_counts(CK)
    for where, r in (("card", card), ("CPU", cpu)):
        _print_attempts(f"{tag} ({where})", r, 0)
    (tried,) = card.attempts[-1]["tried"]
    (tried_cpu,) = cpu.attempts[-1]["tried"]
    same = bool((frame.pt_idx == frame_cpu.pt_idx).all())
    d_pose = float(np.abs(frame.pose - frame_cpu.pose).max())
    cm = 100 * float(np.linalg.norm(frame.pose[:, 3] - T_q[:, 3]))
    print(f"{tag}: constructed map, {int(frame.valid.sum())} features in "
          f"{RESCUE_WIDTH} rows: {tried['lm_inliers']} inliers after BoW, "
          f"{tried['rescue_passes']} rescue passes to {tried['final_inliers']} "
          f"({tried['bound']} bindings); relocalized on the card {ok}, on the CPU "
          f"{ok_cpu}; bindings equal to the CPU's: {same}; pose within {d_pose:.2e} "
          f"of the CPU's, translation {cm:.3f} cm from the truth; kernel launches "
          f"{launches}", flush=True)
    if not (ok and ok_cpu and tried["rescue_passes"] == tried_cpu["rescue_passes"] == 2
            and tried["lm_inliers"] < 50 <= tried["final_inliers"] and same
            and d_pose <= 1e-3 and cm <= 2.0):
        raise AssertionError(f"{tag}: gates: both relocalized after two rescue passes, "
                             "the CPU's bindings and pose (1e-3), 2 cm")
    if (launches["bow_assign"].get("reloc", 0) != 1
            or launches["hamming_best2"].get("reloc", 0) != 3):
        raise AssertionError(f"{tag}: kernel launches {launches}")


class LapRecorder:
    """What one System's tracker and mapper did on a lap, frame by frame,
    recorded by wrapping methods of those instances (the package is left as
    it is): the frame whose state first became OK (the initialization), the
    first frame after it whose state is not OK, and the gate that dropped
    it: the motion-model gate or the inlier gate of
    Tracker._track_fused_finish, an empty local map in _track_fused, or
    the staged path's TrackReferenceKeyFrame, TrackLocalMap or relocalizer.
    With `gt`, also the initialization's two-keyframe BA and the first two
    local BAs: the map scale before and after each (the distance between the
    camera centres of the map's first two keyframes over the true one; the
    initialization then scales the map to a median depth of 1) and the
    solve's final cost. `detach()`
    restores the module function that the BA recording wraps."""

    N_BAS = 2

    def __init__(self, slam, gt=None):
        import threading
        self.slam, self.gt = slam, gt
        self.frame = -1
        self.init_frame = self.first_loss = None
        self.rec: dict = {}
        self.bas: list = []
        tr = slam.tracker
        self._wrap(tr, "process_image", self._process_image)
        self._wrap(tr, "_track_fused_finish", self._fused_finish)
        self._wrap(tr, "_select_local_points", self._local_points)
        self._wrap(tr, "_pose_optimize", self._pose_optimize)
        for name in ("_track_reference_keyframe", "_track_local_map", "_relocalize"):
            self._wrap(tr, name, self._stage(name))
        self._ba_module = None
        if gt is not None:
            from orbslam2_tpu_torch import local_mapping
            self._in_ba = threading.local()
            self._ba_module = local_mapping.BA
            self._ba_solve = local_mapping.BA.ba_solve
            local_mapping.BA.ba_solve = self._solve
            self._wrap(slam.local_mapper, "run_ba", self._run_ba)

    @staticmethod
    def _wrap(obj, name: str, make) -> None:
        setattr(obj, name, make(getattr(obj, name)))

    def detach(self) -> None:
        if self._ba_module is not None:
            self._ba_module.ba_solve = self._ba_solve
            self._ba_module = None

    def _process_image(self, orig):
        from orbslam2_tpu_torch.tracking import TrackState

        def run(*a, **kw):
            self.frame += 1
            self.rec = {"pose_opt": []}
            pose = orig(*a, **kw)
            ok = self.slam.tracker.state == TrackState.OK
            if ok and self.init_frame is None:
                self.init_frame = self.frame
            if not ok and self.init_frame is not None and self.first_loss is None:
                self.first_loss = (self.frame, self.gate())
            return pose
        return run

    def _fused_finish(self, orig):
        def run(mp, cam, last, timestamp, T2, n_cand, n_mm, n_inl1, n_inl2, *rest):
            need = 50 if self.slam.tracker.n_lost_frames > 0 else 30
            self.rec["fused"] = (n_cand, n_mm, n_inl1, n_inl2, need)
            return orig(mp, cam, last, timestamp, T2, n_cand, n_mm, n_inl1, n_inl2, *rest)
        return run

    def _local_points(self, orig):
        def run(*a, **kw):
            got = orig(*a, **kw)
            if got[0] is None:
                self.rec["no_local_points"] = True
            return got
        return run

    def _pose_optimize(self, orig):
        def run(*a, **kw):
            n = orig(*a, **kw)
            self.rec["pose_opt"].append(n)
            return n
        return run

    def _stage(self, name: str):
        def make(orig):
            def run(*a, **kw):
                before = len(self.rec["pose_opt"])
                ok = orig(*a, **kw)
                inl = self.rec["pose_opt"][before:]
                self.rec[name] = (bool(ok), inl[-1] if inl else None)
                return ok
            return run
        return make

    def gate(self) -> str:
        """The gate that dropped this frame, from what the frame recorded."""
        rec, parts = self.rec, []
        if "fused" in rec:
            n_cand, n_mm, n_inl1, n_inl2, need = rec["fused"]
            if not (n_cand >= 10 and n_mm >= 20 and n_inl1 >= 10):
                parts.append(f"_track_fused_finish motion-model gate (n_cand {n_cand} "
                             f">= 10, n_mm {n_mm} >= 20, n_inl1_map {n_inl1} >= 10) "
                             "failed, staged fallback")
            else:
                parts.append(f"_track_fused_finish inlier gate: n_inl2_map {n_inl2} "
                             f"< {need}")
        elif rec.get("no_local_points"):
            parts.append("_track_fused: no local map points, staged track()")
        for name, what in (("_track_reference_keyframe", "TrackReferenceKeyFrame"),
                           ("_track_local_map", "TrackLocalMap"),
                           ("_relocalize", "relocalization")):
            if name in rec:
                ok, inl = rec[name]
                res = ("ok" if ok else "failed") + (
                    f" at {inl} pose inliers" if inl is not None else
                    " before its pose optimization")
                parts.append(f"{what} {res}")
        return "; ".join(parts) or "no tracking stage ran"

    def loss_line(self) -> str:
        if self.first_loss is None:
            return "no frame lost after the initialization"
        return f"first frame not OK {self.first_loss[0]}: {self.first_loss[1]}"

    def _solve(self, *a, **kw):
        res = self._ba_solve(*a, **kw)
        if getattr(self._in_ba, "on", False):
            self._in_ba.cost = float(res.cost)
        return res

    def _scale(self) -> float:
        mp = self.slam.map
        kfs = np.flatnonzero(mp.kf_valid)[:2]
        if len(kfs) < 2:
            return float("nan")
        c = [-mp.kf_pose[k][:, :3].T @ mp.kf_pose[k][:, 3] for k in kfs]
        g = [self.gt[int(round(mp.kf_timestamp[k] * 30))] for k in kfs]
        g = [-T[:3, :3].T @ T[:3, 3] for T in g]
        return float(np.linalg.norm(c[1] - c[0]) / np.linalg.norm(g[1] - g[0]))

    def _run_ba(self, orig):
        def run(*a, **kw):
            n_local = sum(b["label"] != "init BA" for b in self.bas)
            if n_local >= self.N_BAS:
                return orig(*a, **kw)
            # the tracker's two-keyframe BA runs before the state is OK and
            # before the map is scaled to a median depth of 1
            label = "init BA" if self.init_frame is None else f"local BA {n_local + 1}"
            before = self._scale()
            self._in_ba.on, self._in_ba.cost = True, float("nan")
            try:
                out = orig(*a, **kw)
            finally:
                self._in_ba.on = False
            self.bas.append(dict(label=label, frame=self.frame, scale_before=before,
                                 scale_after=self._scale(), cost=self._in_ba.cost))
            return out
        return run


def lap_system(P, scene, sensor: str):
    """A fresh System for one corridor lap, as phase 8 builds it."""
    from orbslam2_tpu_torch.utils.profile_frame import bench_config
    cfg = bench_config(scene, P.Sensor.MONOCULAR if sensor == "mono" else P.Sensor.RGBD)
    return P.System(cfg, device="cuda", async_mapping=LOOP_ASYNC[sensor])


def check_loop(P, CK, synth, evaluation, scene, gt, items, sensor: str) -> dict:
    """Phase 8, one lap of the corridor through the sensor's entry point
    (track_rgbd, track_monocular), one frame at a time, with the mapper on
    its worker or inline (LOOP_ASYNC). Records the ATE just before the
    first loop correction and just after it (before the global BA it
    launches lands), applies the gates of tests/test_loop_closure_e2e.py and
    returns the lap's launches. A failure names the first frame that was not
    OK after the initialization and the gate that dropped it (LapRecorder)."""
    tag = f"phase 8 {sensor}"
    mono = sensor == "mono"
    async_mapping = LOOP_ASYNC[sensor]
    slam = lap_system(P, scene, sensor)
    recorder = LapRecorder(slam)
    lc = slam.loop_closer
    ates: dict = {}

    def ate_now():
        ts, est = slam.tracker.trajectory()
        if len(est) < 3:
            return float("nan")
        fids = np.round(np.asarray(ts) * 30).astype(int)
        return evaluation.ate_rmse(evaluation.camera_centers(est),
                                   evaluation.camera_centers(gt[fids]), with_scale=mono)

    orig_correct = lc._correct_loop

    def correct(kf, kc, s12, R12, t12):
        first = "before" not in ates
        if first:
            ates["before"], ates["frame"] = ate_now(), len(slam.tracker.frame_log)
        orig_correct(kf, kc, s12, R12, t12)
        if first:
            ates["after"] = ate_now()

    lc._correct_loop = correct
    CK.reset_launch_counts()
    t0 = time.perf_counter()
    tracked = slam.run_sequence(iter(items), pipelined=False)
    slam.shutdown()  # drains the mapper, then waits for the global BA and applies it
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts(CK)
    ates["end"] = ate_now()
    gba = slam.global_ba
    kind = "Sim(3)-aligned" if mono else "metric"
    for c in lc.closures:
        ms = ", ".join(f"{k} {v:.1f}" for k, v in c["ms"].items())
        print(f"{tag}: loop closed between keyframe {c['kf']} and keyframe {c['kc']}: "
              f"{c['bow_matches']} BoW matches, {c['ransac_inliers']} Sim(3) RANSAC "
              f"inliers, {c['guided_matches']} after SearchBySim3, {c['sim3_inliers']} "
              f"inliers after optimize_sim3 (scale {c['scale']:.4f}), {c['support']} "
              f"support matches, {c['fused']} points fused, essential graph "
              f"{c.get('n_edges')} edges with {c.get('n_loop_conn')} loop connections; "
              f"ms per part of LoopCloser.process: {ms}", flush=True)
    mapper = "on its worker" if async_mapping else "inline"
    print(f"{tag}: corridor-{len(items)}, mapper {mapper}: tracked {tracked}/{len(items)}, loops "
          f"{lc.n_loops_closed} {lc.loop_edges}, keyframes {slam.map.n_keyframes}, points "
          f"{slam.map.n_points}; {kind} ATE before the first correction "
          f"{100 * ates.get('before', float('nan')):.3f} cm (frame {ates.get('frame')}), "
          f"after it {100 * ates.get('after', float('nan')):.3f} cm, at the end (global BA "
          f"applied) {100 * ates['end']:.3f} cm"
          + f"; global BA: {gba.full_ba_idx} launched, "
          f"{gba.n_aborted} aborted, {gba.n_applied} applied, ms per chunk of the last "
          f"solve {[round(x, 1) for x in gba.chunk_ms]}, ms per whole solve "
          f"{[round(x, 1) for x in gba.solve_ms]}; {seconds:.1f} s in all; kernel "
          f"launches {launches}; initialized at frame {recorder.init_frame}, "
          f"{recorder.loss_line()}; card {T.card_line()}", flush=True)
    g = LOOP_GATES[sensor]
    fails = []
    if tracked < g["tracked"]:
        fails.append(f"tracked {tracked} (gate {g['tracked']})")
    if lc.n_loops_closed < 1 or slam.map_stats()["loops"] < 1:
        fails.append("no loop closed")
    if gba.n_applied < 1:
        fails.append("no global BA applied")
    if not ates["end"] < g["ate"]:
        fails.append(f"ATE {100 * ates['end']:.3f} cm (gate {100 * g['ate']:.0f} cm)")
    if launches["hamming_best2"].get("loop", 0) <= 0:
        fails.append("the loop closer never launched hamming_best2")
    # the closure's pose-graph optimization and the global BA's chunks
    for who in ("loop", "gba"):
        if launches["seg_sum"].get(who, 0) <= 0:
            fails.append(f"seg_sum never launched by {who}")
    if mono:
        pgo = lc.last_pgo_edges
        if lc.n_loop_fused <= 0 or pgo.get("n_loop_conn", 0) < 1:
            fails.append(f"fused {lc.n_loop_fused}, essential graph {pgo}")
        before = ates.get("before", float("nan"))
        if not (before > g["pre_loop"] and ates["end"] < before):
            fails.append(f"pre-loop ATE {100 * before:.3f} cm (gates: over "
                         f"{100 * g['pre_loop']:.1f} cm, above the final ATE)")
    if fails:
        raise AssertionError(f"{tag}: " + "; ".join(fails) + f"; initialized at frame "
                             f"{recorder.init_frame}, {recorder.loss_line()}")
    return dict(launches=launches)


def loop_lap(sensor: str) -> int:
    """Phase 8's lap of one sensor in a process of its own (`--loop-lap
    SENSOR`), beside the phases of main(). The kernels and the host
    library are loaded from build/, where main() built them. The last line
    is the lap's kernel launches as JSON."""
    import orbslam2_tpu_torch as P
    from orbslam2_tpu_torch import native
    from orbslam2_tpu_torch.io import synth
    from orbslam2_tpu_torch.ops import cuda_kernels as CK
    from orbslam2_tpu_torch.utils import cuda_timing, evaluation
    global T
    T = cuda_timing
    CK.build_kernels()
    if not native.available():
        raise RuntimeError("host map library (native/mapops.cpp) did not load")
    corridor = synth.make_corridor(seed=3)
    lap = synth.corridor_trajectory(LOOP_FRAMES, radius=LOOP_RADIUS)
    res = check_loop(P, CK, synth, evaluation, corridor, lap,
                     render_corridor(synth, corridor, lap), sensor)
    if sensor == LAP_REPEAT[0]:
        # the lap's start in fresh Systems, after the lap: every run the same
        t0 = time.perf_counter()
        if lap_start(*LAP_REPEAT, deterministic=False) != 0:
            raise AssertionError("phase 8b: the lap-start runs differ")
        print(f"phase 8b: {LAP_REPEAT[1]} lap-start runs of {LAP_REPEAT[2]} frames in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"lap": sensor, "launches": res["launches"]}), flush=True)
    return 0


def lap_start(sensor: str, runs: int, frames: int, deterministic: bool) -> int:
    """The start of phase 8's lap, `runs` times (`--lap-start SENSOR RUNS
    FRAMES [--deterministic]`; a default run never enters it): the lap's
    first `frames` frames, rendered once as phase 8 renders them, through
    fresh Systems built as phase 8 builds them, one frame at a time. One
    line a run: the initialization frame, the map scale and final cost of
    the first two local BAs, the first frame not OK after the
    initialization and the gate that dropped it (LapRecorder). With
    `deterministic`, the runs go under
    torch.use_deterministic_algorithms(True, warn_only=True) (and cuBLAS's
    fixed workspace), and the warnings collected are printed at the end.
    Each line ends with a hash of what the run recorded and of its
    trajectory; returns 1 when the runs differ, else 0."""
    import os
    import warnings
    from collections import Counter
    if deterministic:  # before the first cuBLAS call of the process
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import orbslam2_tpu_torch as P
    from orbslam2_tpu_torch import native
    from orbslam2_tpu_torch.io import synth
    from orbslam2_tpu_torch.ops import cuda_kernels as CK
    from orbslam2_tpu_torch.utils import cuda_timing
    global T
    T = cuda_timing
    CK.build_kernels()
    if not native.available():
        raise RuntimeError("host map library (native/mapops.cpp) did not load")
    corridor = synth.make_corridor(seed=3)
    lap = synth.corridor_trajectory(LOOP_FRAMES, radius=LOOP_RADIUS)
    items = render_corridor(synth, corridor, lap[:frames])
    mode = "deterministic algorithms" if deterministic else "default algorithms"
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    caught: Counter = Counter()
    lost = 0
    runs_seen: dict = {}
    for run in range(runs):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            slam = lap_system(P, corridor, sensor)
            rec = LapRecorder(slam, gt=lap)
            t0 = time.perf_counter()
            try:
                tracked = slam.run_sequence(iter(items), pipelined=False)
                slam.shutdown()
                torch.cuda.synchronize()
            finally:
                rec.detach()
        caught.update(str(w.message).splitlines()[0] for w in got)
        lost += rec.first_loss is not None
        bas = "; ".join(f"{b['label']} at frame {b['frame']}: scale {b['scale_before']:.4f}"
                        f" -> {b['scale_after']:.4f}, final cost {b['cost']:.6g}"
                        for b in rec.bas) or "no BA"
        seconds = time.perf_counter() - t0
        record = repr((rec.init_frame, rec.bas, rec.first_loss, tracked,
                       slam.map.n_keyframes)).encode() + slam.tracker.trajectory()[1].tobytes()
        digest = hashlib.sha1(record).hexdigest()[:12]
        runs_seen.setdefault(digest, []).append(run + 1)
        print(f"lap-start {sensor} run {run + 1}/{runs} ({mode}): initialized at frame "
              f"{rec.init_frame}; {bas}; {rec.loss_line()}; tracked {tracked}/{len(items)}, "
              f"keyframes {slam.map.n_keyframes}; {seconds:.1f} s; run {digest}",
              flush=True)
    print(f"lap-start {sensor}: {lost} of {runs} runs lost a frame after the "
          f"initialization ({mode}); {len(runs_seen)} distinct runs "
          f"{json.dumps(runs_seen)}; warnings: "
          f"{json.dumps(dict(caught)) if caught else 'none'}; card {T.card_line()}",
          flush=True)
    return 0 if len(runs_seen) == 1 else 1


def finish_lap(proc, out, deadline: float) -> dict:
    """Wait for a lap's process until `deadline` (perf_counter seconds),
    print its lines, and fail if it failed or is late. Returns its
    launches."""
    import subprocess
    try:
        proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    out.seek(0)
    lines = out.read().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if proc.returncode != 0:
        print(lines[-1] if lines else "", flush=True)
        raise AssertionError(f"phase 8: the lap's process exited {proc.returncode}")
    return json.loads(lines[-1])


def render_corridor(synth, scene, gt) -> list:
    """The lap's sequence items with depth, rendered once with 8 threads.
    The images stay float, as tests/test_loop_closure_e2e.py passes them
    (the System rounds them to gray u8)."""
    def item(i):
        return i / 30.0, {"image": synth.render_room(scene, gt[i], noise=LOOP_NOISE, seed=i),
                          "depth": synth.depth_room(scene, gt[i])}

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(item, range(len(gt))))


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


def write_settings(path, cfg, depth_factor: float = 0.0) -> None:
    """A settings YAML in the reference's format for `cfg`."""
    cam, orb = cfg.camera, cfg.orb
    lines = ["%YAML:1.0"] + [f"Camera.{k}: {getattr(cam, k)}" for k in (
        "fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3", "bf", "width", "height")]
    lines += [f"Camera.fps: {cfg.fps}", "Camera.RGB: 1", f"ThDepth: {cfg.th_depth}",
              f"ORBextractor.nFeatures: {orb.n_features}",
              f"ORBextractor.scaleFactor: {orb.scale_factor}",
              f"ORBextractor.nLevels: {orb.n_levels}",
              f"ORBextractor.iniThFAST: {orb.ini_th_fast}",
              f"ORBextractor.minThFAST: {orb.min_th_fast}"]
    if depth_factor:
        lines.append(f"DepthMapFactor: {depth_factor}")
    path.write_text("\n".join(lines) + "\n")


def write_tum_rgbd(root, items) -> None:
    """The sequence as a TUM RGB-D directory: colour PNGs with equal
    channels, u16 depth at factor 5000, rgb.txt, depth.txt and the
    associations."""
    from orbslam2_tpu_torch.io.png import write_png
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rgb, dep, assoc = ["# color images"], ["# depth maps"], []
    for ts, d in items:
        name = f"{ts:.6f}.png"
        write_png(root / "rgb" / name, np.repeat(d["image"][:, :, None], 3, axis=2))
        write_png(root / "depth" / name,
                  np.clip(np.round(d["depth"] * 5000.0), 0, 65535).astype(np.uint16))
        rgb.append(f"{ts:.6f} rgb/{name}")
        dep.append(f"{ts:.6f} depth/{name}")
        assoc.append(f"{ts:.6f} rgb/{name} {ts:.6f} depth/{name}")
    for fname, lines in (("rgb.txt", rgb), ("depth.txt", dep), ("associations.txt", assoc)):
        (root / fname).write_text("\n".join(lines) + "\n")


def write_kitti_stereo(root, items) -> None:
    """The sequence as a KITTI odometry directory: image_0, image_1,
    times.txt."""
    from orbslam2_tpu_torch.io.png import write_png
    for cam, key in (("image_0", "image"), ("image_1", "right")):
        (root / cam).mkdir(parents=True)
        for i, (_, d) in enumerate(items):
            write_png(root / cam / f"{i:06d}.png", d[key])
    (root / "times.txt").write_text("\n".join(f"{ts:.6e}" for ts, _ in items) + "\n")


def check_dataset(CK, evaluation, traj_io, tag: str, argv: list, out, gt,
                  sensor: str) -> dict:
    """One run of run_dataset.main (the default device) over a directory:
    at least 90% of the frames tracked and a metric ATE of at most 3 cm
    from CameraTrajectory.txt, KeyFrameTrajectory.txt (and for KITTI
    CameraTrajectoryKITTI.txt) well formed, and the tracker's launches: 1
    hamming_matrix and, RGB-D, 1 hamming_best2 or, stereo, 2 a frame."""
    import contextlib
    import io
    from orbslam2_tpu_torch import run_dataset
    buf = io.StringIO()
    CK.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = run_dataset.main(argv + ["--out-dir", str(out)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts(CK)
    for line in buf.getvalue().splitlines():
        if line.strip():
            print(f"{tag}: run_dataset: {line}", flush=True)
    if rc != 0:
        raise AssertionError(f"{tag}: run_dataset exited {rc}")
    ts, centres, _ = traj_io.load_tum(out / "CameraTrajectory.txt")
    fids = np.round(ts * 30).astype(int)
    ate = evaluation.ate_rmse(centres, evaluation.camera_centers(gt[fids]),
                              with_scale=False)
    kf = np.atleast_2d(np.loadtxt(out / "KeyFrameTrajectory.txt"))
    fails = []
    if not (kf.shape[0] >= 1 and kf.shape[1] == 8 and np.isfinite(kf).all()):
        fails.append(f"KeyFrameTrajectory.txt of shape {kf.shape}")
    if sensor == "stereo":
        kt = np.atleast_2d(np.loadtxt(out / "CameraTrajectoryKITTI.txt"))
        R = kt.reshape(-1, 3, 4)[:, :, :3]
        if not (kt.shape == (len(ts), 12) and np.isfinite(kt).all() and np.allclose(
                R @ R.transpose(0, 2, 1), np.eye(3), atol=1e-4)):
            fails.append(f"CameraTrajectoryKITTI.txt of shape {kt.shape}")
    a = launches["hamming_matrix"].get("tracker", 0)
    b = launches["hamming_best2"].get("tracker", 0)
    per_frame = 2 if sensor == "stereo" else 1
    print(f"{tag}: {sensor} run_dataset over {len(gt)} frames from disk: tracked "
          f"{len(ts)}/{len(gt)}, metric ATE {ate * 100:.3f} cm, {kf.shape[0]} keyframes "
          f"in KeyFrameTrajectory.txt; {seconds:.1f} s in all; kernel launches "
          f"{launches}", flush=True)
    if len(ts) < GATES[sensor][0] * len(gt) or not ate <= GATES[sensor][1]:
        fails.append(f"tracked {len(ts)}/{len(gt)}, ATE {ate * 100:.3f} cm (gates: "
                     f"{100 * GATES[sensor][0]:.0f}%, {100 * GATES[sensor][1]:.0f} cm)")
    if a < len(ts) - 1 or b < per_frame * a:
        fails.append(f"{a} hamming_matrix and {b} hamming_best2 launches by the tracker "
                     f"over {len(ts)} tracked frames (gate: 1 and {per_frame} a frame)")
    if fails:
        raise AssertionError(f"{tag}: " + "; ".join(fails))
    return dict(launches=launches)


def check_checkpoint(P, CK, synth, scene, gt, saved, work) -> dict:
    """Phase 9a: `saved`, the System that phase 7 left on rgbd-sweep-120,
    saves its map into `work`; a fresh System with async mapping loads it.
    The keyframe and point counts are the saved ones, the tracker is LOST,
    every keyframe is registered (bow_assign launched under "checkpoint");
    then the viewpoint of sweep frame RGBD_REVISIT, rendered with new seeds,
    relocalizes within RELOC_TRIES frames within 5 cm and 1 degree of the
    truth, and the next RELOC_ON_FRAMES frames all track."""
    from orbslam2_tpu_torch.utils.profile_frame import bench_config
    tag = "phase 9a"
    path = work / "sweep120.npz"
    expect = {"keyframes": saved.map.n_keyframes, "points": saved.map.n_points}
    t0 = time.perf_counter()
    saved.save_map(path)
    save_ms = (time.perf_counter() - t0) * 1e3
    mb = path.stat().st_size / 2 ** 20
    print(f"{tag}: save_map of rgbd-sweep-120 after phase 7 ({expect['keyframes']} "
          f"keyframes, {expect['points']} points): {save_ms:.1f} ms, {mb:.2f} MB",
          flush=True)
    slam = P.System(bench_config(scene, P.Sensor.RGBD), device="cuda",
                    async_mapping=True, use_viewer=True, viewer_port=0)
    CK.reset_launch_counts()
    t0 = time.perf_counter()
    slam.load_map(path)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts(CK)
    live = slam.map.kf_ids
    counts = (slam.map.n_keyframes, slam.map.n_points)
    registered = bool(slam.kf_db.registered[live].all())
    print(f"{tag}: load_map into a fresh System (async mapping): {load_ms:.1f} ms; "
          f"keyframes {counts[0]}, points {counts[1]} (saved {expect['keyframes']}, "
          f"{expect['points']}); state {slam.tracking_state.name}; every keyframe "
          f"registered: {registered}; kernel launches {launches}", flush=True)
    if (counts != (expect["keyframes"], expect["points"])
            or slam.tracking_state.name != "LOST" or not registered
            or launches["bow_assign"].get("checkpoint", 0) != len(live)):
        raise AssertionError(f"{tag}: the loaded System: counts {counts}, state "
                             f"{slam.tracking_state.name}, registered {registered}, "
                             f"launches {launches}")
    world = np.linalg.inv(_se3(gt[0]))  # the map's world is the first camera
    t = len(gt) / 30.0
    CK.reset_launch_counts()
    pose = None
    for j in range(RELOC_TRIES):
        img = _u8(synth, scene, gt[RGBD_REVISIT], CHECKPOINT_REVISIT_SEEDS + j)
        pose = slam.track_rgbd(img, synth.depth_room(scene, gt[RGBD_REVISIT]), t)
        t += 1 / 30.0
        if pose is not None:
            break
    _print_attempts(tag, slam.relocalizer, 0)
    if pose is None:
        raise AssertionError(f"{tag}: no relocalization within {RELOC_TRIES} frames")
    truth = (_se3(gt[RGBD_REVISIT]) @ world)[:3]
    cm = 100 * np.linalg.norm(pose[:, :3].T @ pose[:, 3] - truth[:, :3].T @ truth[:, 3])
    deg = _rot_deg(pose[:, :3].astype(np.float64) @ truth[:, :3].T)
    ok = 0
    for i in range(RGBD_REVISIT + 1, RGBD_REVISIT + 1 + RELOC_ON_FRAMES):
        img = _u8(synth, scene, gt[i], CHECKPOINT_REVISIT_SEEDS + 100 + i)
        ok += slam.track_rgbd(img, synth.depth_room(scene, gt[i]), t) is not None
        t += 1 / 30.0
    i = RGBD_REVISIT + 1 + RELOC_ON_FRAMES
    check_viewer(slam, lambda: slam.track_rgbd(
        _u8(synth, scene, gt[i], CHECKPOINT_REVISIT_SEEDS + 100 + i),
        synth.depth_room(scene, gt[i]), t))
    on = launch_counts(CK)
    print(f"{tag}: relocalized against the loaded map on revisit frame {j + 1} of "
          f"{RELOC_TRIES} at the viewpoint of sweep frame {RGBD_REVISIT}: {cm:.3f} cm "
          f"and {deg:.4f} degrees from the ground truth; then tracked {ok}/"
          f"{RELOC_ON_FRAMES}; kernel launches {on}", flush=True)
    if cm > RELOC_GATE_CM or deg > RELOC_GATE_DEG or ok != RELOC_ON_FRAMES:
        raise AssertionError(f"{tag}: {cm:.2f} cm, {deg:.3f} degrees, tracked {ok}/"
                             f"{RELOC_ON_FRAMES} (gates: {RELOC_GATE_CM} cm, "
                             f"{RELOC_GATE_DEG} degree, all)")
    return dict(launches=_add_launches(launches, on))


def check_viewer(slam, next_frame) -> None:
    """Phase 9a's viewer checks on `slam`, a System with the viewer on that
    has tracked frames; `next_frame()` tracks one more. Every route, the
    stats against map_stats() plus the menu, the toggles and localization
    mode through /set, /reset last (the next frame applies it: a new map
    with its first keyframe), then shutdown() (the mapper drained, the
    viewer stopped). Prints the render ms."""
    import urllib.error
    import urllib.request
    tag = "phase 9a viewer"
    v = slam.viewer

    def get(route):
        with urllib.request.urlopen(f"http://127.0.0.1:{v.port}{route}", timeout=30) as r:
            return r.status, r.read()

    slam.wait_for_mapping()
    deadline = time.perf_counter() + VIEWER_WAIT_S
    while not (v._map_png and v._frame_png) and time.perf_counter() < deadline:
        time.sleep(0.1)
    fails = []
    pages = {route: get(route) for route in ("/", "/map.png", "/frame.png", "/stats.json")}
    if pages["/"][0] != 200 or b"orbslam2_tpu" not in pages["/"][1]:
        fails.append("the page")
    for route in ("/map.png", "/frame.png"):
        if pages[route][0] != 200 or pages[route][1][:8] != b"\x89PNG\r\n\x1a\n":
            fails.append(f"{route}: {pages[route][0]} {pages[route][1][:8]!r}")
    stats = json.loads(pages["/stats.json"][1])
    menu = dict(follow=1, points=1, graph=1, localization=0)
    if stats != {**slam.map_stats(), "menu": menu}:
        fails.append(f"/stats.json {stats} against map_stats() {slam.map_stats()}")
    try:
        get("/nothing")
        fails.append("no 404 for an unknown route")
    except urllib.error.HTTPError as e:
        if e.code != 404:
            fails.append(f"an unknown route gave {e.code}")
    get("/set?localization=1&points=0&graph=0&follow=0")
    flipped = (slam.localization_mode_active, v.show_points, v.show_graph, v.follow)
    get("/set?localization=0")
    back = slam.localization_mode_active
    if flipped != (True, False, False, False) or back:
        fails.append(f"toggles (localization, points, graph, follow) {flipped}, "
                     f"localization after /set?localization=0 {back}")
    ms = dict(v.render_ms)
    kfs = slam.map.n_keyframes
    get("/reset")
    pending, old = slam._reset_pending, slam.map
    next_frame()
    reset = (pending, slam._reset_pending, slam.map is not old, slam.map.n_keyframes)
    slam.shutdown()
    print(f"{tag}: port {v.port}: /, /map.png ({len(pages['/map.png'][1])} bytes), "
          f"/frame.png ({len(pages['/frame.png'][1])} bytes), /stats.json {stats}; "
          f"render ms on the host: map {ms.get('map', float('nan')):.1f} ({kfs} keyframes"
          f"), frame {ms.get('frame', float('nan')):.1f}; renders dropped {v.n_dropped} "
          f"({v.last_error}); toggles flipped and back; /reset (pending, pending after "
          f"the next frame, a new map, its keyframes) {reset}; viewer after shutdown "
          f"{slam.viewer}", flush=True)
    if reset != (True, False, True, 1):
        fails.append(f"/reset: {reset}")
    if slam.viewer is not None or v._render_thread.is_alive():
        fails.append("shutdown() left the viewer running")
    if "map" not in ms or "frame" not in ms:
        fails.append(f"render ms {ms}")
    if fails:
        raise AssertionError(f"{tag}: " + "; ".join(fails))


def check_endurance_smoke(CK) -> dict:
    """Phase 10e: endurance_run.main over ENDURANCE_SMOKE in this process.
    Its JSON line against the JAX script's keys and this process's launch
    counts; its gates. Returns its launches."""
    import contextlib
    import io
    from orbslam2_tpu_torch import endurance_run
    tag = "phase 10e"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = endurance_run.main(ENDURANCE_SMOKE)
    seconds = time.perf_counter() - t0
    launches = launch_counts(CK)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    for line in lines:
        print(f"{tag}: endurance_run: {line}", flush=True)
    if rc != 0:
        raise AssertionError(f"{tag}: endurance_run exited {rc}")
    rec = json.loads(lines[-1])
    print(f"{tag}: endurance_run {' '.join(ENDURANCE_SMOKE)}: tracked {rec['tracked']}/"
          f"{rec['frames']}, metric ATE {100 * rec['ate_m']:.3f} cm, keyframes "
          f"{rec['keyframes']} ({rec['kf_created_total']} made), median {rec['median_ms']}"
          f" ms a frame, {seconds:.1f} s in all; kernel launches {launches}", flush=True)
    fails = []
    if set(rec) != set(ENDURANCE_KEYS) | {"launches", "max_keyframes"}:
        fails.append(f"keys {sorted(rec)}")
    if rec["launches"] != launches or rec["device"] != T.card_line():
        fails.append(f"launches {rec['launches']}, device {rec['device']}")
    if rec["tracked"] < ENDURANCE_MIN_TRACKED:
        fails.append(f"tracked {rec['tracked']} (gate {ENDURANCE_MIN_TRACKED})")
    made = rec["kf_created_total"]
    if (launches["hamming_matrix"].get("tracker", 0) <= 0
            or launches["hamming_best2"].get("tracker", 0) <= 0
            or launches["hamming_best2"].get("mapper", 0) <= 0
            or sum(launches["bow_assign"].values()) < made):
        fails.append(f"launches {launches} for {made} keyframes made")
    if fails:
        raise AssertionError(f"{tag}: " + "; ".join(fails))
    return dict(launches=launches)


def check_merge(P, CK, synth, evaluation, scene, gt, sys_a) -> dict:
    """Phase 9b: session A, the System of phase 4's synchronous sweep
    (frames 0-59), and session B, a new System over frames MERGE_B of the
    same sweep (its world its own first camera), both with the mapper
    inline; B's map merged into A's. Gates: an alignment found at scale 1
    (RGB-D), A holds n_a + n_b keyframes from both halves, hamming_best2
    launched under "merge", the merged keyframes' metric ATE under
    MERGE_ATE_GATE."""
    from orbslam2_tpu_torch import map_merge as MM
    tag = "phase 9b"
    sys_b = P.System(sys_a.cfg, device="cuda")
    t0 = time.perf_counter()
    tracked = 0
    for i in range(*MERGE_B):
        img = _u8(synth, scene, gt[i], i)
        tracked += sys_b.track_rgbd(img, synth.depth_room(scene, gt[i]), i / 30.0) is not None
    b_seconds = time.perf_counter() - t0
    n_a, n_b = sys_a.map.n_keyframes, sys_b.map.n_keyframes
    find, found_ms = MM.find_cross_map_alignment, []

    def timed_find(*args, **kw):
        t = time.perf_counter()
        out = find(*args, **kw)
        found_ms.append((time.perf_counter() - t) * 1e3)
        return out

    MM.find_cross_map_alignment = timed_find
    CK.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        W = MM.merge_maps(sys_a, sys_b.map)
    finally:
        MM.find_cross_map_alignment = find
    torch.cuda.synchronize()
    merge_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts(CK)
    mp = sys_a.map
    ids = mp.kf_ids
    fids = np.round(mp.kf_timestamp[ids] * 30).astype(int)
    ate = evaluation.ate_rmse(evaluation.camera_centers(mp.kf_pose[ids]),
                              evaluation.camera_centers(gt[fids]), with_scale=False)
    n = MERGE_B[1] - MERGE_B[0]
    print(f"{tag}: session B tracked {tracked}/{n} in {b_seconds:.1f} s; keyframes A "
          f"{n_a}, B {n_b}; alignment "
          + (f"from keyframe pair ({W['ka']}, {W['kb']}), {W['n_inliers']} RANSAC "
             f"inliers, scale {W['s']:.4f}" if W else "not found")
          + f"; ms: alignment {found_ms[-1] if found_ms else float('nan'):.1f}, whole "
          f"merge {merge_ms:.1f}; merged keyframes {mp.n_keyframes} (frames "
          f"{fids.tolist()}), points {mp.n_points}; metric ATE of the merged keyframes "
          f"{100 * ate:.3f} cm (gate {100 * MERGE_ATE_GATE:.3f}); kernel launches "
          f"{launches}", flush=True)
    fails = []
    if W is None or W["s"] != 1.0:
        fails.append(f"alignment {W}")
    # keyframes of both halves: frames only A saw and frames only B saw
    if (mp.n_keyframes != n_a + n_b or fids.min() >= MERGE_B[0]
            or fids.max() < SYNC_SWEEP_FRAMES):
        fails.append(f"{mp.n_keyframes} keyframes of frames {fids.tolist()}")
    if launches["hamming_best2"].get("merge", 0) <= 0:
        fails.append("the merge never launched hamming_best2")
    if not ate <= MERGE_ATE_GATE:
        fails.append(f"ATE {100 * ate:.3f} cm")
    if fails:
        raise AssertionError(f"{tag}: " + "; ".join(fails))
    return dict(launches=launches)


def check_datasets(P, CK, synth, evaluation, scene, orbit, work) -> list:
    """Phase 9c: rgbd-orbit-48 as a TUM RGB-D directory and stereo-orbit-48
    as a KITTI one, each through run_dataset.main (check_dataset)."""
    from orbslam2_tpu_torch.io import trajectory as traj_io
    from orbslam2_tpu_torch.utils.profile_frame import bench_config
    runs = []
    for sensor, mode, write in (("rgbd", "rgbd_tum", write_tum_rgbd),
                                ("stereo", "stereo_kitti", write_kitti_stereo)):
        root = work / mode
        write(root, render_sequence(synth, scene, "orbit", orbit, sensor))
        cfg = bench_config(scene, P.Sensor.RGBD if sensor == "rgbd" else P.Sensor.STEREO)
        write_settings(work / f"{mode}.yaml", cfg, 5000.0 if sensor == "rgbd" else 0.0)
        argv = [mode, str(work / f"{mode}.yaml"), str(root)]
        if sensor == "rgbd":
            argv.append(str(root / "associations.txt"))
        runs.append(check_dataset(CK, evaluation, traj_io, "phase 9c", argv,
                                  work / f"{mode}_out", orbit, sensor))
    return runs


def check_graft_entry(CK) -> dict:
    """Phase 10a: graft_entry.entry(), the per-frame tracking_step program on
    a 480x640 frame against a 1024-point map, on the card against the same
    entry on the CPU: pose within 1e-4, inliers within 2; hamming_best2
    launched under its caller "entry". Returns the launches."""
    from orbslam2_tpu_torch import graft_entry as G
    tag = "phase 10a"
    fn, args = G.entry()
    CK.reset_launch_counts()
    with CK.launches_counted_as("entry"):
        T_card, n_card = fn(*args)
        torch.cuda.synchronize()
    launches = launch_counts(CK)
    with CK.launches_counted_as("entry"):
        ms = T.time_ms(lambda: fn(*args), reps=5)
    fn_cpu, args_cpu = G.entry(device="cpu")
    T_cpu, n_cpu = fn_cpu(*args_cpu)
    dT = float((T_card.cpu() - T_cpu).abs().max())
    print(f"{tag}: graft_entry.entry() on the card: {int(n_card)} inliers (CPU "
          f"{int(n_cpu)}), pose within {dT:.2e} of the CPU's; {ms:.2f} ms per call "
          f"(CUDA events, back-to-back); kernel launches {launches}", flush=True)
    if not (dT <= 1e-4 and abs(int(n_card) - int(n_cpu)) <= 2
            and launches["hamming_best2"].get("entry", 0) > 0):
        raise AssertionError(f"{tag}: pose {dT:.2e} (gate 1e-4), inliers {int(n_card)} "
                             f"against {int(n_cpu)} (gate 2), launches {launches}")
    return dict(launches=launches)


def start_dryrun(argv: list):
    """Start `python3 -m orbslam2_tpu_torch.graft_entry --dryrun N ...` (phases
    10b and 10c) in a process of its own, its output in a temporary file;
    finish_dryrun waits for it."""
    import subprocess
    import tempfile
    out = tempfile.TemporaryFile(mode="w+")
    argv = ["-m", "orbslam2_tpu_torch.graft_entry", *argv]
    proc = subprocess.Popen([sys.executable, *argv], stdout=out, stderr=subprocess.STDOUT,
                            text=True)
    return proc, out, argv, time.perf_counter()


def finish_dryrun(tag: str, proc, out, argv: list, t0: float) -> dict:
    """Wait for a dry run of start_dryrun, with its gates
    (graft_entry.dryrun_multichip): its lines printed under `tag`, a
    non-zero exit or 600 s from its start fails the run. Returns its last
    line, the numbers of rank 0."""
    import subprocess
    try:
        proc.wait(timeout=max(1.0, 600 - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    out.seek(0)
    lines = out.read().splitlines()
    out.close()
    for line in lines:
        print(f"{tag}: {line}", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"{tag}: {' '.join(argv)} exited {proc.returncode}")
    print(f"{tag}: {' '.join(argv)} took {time.perf_counter() - t0:.1f} s (beside 10e)",
          flush=True)
    return json.loads(lines[-1])


def gba_rank(rank: int, store: str, map_path: str) -> int:
    """Phase 10c's global BA, one of 2 gloo ranks on cuda:0 (`--gba-rank R
    STORE MAP`). Rank 0 loads the map phase 7 left into a GlobalBA forced
    onto the distributed branch (dist_min_cams = 1), runs it on its thread
    and stream and applies it; then single-process GlobalBAs on fresh loads
    of the same map: the solve pinned to CG, as the distributed branch pins
    it, on the map as saved and with every point nudged one float32 ulp up
    and down (GBA_CG_NUDGES), and last the GlobalBA's own choice of solve.
    Rank 1 serves the chunks (multihost.serve_global_ba). Rank 0's last line
    is JSON: the distributed result's gap from the default single-process
    one and from the CG one on the map as saved, and the spread of the
    single-process results (the largest gap between two of them), the
    float32 resolution of this map's solve. Each gap compares the
    rotations, the translations and the final costs (relative)."""
    import torch.distributed as dist
    from orbslam2_tpu_torch import Sensor
    from orbslam2_tpu_torch.global_ba import GlobalBA
    from orbslam2_tpu_torch.io import synth
    from orbslam2_tpu_torch.map.mapstate import MapState
    from orbslam2_tpu_torch.ops import ba as BA
    from orbslam2_tpu_torch.parallel import multihost
    from orbslam2_tpu_torch.utils.profile_frame import bench_config
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2,
                            rank=rank)
    try:
        if rank == 1:
            served = multihost.serve_global_ba(None, "cuda:0")
            print(json.dumps({"rank": 1, "served": served}), flush=True)
            return 0
        cfg = bench_config(synth.make_room(seed=0), Sensor.RGBD)
        cam = cfg.camera
        intr = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)

        def cg_solver(prob):
            return (lambda p, i1, i2: BA.ba_solve(p, *intr, iters1=i1, iters2=i2,
                                                  solver="cg")), 1

        maps, gbas, seen, costs = [], [], [], []
        runs = ([("dist", None)] + [("cg", nudge) for nudge in GBA_CG_NUDGES]
                + [("default", None)])
        for kind, nudge in runs:
            mp = MapState.load(map_path, cfg)
            if nudge is not None:
                mp.pt_xyz[:] = np.nextafter(mp.pt_xyz, np.float32(nudge))
            gba = GlobalBA(cfg, mp, device="cuda")
            gba.dist_min_cams = 1 if kind == "dist" else 1 << 30
            solver_fn = cg_solver if kind == "cg" else gba._solver_fn

            def probe(prob, solver_fn=solver_fn):
                solve, n = solver_fn(prob)
                seen.append(n)

                def solve_kept(*args):
                    res = solve(*args)
                    costs[-1] = res.cost
                    return res
                return solve_kept, n

            costs.append(None)
            gba._solver_fn = probe
            gba.launch(fixed_kf=int(min(mp.kf_ids)))
            if not gba.wait_and_apply(timeout=300):
                raise AssertionError("phase 10c: a global BA was not applied")
            maps.append(mp)
            gbas.append(gba)
        multihost.header(None, "cuda:0", multihost.SHUTDOWN)
        ids = maps[0].kf_ids
        costs = [float(c) for c in costs]

        def gap(a, b) -> list:
            """The largest rotation and translation difference of two runs'
            poses, and their final costs' difference over the second's."""
            d = np.abs(maps[a].kf_pose[ids] - maps[b].kf_pose[ids])
            c = abs(costs[a] - costs[b]) / costs[b]
            return [float(d[..., :3].max()), float(d[..., 3].max()), c]

        one = range(1, len(maps))
        pairs = [gap(a, b) for a in one for b in one if a < b]
        print(json.dumps({"rank": 0, "dispatch": seen, "keyframes": len(ids),
                          "solve_ms": [g.solve_ms[-1] for g in gbas],
                          "chunk_ms": [g.chunk_ms for g in gbas], "cost": costs,
                          "gap": gap(0, len(maps) - 1), "gap_cg": gap(0, 1),
                          "spread": np.max(pairs, axis=0).tolist()}), flush=True)
        return 0
    finally:
        dist.destroy_process_group()


def check_gba_ranks(map_path, store) -> dict:
    """Phase 10c, the global BA's distributed branch at 2 gloo ranks on the
    card (gba_rank): dispatched over 2 ranks, rank 1 in all 5 chunks; the
    applied rotations, translations and final cost within max(1e-4, 2 x
    spread) of the default single-process GlobalBA's (the dense Schur step
    at this size), where the spread is the largest difference between two
    single-process results: the default one and those pinned to CG on the
    map as saved and nudged one float32 ulp. The solve stops where float32
    costs no longer order its LM steps, so on some maps a rounding-level
    change of its input, or the CG's truncation, moves the poses by 2e-4 m
    (a sweep map on the CPU), and on the card index_add_'s atomic order
    makes such changes: a fixed 1e-4 gate failed there."""
    import subprocess
    import tempfile
    tag = "phase 10c gba"
    t0 = time.perf_counter()
    procs = []
    for rank in (0, 1):
        out = tempfile.TemporaryFile(mode="w+")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, "--gba-rank", str(rank), str(store), str(map_path)],
            stdout=out, stderr=subprocess.STDOUT, text=True), out))
    last = {}
    try:
        for rank, (proc, out) in enumerate(procs):
            proc.wait(timeout=max(1.0, 600 - (time.perf_counter() - t0)))
            out.seek(0)
            lines = out.read().splitlines()
            for line in lines:
                print(f"{tag} rank {rank}: {line}", flush=True)
            if proc.returncode != 0:
                raise AssertionError(f"{tag}: rank {rank} exited {proc.returncode}")
            last[rank] = json.loads(lines[-1])
    finally:
        for proc, out in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            out.close()
    r = last[0]
    gate = [max(1e-4, 2 * s) for s in r["spread"]]
    g, s, c = r["gap"], r["spread"], r["gap_cg"]
    print(f"{tag}: 2 ranks sharing cuda:0 over gloo, dispatch {r['dispatch']} (rank "
          f"count of the distributed GBA, the single-process CG ones on the map as "
          f"saved and nudged, the default one), rank 1 served {last[1]['served']} "
          f"chunks; solve ms {r['solve_ms']}, chunk ms {r['chunk_ms']}, final cost "
          f"{r['cost']}; the distributed result of {r['keyframes']} keyframes within "
          f"{g[0]:.2e} (rotation), {g[1]:.2e} m and {g[2]:.2e} (cost) of the default "
          f"single-process GBA's ({c[0]:.2e}, {c[1]:.2e} m, {c[2]:.2e} of the CG one), "
          f"the single-process results' spread {s[0]:.2e}, {s[1]:.2e} m and "
          f"{s[2]:.2e} (gates {gate[0]:.2e}, {gate[1]:.2e}, {gate[2]:.2e}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not (r["dispatch"] == [2] + [1] * (len(GBA_CG_NUDGES) + 1)
            and last[1]["served"] == [5] and all(x <= y for x, y in zip(g, gate))):
        raise AssertionError(f"{tag}: dispatch {r['dispatch']}, served "
                             f"{last[1]['served']}, rotation, translation, cost "
                             f"{g[0]:.2e} / {g[1]:.2e} / {g[2]:.2e} (gates "
                             f"{gate[0]:.2e} / {gate[1]:.2e} / {gate[2]:.2e})")
    return r


def check_merged_dist_ba(P, evaluation, sys_a, gt, work) -> dict:
    """Phase 10d, the card's counterpart of tests/test_merged_map_dist_ba.py:
    the map 9b merged, its global BA problem through dist_ba_solve over a
    1-rank NCCL group against ba_solve(solver="cg"), both 2 + 3 LM
    iterations of 12 CG steps. Gates: poses within 1e-3, inliers above 70%
    of the valid edges, and after writing the distributed result back the
    merged keyframes' metric ATE under 9b's gate."""
    import torch.distributed as dist
    from orbslam2_tpu_torch.local_mapping import build_ba_problem
    from orbslam2_tpu_torch.ops import ba as BA
    from orbslam2_tpu_torch.ops import features as FT
    from orbslam2_tpu_torch.parallel import dist_ba
    tag = "phase 10d"
    mp, cfg = sys_a.map, sys_a.cfg
    cam = cfg.camera
    intr = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
    kw = dict(iters1=2, iters2=3, cg_iters=12)
    kfs = [int(k) for k in mp.kf_ids]
    dist.init_process_group("nccl", init_method=f"file://{work}/nccl_store",
                            world_size=1, rank=0, device_id=torch.device("cuda", 0))
    try:
        prob, meta = build_ba_problem(mp, cfg, FT.sigma2_per_octave(cfg.orb), kfs,
                                      fixed=[kfs[0]], device=torch.device("cuda"))
        colls = dist_ba.collectives(prob, None, *intr)
        ms = {}
        t0 = time.perf_counter()
        res = dist_ba.dist_ba_solve(prob, None, *intr, **kw)
        torch.cuda.synchronize()
        ms["1 NCCL rank"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ref = BA.ba_solve(prob, *intr, solver="cg", **kw)
        torch.cuda.synchronize()
        ms["ba_solve"] = (time.perf_counter() - t0) * 1e3
    finally:
        dist.destroy_process_group()
    dT = float((res.cam_T - ref.cam_T).abs().max())
    n_valid = int(prob.e_valid.sum())
    inl = int((res.e_inlier & prob.e_valid).sum())
    cam_T = res.cam_T.cpu().numpy()
    for i, k in enumerate(meta["cam_arr"]):
        if int(k) != kfs[0]:
            mp.kf_pose[int(k)] = cam_T[i]
    ids = mp.kf_ids
    fids = np.round(mp.kf_timestamp[ids] * 30).astype(int)
    ate = evaluation.ate_rmse(evaluation.camera_centers(mp.kf_pose[ids]),
                              evaluation.camera_centers(gt[fids]), with_scale=False)
    print(f"{tag}: the merged map's BA (C={prob.cam_T.shape[0]} P={prob.pts.shape[0]} "
          f"E={prob.e_cam.shape[0]}, {len(kfs)} keyframes) over 1 NCCL rank, collectives "
          f"{colls}: poses within {dT:.2e} of ba_solve(solver='cg'), inliers {inl}/"
          f"{n_valid} valid, cost {float(res.cost):.6g} (ba_solve {float(ref.cost):.6g});"
          f" ms {ms}; merged keyframes' metric ATE after the write-back {100 * ate:.3f} "
          f"cm (gate {100 * MERGE_ATE_GATE:.3f})", flush=True)
    if not (dT < 1e-3 and inl > 0.7 * n_valid and ate <= MERGE_ATE_GATE):
        raise AssertionError(f"{tag}: poses {dT:.2e} (gate 1e-3), inliers {inl}/{n_valid} "
                             f"(gate 70%), ATE {100 * ate:.3f} cm")
    return dict(ms=ms, colls=colls)


def _add_launches(*runs: dict) -> dict:
    """The launches of several runs, summed by kernel and caller."""
    total: dict = {}
    for r in runs:
        for kernel, by in r.items():
            into = total.setdefault(kernel, {})
            for who, n in by.items():
                into[who] = into.get(who, 0) + n
    return total


def kernel_checks() -> int:
    """Phases 3 and 3c without their timings: every exactness and guard-row
    check of the three kernels (the room frames aside). main() runs it in a
    subprocess under CUDA_LAUNCH_BLOCKING=1, so that a launch that faults
    is named by the call that made it."""
    from orbslam2_tpu_torch.io.vocabulary import default_vocabulary
    from orbslam2_tpu_torch.ops import ba as BA
    from orbslam2_tpu_torch.ops import cuda_kernels as CK
    from orbslam2_tpu_torch.ops import pose_graph as PG
    from orbslam2_tpu_torch.utils import probe_hamming as PH
    CK.build_kernels()
    lib, twotrip = PH.probe_lib(), PH.twotrip_lib()
    voc = default_vocabulary()
    check_hamming_matrix(CK, PH, lib, 0.0, timed=False)
    check_hamming_best2(CK, PH, lib, 0.0, voc, timed=False)
    check_bow_assign(PH, lib, twotrip, voc, {}, timed=False)
    check_seg_sum(CK, PH, BA, PG, lib, timed=False)
    torch.cuda.synchronize()
    return 0


def blocking_kernel_checks() -> None:
    """kernel_checks() in a subprocess under CUDA_LAUNCH_BLOCKING=1; its
    lines are printed, and a non-zero exit fails the script."""
    import os
    import subprocess
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, __file__, "--kernel-checks"],
                          env={**os.environ, "CUDA_LAUNCH_BLOCKING": "1"},
                          capture_output=True, text=True, timeout=600)
    for line in (proc.stdout + proc.stderr).splitlines():
        print(f"phase 3 (CUDA_LAUNCH_BLOCKING=1): {line}", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"the kernel checks under CUDA_LAUNCH_BLOCKING=1 exited "
                             f"{proc.returncode}")
    print(f"phase 3: the kernel checks under CUDA_LAUNCH_BLOCKING=1 passed in a "
          f"subprocess in {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("phase 1: no CUDA device: this script runs only on the card",
              file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--kernel-checks"]:
        return kernel_checks()
    if sys.argv[1:2] == ["--loop-lap"] and sys.argv[2:] in (["rgbd"], ["mono"]):
        return loop_lap(sys.argv[2])
    if sys.argv[1:2] == ["--gba-rank"] and len(sys.argv) == 5:
        return gba_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--lap-start"] and len(sys.argv) in (5, 6) \
            and sys.argv[2] in LOOP_ASYNC and sys.argv[5:] in ([], ["--deterministic"]):
        return lap_start(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                         sys.argv[5:] == ["--deterministic"])
    import orbslam2_tpu_torch as P
    from orbslam2_tpu_torch import _build, native
    from orbslam2_tpu_torch.io import synth
    from orbslam2_tpu_torch.io.vocabulary import default_vocabulary
    from orbslam2_tpu_torch.ops import ba as BA
    from orbslam2_tpu_torch.ops import cuda_kernels as CK
    from orbslam2_tpu_torch.ops import features as FT
    from orbslam2_tpu_torch.ops import pnp as PNP
    from orbslam2_tpu_torch.ops import pose_graph as PG
    from orbslam2_tpu_torch.utils import cuda_timing, evaluation
    from orbslam2_tpu_torch.utils import bench_host_ops
    from orbslam2_tpu_torch.utils import probe_hamming as PH
    from orbslam2_tpu_torch.utils.profile_frame import bench_config

    global T
    T = cuda_timing
    t_start = time.perf_counter()
    phase_seconds: dict = {}
    mark = [t_start]

    def lap_seconds(phase: str) -> None:
        now = time.perf_counter()
        phase_seconds[phase] = round(now - mark[0], 1)
        mark[0] = now

    card = T.card_line()
    print(f"phase 1: card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:  # every nvcc and the g++ at once
        probe = pool.submit(PH.probe_lib)
        first = pool.submit(PH.twotrip_lib)
        host = pool.submit(native.available)
        CK.build_kernels()
        lib, twotrip = probe.result(), first.result()
        if not host.result():
            raise RuntimeError("host map library (native/mapops.cpp) did not build")
    print(f"phase 2: built in {time.perf_counter() - t0:.2f} s "
          f"(compile seconds by library: {_build.build_seconds})", flush=True)
    blocking_kernel_checks()
    lap_seconds("1, 2")

    mma_per_s = PH.mma_per_second(lib)
    if mma_per_s is None:
        raise AssertionError("the tensor-core rate loop was not measured")
    print(f"phase 3: mma.sync m16n8k256 .b1 .and.popc: {mma_per_s:.4g} a second "
          f"over {torch.cuda.get_device_properties(0).multi_processor_count} SMs",
          flush=True)
    voc = default_vocabulary()
    ham = check_hamming_matrix(CK, PH, lib, mma_per_s)
    best2 = check_hamming_best2(CK, PH, lib, mma_per_s, voc)

    # the configurations of bench.py's three rows on the room scene
    scene = synth.make_room(seed=0)
    cfgs = {"rgbd": bench_config(scene, P.Sensor.RGBD),
            "stereo": bench_config(scene, P.Sensor.STEREO),
            "mono": bench_config(scene, P.Sensor.MONOCULAR)}
    orbit = synth.orbit_trajectory(ORBIT_FRAMES)
    # phase 3c: descriptors of the orbit's first frame as the tracker
    # extracts them (1000 features) and as the monocular initialization
    # does (2000)
    img0 = torch.from_numpy(_u8(synth, scene, orbit[0], 0)).cuda()
    orb = cfgs["mono"].orb
    extracted = {}
    for n_feat in (orb.n_features, 2 * orb.n_features):
        feats = FT.extract_orb(img0, dataclasses.replace(orb, n_features=n_feat),
                               scene.height, scene.width)
        extracted[n_feat] = (feats.desc.cpu().numpy(), feats.valid.cpu().numpy())
    bow = check_bow_assign(PH, lib, twotrip, voc, extracted)
    check_pnp(PNP)
    seg_per_call = check_ba(BA, PG, CK)
    seg = check_seg_sum(CK, PH, BA, PG, lib)
    lap_seconds("3")

    # phase 8's monocular lap, the longest phase, in a process of its own
    # beside phases 4 to 10; the RGB-D lap joins it after phase 7
    import subprocess
    import tempfile
    laps, dry = {}, {}

    def start_lap(sensor: str) -> None:
        out = tempfile.TemporaryFile(mode="w+")
        laps[sensor] = (subprocess.Popen([sys.executable, __file__, "--loop-lap", sensor],
                                         stdout=out, stderr=subprocess.STDOUT, text=True),
                        out, time.perf_counter() + LOOP_TIMEOUT_S)

    start_lap("mono")
    mono_orbit = synth.orbit_trajectory(MONO_FRAMES)

    def run(tag, name, gt, sensor, pipelined, n=None, keep=False):
        items = render_sequence(synth, scene, name, gt, sensor)[:n]
        return run_sequence(P, CK, evaluation, tag, f"{sensor}-{name}-{len(items)}",
                            items, gt, cfgs[sensor], sensor, pipelined,
                            whole=sensor != "mono" or n is None, keep=keep)

    sweep = synth.sweep_trajectory(SWEEP_FRAMES)
    # the synchronous sweep is the first half of the pipelined one: session
    # A of phase 9b
    sync = [run("phase 4", "orbit", orbit, "rgbd", False, SYNC_ORBIT_FRAMES),
            run("phase 4", "sweep", sweep, "rgbd", False, SYNC_SWEEP_FRAMES, keep=True)]
    piped = [run("phase 4b", "sweep", sweep, "rgbd", True, keep=True)]
    for r in (sync[1], piped[0]):
        if r["kfs"] < 3:
            raise AssertionError(f"RGB-D sweep: {r['kfs']} keyframes (gate: 3)")
    if piped[0]["counters"]["ba_solves"] < 1:
        raise AssertionError("pipelined sweep: no local BA solve")
    if piped[0]["launches"]["hamming_best2"].get("mapper", 0) <= 0:
        raise AssertionError("pipelined sweep: the mapper never launched hamming_best2")
    check_block_sync_free(P, render_sequence(synth, scene, "orbit", orbit, "rgbd"),
                          cfgs["rgbd"], "rgbd")
    check_block_sync_free(P, render_sequence(synth, scene, "orbit", orbit, "stereo"),
                          cfgs["stereo"], "stereo")
    lap_seconds("4")

    # phase 5, stereo: every tracked frame runs stereo_match (hamming_best2
    # under the row-band mask) beside the two matchers of the RGB-D frame;
    # the pipelined row runs from disk in phase 9c
    stereo = [run("phase 5", "orbit", orbit, "stereo", False, SYNC_ORBIT_FRAMES)]
    for r in stereo:
        a = r["launches"]["hamming_matrix"]["tracker"]
        b = r["launches"]["hamming_best2"]["tracker"]
        if a < r["tracked"] - 1 or b < 2 * a:
            raise AssertionError(f"stereo: {a} hamming_matrix and {b} hamming_best2 "
                                 f"launches by the tracker over {r['tracked']} tracked "
                                 "frames (gate: 1 and 2 a tracked frame)")
    lap_seconds("5")
    # phase 6, monocular: initialization launches hamming_best2 under the
    # +-100 px window mask, counted apart from the tracker
    mono = [run("phase 6", "orbit", mono_orbit, "mono", True, keep=True),
            run("phase 6", "orbit", mono_orbit, "mono", False, SYNC_MONO_FRAMES)]
    for r in mono:
        if r["launches"]["hamming_best2"].get("mono_init", 0) <= 0:
            raise AssertionError("mono: the initialization never launched hamming_best2")
    c = mono[0]["counters"]
    if mono[0]["kfs"] < 3 or c["ba_solves"] < 1 or c["points_created"] <= 0:
        raise AssertionError(f"pipelined mono: {mono[0]['kfs']} keyframes, counters {c} "
                             "(gates: 3 keyframes, 1 BA solve, 1 triangulated point)")
    lap_seconds("6")

    # phase 7: relocalization and localization mode on the Systems that the
    # pipelined RGB-D sweep and the pipelined monocular orbit left
    reloc = [dict(launches=check_reloc_rgbd(CK, synth, scene, piped[0]["system"], sweep)),
             dict(launches=check_reloc_mono(CK, synth, scene, mono[0]["system"],
                                            mono_orbit))]
    for r, sensor in zip(reloc, ("rgbd", "mono")):
        for kernel in ("bow_assign", "hamming_best2"):
            if r["launches"][kernel].get("reloc", 0) <= 0:
                raise AssertionError(f"phase 7 {sensor}: the relocalizer never "
                                     f"launched {kernel}")
    # phase 7b: its launches are counted apart from the main paths'
    check_reloc_rescue(P, CK)
    lap_seconds("7")

    # phases 9 and 10 in this process, beside both laps of phase 8
    from pathlib import Path
    try:
        start_lap("rgbd")
        with tempfile.TemporaryDirectory() as tmp:
            work = Path(tmp)
            p9 = [check_checkpoint(P, CK, synth, scene, sweep, piped[0]["system"], work)]
            lap_seconds("9a")
            p9.append(check_merge(P, CK, synth, evaluation, scene, sweep, sync[1]["system"]))
            lap_seconds("9b")
            p9 += check_datasets(P, CK, synth, evaluation, scene, orbit, work)
            lap_seconds("9c")
            # phase 10: the entry points and the distributed solvers, in the
            # time this process would wait for the laps
            p9.append(check_graft_entry(CK))
            lap_seconds("10a")
            # the dry runs of 10b and 10c are processes of their own: they run
            # while this process drives the endurance run of 10e
            dry["10b"] = start_dryrun(["--dryrun", "1"])
            dry["10c"] = start_dryrun(["--dryrun", "2", "--backend", "gloo", "--device",
                                       "cuda"])
            p9.append(check_endurance_smoke(CK))
            lap_seconds("10e")
            p10 = {"dryrun 1": finish_dryrun("phase 10b", *dry.pop("10b")),
                   "dryrun 2": finish_dryrun("phase 10c", *dry.pop("10c"))}
            lap_seconds("10b, 10c")
            p10["gba"] = check_gba_ranks(work / "sweep120.npz", work / "gba_store")
            lap_seconds("10c gba")
            p10["merged"] = check_merged_dist_ba(P, evaluation, sync[1]["system"], sweep,
                                                 work)
            lap_seconds("10d")
        # the vocabulary trainer and the host-bookkeeping probe, in the time
        # this process would wait for the laps
        vocab = check_vocab(CK, PH, lib, mma_per_s)
        lap_seconds("3e")
        print(f"phase 3e: host bookkeeping (utils/bench_host_ops.py) at K = "
              f"{HOST_OPS_KEYFRAMES}, ms, native library and numpy fallback:", flush=True)
        bench_host_ops.main(keyframes=HOST_OPS_KEYFRAMES)
        lap_seconds("3e host ops")
        loops = [finish_lap(*laps[sensor]) for sensor in ("mono", "rgbd")]
    finally:
        for proc, out, *_ in [*laps.values(), *dry.values()]:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            out.close()
    lap_seconds("8, the rest of the laps")

    def total(runs, kernel: str) -> dict:
        by = {}
        for r in runs:
            for who, n in r["launches"][kernel].items():
                by[who] = by.get(who, 0) + n
        return by

    # the main path is the bench's entry point, pipelined, once per sensor
    # row (the RGB-D sweep with async mapping, the orbits from disk through
    # run_dataset), the relocalization, loop, checkpoint and merge paths,
    # the entry and the endurance run
    main_path = piped + [mono[0]] + reloc + loops + p9 + [vocab]
    others = sync + stereo + [mono[1]]
    launches_by = {kernel: total(main_path, kernel) for kernel in KERNELS}
    print(f"phase 9: kernel launches on the pipelined paths of all sensors, the "
          f"relocalization paths after them, the corridor laps, the checkpoint, the "
          f"merge, the dataset runs, the entry of 10a, the endurance run of 10e and "
          f"the trainer of 3e: "
          f"{launches_by}; synchronous "
          f"paths: "
          f"{({k: total(others, k) for k in KERNELS})}", flush=True)
    print(f"seconds per phase: {json.dumps(phase_seconds)}; "
          f"{time.perf_counter() - t_start:.1f} s since the start", flush=True)

    # every number in these lines is measured in this run, at the shape the
    # main path gives the kernel (named as a string): motion_model_core's
    # [1024,1024] for hamming_matrix, local_points_core's [4096,1024] for
    # hamming_best2 (on the 1% mask); its stereo and init cases follow under
    # "other_shapes"
    def entry(name: str, source: str, row: dict, rows: dict, library_ms,
              replaces: str = "orbslam2_tpu/ops/pallas_kernels.py:43") -> dict:
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
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
        for (_, _, kind), r in [*best2.items(), ((0, 0, "vocab-root"), vocab["row"])]
        if kind in ("stereo-band", "init-window", "node-gate", "node-gate-mono",
                    "vocab-root")]
    # bow_assign at the mapper's and the relocalizer's shape: an extracted
    # frame's 1024 rows. It has no Pallas source: the XLA program
    # assign_words computes the same descent (no single PyTorch call does).
    # Beside it the first kernel and the variants, timed in turns
    def bow_times(r: dict) -> dict:
        return {"first_kernel": {
                    "source": "orbslam2_tpu_torch/csrc/bow_assign_twotrip_probe.cu",
                    "ms": r["old_ms"], "device_ms": r["old_dev"],
                    "cold_device_ms": r["old_cold"]},
                "variants": {name: {"device_ms": t["dev"], "cold_device_ms": t["cold"],
                                    "floor_ms": t["floor"]}
                             for name, t in r["variants"].items()},
                "block_table_bytes": r["block_bytes"], "distinct_bytes": r["bytes"]}

    row_c = bow["room-frame-1024"]
    entry_c = entry("bow_assign", "orbslam2_tpu_torch/csrc/bow_assign.cu", row_c, bow,
                    None, replaces="orbslam2_tpu/ops/bow.py:28")
    entry_c.update(bow_times(row_c))
    entry_c["other_shapes"] = [
        {"case": kind, "shape": r["shape"], "ms": r["ms"], "device_ms": r["dev"],
         "cold_device_ms": r["cold"], "floor_ms": r["floor"],
         "plain_device_ms": r["plain_dev"], "bound_ms": r["bound_ms"],
         "bound_by": "bytes", **bow_times(r)}
        for kind, r in bow.items() if r is not row_c and "dev" in r]
    # seg_sum at the local BA's Hcc (16 segments of about 512 edges, the
    # shape index_add_'s atomics contend on most); index_add_ into a zeroed
    # output is the library call
    row_d = seg["local Hcc"]
    entry_d = entry("seg_sum", "orbslam2_tpu_torch/csrc/seg_sum.cu", row_d, seg,
                    row_d["library_ms"], replaces="orbslam2_tpu/ops/ba.py:44")
    entry_d["also_replaces"] = "orbslam2_tpu/ops/pose_graph.py:74"
    entry_d["launches_per_call"] = seg_per_call
    entry_d["library_device_ms"] = row_d["library_dev"]
    entry_d["other_shapes"] = [
        {"case": name, "shape": r["shape"], "ms": r["ms"], "device_ms": r["dev"],
         "cold_device_ms": r["cold"], "floor_ms": r["floor"], "plain_ms": r["plain_ms"],
         "plain_device_ms": r["plain_dev"], "library_ms": r["library_ms"],
         "library_device_ms": r["library_dev"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"]}
        for name, r in seg.items() if r is not row_d]
    print(json.dumps({"kernels": [
        entry("hamming_matrix", "orbslam2_tpu_torch/csrc/hamming.cu", row_a, ham,
              row_a["library_ms"]), entry_b, entry_c, entry_d]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
