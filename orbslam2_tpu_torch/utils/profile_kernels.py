"""Device time of each of the port's device programs beside the least time
the card could take for it, on one CUDA device.

    python3 -m orbslam2_tpu_torch.utils.profile_kernels

Counterpart of the JAX package's scripts/profile_kernels.py: its rows at its
shapes, then the port's other hand kernels at the shapes the main path
gives them:

- extract_orb on a 480x640 frame, 1000 features over 8 levels;
- hamming_matrix (kernel A) at [N, N], N = padded_capacity(1000) = 1024;
- pose_optimize, 4x10 LM over N observations, each call starting from the
  pose the previous one returned (chained as the JAX script chains it);
- refine_offsets over N windows;
- ba_solve, cg and dense, at the local cell (C=16, P=2048, E=8192) and the
  global cell (C=128, P=8192, E=65536) of graft_entry._make_ba_problem,
  5+10 LM iterations, 24 CG steps;
- hamming_best2 (kernel B) at [4096, 1024] on a 1% mask (local_points_core's
  shape);
- bow_assign over the descriptors extracted from the bench room's first
  frame (1024 rows), on the default vocabulary;
- seg_sum at the local BA's Hcc [8192x6x6 -> 16].

Each row gives: ms per call from CUDA events around back-to-back calls (what
a caller pays, the host's launch gaps included); device ms and kernels per
call from one torch.profiler pass (the sum of the kernels' device time; when
the profiler records no device time the line says so, and the device ms come
from CUDA events around calls queued behind a spin kernel); the hand
kernels' launches per call from their counters; the bytes and operations
the call needs, counted from its shapes by the `*_counts` functions below
(each input read once, each output written once; where the work depends on
the data, what these inputs need); the achieved rates over the device ms;
and the share of the bound, the larger of the bytes over 3.35 TB/s and the
operations over the data-sheet float32 rate, or for kernels A and B their
single-bit mma.sync instructions over the rate measured in this run, with
the one that bounds it. The first line is the card's name and power limit,
the last the rows as JSON. Needs a CUDA device (exits 2 without one: a
measurement never falls back to the CPU). Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import OrbParams
from ..ops import cuda_kernels as CK
from ..ops import features as F
from .cuda_timing import FP32_OPS_PER_S, bound, card_line, fmt_ms, queued_ms, time_ms

# shapes of the rows: the JAX script's, and the main path's for the kernels
# it has no row for; "cut" is a small size for the CPU tests
SIZES = {
    "full": dict(height=480, width=640, n_features=1000,
                 ba=(("local", 16, 2048, 8192), ("global", 128, 8192, 65536)),
                 best2=(4096, 1024), seg=(16, 2048, 8192)),
    "cut": dict(height=120, width=160, n_features=256,
                ba=(("local", 4, 64, 256), ("global", 8, 128, 512)),
                best2=(64, 32), seg=(4, 64, 256)),
}
BA_ITERS, BA_CG_ITERS = (5, 10), 24
BEST2_DENSITY = 0.01

# floating-point operations a unit of work needs, by the algorithm (a
# multiply-add counts two); what each covers is in its counting function
EXTRACT_FLOP_PER_PIXEL = 8 + 28 + 48 + 8   # resize, 7-tap blur, FAST, NMS
EXTRACT_FLOP_PER_KEYPOINT = 2836 + 2304 + 1800  # IC angle, BRIEF, patch
KEYPOINT_BYTES = 8 + 4 + 4 + 4 + 32 + 1 + 15 * 15 * 4  # FrameFeatures, a row
PROJECT_FLOP = 45          # project, residual, chi2 and robust weight
POSE_LM_FLOP = 2 * PROJECT_FLOP + 40 + 2 * 21 * 3 + 2 * 6 * 3
REFINE_SAMPLE_FLOP = 2 * 8 * (15 * 11 + 11 * 11)  # two 8-tap passes
BA_ROW_FLOP = 36 + 2 * (21 + 6 + 18 + 6 + 3)  # Jacobian, block sums
HAMMING_INT_OPS = 3 * 8    # XOR, popcount and add of each of 8 words


def extract_orb_counts(height: int, width: int, params: OrbParams) -> tuple[int, int]:
    """(bytes, FLOP) of extract_orb on a float32 [height, width] frame:
    the frame read, every FrameFeatures row of the padded capacity written;
    per pixel of every pyramid level its resize, blur, FAST test and
    non-maximum suppression, per keypoint row its orientation, BRIEF
    descriptor and patch."""
    pixels = sum(h * w for h, w in F.level_sizes(height, width, params.n_levels,
                                                 params.scale_factor))
    n = F.padded_capacity(params.n_features)
    return (4 * height * width + n * KEYPOINT_BYTES,
            EXTRACT_FLOP_PER_PIXEL * pixels + EXTRACT_FLOP_PER_KEYPOINT * n)


def hamming_matrix_counts(A: int, B: int) -> tuple[int, int]:
    """(bytes, mma.sync) of kernel A at [A, 8] x [B, 8]: both descriptor
    sets read, the int32 matrix written; two single-bit mma a 16x8 tile."""
    return 4 * A * B + 32 * (A + B), 2 * -(-A // 16) * -(-B // 8)


def hamming_best2_counts(cand: torch.Tensor) -> tuple[int, int]:
    """(bytes, mma.sync) of kernel B under the [A, B] mask `cand`: the
    descriptors and the mask read, three int32 a row written; 16 mma for
    each 16x64 chunk whose mask is not empty (the kernel skips the others)."""
    A, B = cand.shape
    padded = torch.nn.functional.pad(cand, (0, -B % 64, 0, -A % 16))
    chunks = int(padded.view(-(-A // 16), 16, -(-B // 64), 64)
                 .any(dim=3).any(dim=1).sum().item())
    return A * B + 32 * (A + B) + 12 * A, 16 * chunks


def pose_optimize_counts(n: int) -> tuple[int, int]:
    """(bytes, FLOP) of pose_optimize over n observations: the pose, points,
    observations, stereo flags, information and validity read, the pose,
    inliers and their count written; per observation and LM iteration (4
    rounds of 10) the residual at the pose and at the trial step, the
    Jacobian and the 6x6 normal equations, per round the classification."""
    n_bytes = 48 + n * (12 + 12 + 1 + 4 + 1) + 48 + n + 8
    return n_bytes, n * (40 * POSE_LM_FLOP + 4 * PROJECT_FLOP)


def refine_offsets_counts(n: int) -> tuple[int, int]:
    """(bytes, FLOP) of refine_offsets over n float32 windows: the [15, 15]
    windows, [11, 11] templates and validity read, the shift and the flag
    written; per window the template's statistics and gradients, then 8
    iterations of a shifted sample, its mean and residual and the 2x2
    right-hand side, and the two closing residual sums."""
    n_bytes = n * (15 * 15 * 4 + 11 * 11 * 4 + 1) + n * (8 + 1)
    per_iter = REFINE_SAMPLE_FLOP + 8 * 11 * 11
    closing = 2 * (REFINE_SAMPLE_FLOP + 5 * 11 * 11)
    return n_bytes, n * (12 * 11 * 11 + 8 * per_iter + closing)


def ba_counts(arrays: dict, dense: bool, iters: int = sum(BA_ITERS),
              cg_iters: int = BA_CG_ITERS) -> tuple[int, int]:
    """(bytes, FLOP) of one ba_solve on a problem given as numpy arrays
    named as BAProblem's fields: every field read once (the edge indices as
    int64), the poses, points, inlier flags and cost written. Per LM
    iteration: per residual row of a valid edge (2, stereo 3) its Jacobian
    and its share of the Hcc, Hpp, coupling and gradient blocks; per valid
    edge the residual at the pose and at the trial step; per point the 3x3
    inverse. Dense: the coupling times Hpp^-1 per point and observing
    camera, a 6x6 block per pair of cameras that share a point, the Cholesky of the free cameras'
    system and its two triangular solves; CG: per step the matvec (two
    6x3 products an edge, Hpp^-1 a point, Hcc and the preconditioner a
    camera)."""
    C, P, E = len(arrays["cam_T"]), len(arrays["pts"]), len(arrays["e_cam"])
    n_bytes = (C * (48 + 1 + 1) + P * (12 + 1) + E * (8 + 8 + 12 + 1 + 4 + 1)
               + C * 48 + P * 12 + E + 4)
    valid = np.asarray(arrays["e_valid"], bool)
    rows = int((2 + np.asarray(arrays["e_stereo"], bool)[valid]).sum())
    per_iter = BA_ROW_FLOP * rows + 2 * PROJECT_FLOP * int(valid.sum()) + 40 * P
    if dense:
        pairs = np.unique(np.stack([arrays["e_pt"][valid], arrays["e_cam"][valid]], 1),
                          axis=0)
        per_point = np.bincount(pairs[:, 0], minlength=P)
        free = 6 * int((~np.asarray(arrays["cam_fixed"], bool)).sum())
        per_iter += (108 * len(pairs) + 216 * int((per_point * (per_point + 1) // 2).sum())
                     + free ** 3 // 3 + 2 * free ** 2)
    else:
        per_iter += cg_iters * (72 * E + 18 * P + 144 * C)
    return n_bytes, iters * per_iter


def bow_assign_counts(voc, desc: np.ndarray, valid: np.ndarray) -> tuple[int, int]:
    """(bytes, integer ops) of bow_assign: the distinct bytes of
    probe_hamming.bow_assign_bytes (each node some valid descent stands on,
    once, and 42 bytes a row); per valid row and level the k children's
    XOR, popcount and sum of 8 words and the argmin."""
    from .probe_hamming import bow_assign_bytes
    n_ops = int(valid.sum()) * voc.levels * voc.k * (HAMMING_INT_OPS + 1)
    return bow_assign_bytes(voc, desc, valid)[0], n_ops


def seg_sum_counts(rows: int, d: int, n: int, elem: int) -> tuple[int, int]:
    """(bytes, adds) of seg_sum over `rows` rows of d elements of `elem`
    bytes into n segments: the rows and the plan (a 4-byte row index each,
    n + 1 offsets) read, the sums written; one add an element."""
    return rows * (d * elem + 4) + 4 * (n + 1) + n * d * elem, rows * d


class Row(NamedTuple):
    """One profiled program: `call()` runs it once (a chained row keeps the
    previous call's output in the closure); `n_ops` counts FLOP (integer
    ops counted alike) at `ops_per_s`, or mma.sync instructions when
    `mma` is true (the rate is measured by the caller)."""

    name: str
    call: Callable[[], object]
    n_bytes: int
    n_ops: int
    mma: bool = False
    ops_per_s: float = FP32_OPS_PER_S
    reps: int = 50
    note: str = ""


def extraction_rows(device, size: str = "full") -> list[Row]:
    """extract_orb on a seeded random frame, as the JAX script's row."""
    s = SIZES[size]
    params = OrbParams(n_features=s["n_features"])
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 255, (s["height"], s["width"]))
                           .astype(np.float32)).to(device)
    return [Row(f"extract_orb ({s['height']}x{s['width']}, {params.n_features} kp, "
                f"{params.n_levels} levels)",
                lambda: F.extract_orb(img, params, s["height"], s["width"]),
                *extract_orb_counts(s["height"], s["width"], params), reps=10)]


def tracking_rows(device, size: str = "full") -> list[Row]:
    """hamming_matrix, pose_optimize and refine_offsets at the JAX script's
    N = padded_capacity(n_features), on its seeded draws."""
    from ..ops import pose_opt as PO
    from ..ops import refine as RF
    from .probe_hamming import descriptors
    s = SIZES[size]
    N = F.padded_capacity(s["n_features"])
    rng = np.random.default_rng(0)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    da, db = dev(descriptors(rng, N)), dev(descriptors(rng, N))
    pts = rng.uniform(-2, 2, (N, 3)).astype(np.float32) + np.float32([0, 0, 6])
    obs = np.stack([500 * pts[:, 0] / pts[:, 2] + 320, 500 * pts[:, 1] / pts[:, 2] + 240,
                    np.zeros(N)], -1).astype(np.float32)
    pts_d, obs_d = dev(pts), dev(obs)
    stereo, info = torch.zeros(N, dtype=torch.bool, device=device), dev(np.ones(N, np.float32))
    valid = torch.ones(N, dtype=torch.bool, device=device)
    pose = [dev(np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32))]

    def pose_call():
        pose[0] = PO.pose_optimize(pose[0], pts_d, obs_d, stereo, info, valid,
                                   500.0, 500.0, 320.0, 240.0, 0.0).T
        return pose[0]

    win = dev(rng.uniform(0, 255, (N, 15, 15)).astype(np.float32))
    tpl = dev(rng.uniform(0, 255, (N, 11, 11)).astype(np.float32))
    return [
        Row(f"hamming_matrix [{N}x{N}]", lambda: CK.hamming_matrix(da, db),
            *hamming_matrix_counts(N, N), mma=True, note="kernel A"),
        Row(f"pose_optimize (4x10 LM, {N} obs)", pose_call, *pose_optimize_counts(N),
            reps=5, note="chained: each call starts from the last pose"),
        Row(f"refine_offsets ({N} windows, IC-LK)", lambda: RF.refine_offsets(win, tpl, valid),
            *refine_offsets_counts(N), reps=20),
    ]


def ba_rows(device, size: str = "full") -> list[Row]:
    """ba_solve, cg and dense, at the local and the global cell."""
    from ..graft_entry import _make_ba_problem
    from ..ops import ba as BA
    rows = []
    for tag, C, P, E in SIZES[size]["ba"]:
        arrays, intr = _make_ba_problem(C, P, E)
        prob = BA.problem_from_numpy(arrays, torch.device(device))
        for solver in ("cg", "dense"):
            rows.append(Row(
                f"ba_solve[{solver}] {tag} (C={C} P={P} E={E}, "
                f"{BA_ITERS[0]}+{BA_ITERS[1]} LM)",
                lambda s=solver, p=prob: BA.ba_solve(
                    p, *intr, iters1=BA_ITERS[0], iters2=BA_ITERS[1],
                    cg_iters=BA_CG_ITERS, solver=s),
                *ba_counts(arrays, dense=solver == "dense"), reps=2))
    return rows


def kernel_rows(device, size: str = "full") -> list[Row]:
    """The hand kernels the JAX script has no row for, at the main path's
    shapes: hamming_best2 on a 1% mask, bow_assign on an extracted room
    frame, seg_sum at the local BA's Hcc."""
    from ..graft_entry import _make_ba_problem
    from ..io import synth
    from ..io.vocabulary import default_vocabulary
    from ..ops.bow import GATE_DEPTH
    from .probe_hamming import descriptors
    s = SIZES[size]
    rng = np.random.default_rng(0)
    A, B = s["best2"]
    a = torch.from_numpy(descriptors(rng, A)).to(device)
    b = torch.from_numpy(descriptors(rng, B)).to(device)
    cand = torch.from_numpy(rng.random((A, B)) < BEST2_DENSITY).to(device)

    H, W = s["height"], s["width"]
    f = 500.0 * W / 640
    scene = synth.make_room(seed=0, width=W, height=H, fx=f, fy=f)
    img = np.clip(synth.render_room(scene, synth.orbit_trajectory(1)[0], seed=0), 0, 255)
    feats = F.extract_orb(torch.from_numpy(img.astype(np.float32)).to(device),
                          OrbParams(n_features=s["n_features"]), H, W)
    voc = default_vocabulary()
    tables = voc.device_tables_on(device)
    blocks = voc.child_blocks_on(device)
    desc, valid = feats.desc.clone(), feats.valid.clone()  # fresh, aligned

    C, P, E = s["seg"]
    e_cam = torch.from_numpy(_make_ba_problem(C, P, E)[0]["e_cam"].astype(np.int64)).to(device)
    plan = CK.seg_plan(e_cam, C)
    x = torch.from_numpy(rng.standard_normal((E, 6, 6)).astype(np.float32)).to(device)
    return [
        Row(f"hamming_best2 [{A}x{B}], {100 * BEST2_DENSITY:.0f}% mask",
            lambda: CK.hamming_best2(a, b, cand), *hamming_best2_counts(cand), mma=True,
            note="kernel B"),
        Row(f"bow_assign M={len(desc)} ({len(voc.node_desc)} nodes)",
            lambda: CK.bow_assign(*tables, desc, valid, voc.levels, GATE_DEPTH,
                                  blocks=blocks),
            *bow_assign_counts(voc, desc.cpu().numpy(), valid.cpu().numpy())),
        Row(f"seg_sum local Hcc [{E}x6x6 -> {C}]", lambda: CK.seg_sum(x, plan),
            *seg_sum_counts(E, 36, C, 4)),
    ]


def rows(device, size: str = "full") -> list[Row]:
    """Every row, in the order of the JAX script, then the port's kernels."""
    return (extraction_rows(device, size) + tracking_rows(device, size)
            + ba_rows(device, size) + kernel_rows(device, size))


def _profiled(call, calls: int) -> tuple[float, float]:
    """(device ms, kernels) per call over `calls` calls under torch.profiler:
    the sum of the CUDA activities' own device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kern) / 1e3 / calls,
            sum(e.count for e in kern) / calls)


def measure(row: Row, mma_per_s: float | None) -> dict:
    """A row on the card: its times, kernels, hand-kernel launches, counts,
    achieved rates and share of the bound."""
    CK.reset_launch_counts()
    row.call()  # also the warm-up of the timed calls
    launches = {w.__name__: w.launches for w in CK._WRAPPERS if w.launches}
    ms = time_ms(row.call, reps=row.reps, warm=0)
    # a third of the timed calls under the profiler: a BA solve's 18,000
    # kernels take the profiler seconds to gather
    calls = max(1, row.reps // 3)
    dev_ms, kernels = _profiled(row.call, calls)
    source = "profiler"
    if dev_ms <= 0:
        source = "queued CUDA events (the profiler recorded no device time)"
        dev_ms = queued_ms(row.call, reps=calls)
    rate = mma_per_s if row.mma else row.ops_per_s
    out = dict(name=row.name, ms=ms, device_ms=dev_ms, device_ms_from=source,
               kernels=kernels, launches=launches, bytes=row.n_bytes, ops=row.n_ops,
               ops_unit="mma.sync" if row.mma else "FLOP", note=row.note)
    if rate:
        out.update(bound(row.n_bytes, row.n_ops, rate), ops_per_s_peak=rate)
    if dev_ms and rate:
        out.update(gb_per_s=row.n_bytes / dev_ms / 1e6, ops_per_s=row.n_ops / dev_ms * 1e3,
                   share_of_bound=out["bound_ms"] / dev_ms)
    return out


def line(r: dict) -> str:
    """One row as a line of text."""
    rates = ("" if "share_of_bound" not in r else
             f"; {r['gb_per_s']:.3f} GB/s, {r['ops_per_s']:.4g} {r['ops_unit']}/s; bound "
             f"{r['bound_ms']:.6f} ms by {r['bound_by']} (bytes {r['bound_bytes_ms']:.6f}, "
             f"{r['ops_unit']} {r['bound_ops_ms']:.6f}), {100 * r['share_of_bound']:.3f}% "
             "of it")
    return (f"{r['name']}: {r['ms']:.4f} ms per call (CUDA events, back-to-back); device "
            f"{fmt_ms(r['device_ms'])} and {r['kernels']:.0f} kernels per call "
            f"({r['device_ms_from']}); hand-kernel launches per call {r['launches']}; "
            f"{r['bytes']} bytes, {r['ops']} {r['ops_unit']}{rates}"
            + (f"; {r['note']}" if r["note"] else ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_kernels: no CUDA device: the profiler runs only on the card",
              file=sys.stderr)
        return 2
    from . import probe_hamming as PH
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    with ThreadPoolExecutor(1) as pool:  # the probe's nvcc beside the kernels'
        probe = pool.submit(PH.probe_lib)
        CK.build_kernels()
        lib = probe.result()
    mma_per_s = PH.mma_per_second(lib)
    print(f"mma.sync m16n8k256 .b1 .and.popc: {mma_per_s:.4g} a second (measured)",
          flush=True)
    results = []
    for row in rows("cuda"):
        results.append(measure(row, mma_per_s))
        print(line(results[-1]), flush=True)
    print("\n| row | ms per call | device ms | kernels | bytes | ops | GB/s | ops/s | "
          "bound ms | bound by | share of bound |\n|---|---|---|---|---|---|---|---|---|---|---|")
    for r in results:
        print(f"| {r['name']} | {r['ms']:.4f} | {fmt_ms(r['device_ms'])} | "
              f"{r['kernels']:.0f} | {r['bytes']} | {r['ops']} {r['ops_unit']} | "
              f"{r.get('gb_per_s', math.nan):.3f} | {r.get('ops_per_s', math.nan):.4g} | "
              f"{r.get('bound_ms', math.nan):.6f} | {r.get('bound_by', '')} | "
              f"{100 * r.get('share_of_bound', math.nan):.3f}% |")
    print(json.dumps({"card": card_line(), "rows": results}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
