"""Where the time of `seg_sum` and of the solves built on it goes, on one
CUDA device.

    python3 -m orbslam2_tpu_torch.utils.probe_seg_sum [--parent DIR]

1. What ptxas makes of csrc/seg_sum.cu (registers, spills: `nvcc
   -Xptxas -v`).
2. `seg_sum` at each BA cell's sums (Hcc and bc by camera, the coupling
   G, Hpp and bp by point) and the pose graph's (the 7x7 blocks and b):
   device time warm (CUDA events around calls queued behind a spin kernel)
   on each of the kernel's three paths, each checked bit for bit against
   the plain version, beside `index_add_` into a zeroed output and the
   plain version (`zeros` + `index_add_`), and for the sparse shapes the
   path's zero fill alone beside `Tensor.zero_`; the host's cost a call against
   the plain version's, host clock over back-to-back calls without a
   synchronize; `ba.ba_plans` (three stable sorts and searches) with one.
3. The solves of chip_smoke.py's phase 3b: `ba_solve` at the local and
   global BA cells and `optimize_pose_graph` at the 2,821-edge cell, each
   version of the package in a process of its own. A line a solve: device
   ms and kernels a solve from a profiler trace of one solve, and ms a
   solve from CUDA events over back-to-back solves. With `--parent DIR` (a
   checkout of another version, for example the parent commit unpacked
   with `git archive`) the versions run in turns: DIR, this, this, DIR.
   The problems are made once, here, and handed to each process in an npz
   file, so every version solves the same ones.

Every line carries numbers of this run only; the first line is the card's
name and power limit. Imports nothing of JAX. Step 3's processes import
the package first on their path, so this file imports the package only
inside its functions.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

CELLS = (("local", 16, 2048, 8192), ("global", 128, 8192, 65536))
PGO_CELL = (421, 2821)  # chip_smoke.py's: the endurance closures' graph
_ROOT = Path(__file__).resolve().parents[2]


def ptxas_lines() -> list[str]:
    """The resource lines ptxas prints for csrc/seg_sum.cu."""
    from orbslam2_tpu_torch import _build
    src = _build.PKG_DIR / "csrc" / "seg_sum.cu"
    cmd = [_build._find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xptxas", "-v", "-c", "-o", "/dev/null", str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    return [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]


def host_us(fn, reps: int = 300) -> float:
    """Host microseconds a call of fn, back to back without a synchronize."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def kernel_times() -> None:
    """Step 2."""
    from orbslam2_tpu_torch.ops import ba as BA
    from orbslam2_tpu_torch.ops import cuda_kernels as CK
    from orbslam2_tpu_torch.ops import pose_graph as PG
    from orbslam2_tpu_torch.utils.cuda_timing import fmt_ms, queued_ms
    CK.build_kernels()
    rng = np.random.default_rng(0)
    cases = []
    for name, C, P, E in CELLS:
        arrays, _ = BA.synthetic_problem(C, P, E, seed=0)
        prob = BA.problem_from_numpy(arrays, torch.device("cuda"))
        e_cam, e_pt = prob.e_cam.long(), prob.e_pt.long()
        cases += [(f"{name} Hcc", e_cam, C, (6, 6)), (f"{name} bc", e_cam, C, (6,)),
                  (f"{name} G", e_pt * C + e_cam, P * C, (6, 3)),
                  (f"{name} Hpp", e_pt, P, (3, 3)), (f"{name} bp", e_pt, P, (3,))]
    pgo = PG.synthetic_problem(*PGO_CELL, seed=0)
    e_i = torch.from_numpy(np.asarray(pgo[4])).cuda().long()
    cases += [("pgo Hd", e_i, PGO_CELL[0], (7, 7)), ("pgo b", e_i, PGO_CELL[0], (7,))]
    for what, idx, n, tail in cases:
        E = idx.shape[0]
        x = torch.from_numpy(rng.standard_normal((E, *tail)).astype(np.float32)).cuda()
        plan = CK.seg_plan(idx, n)
        out = torch.empty((n, *tail), device="cuda")
        zero = torch.zeros_like(out)
        want = CK.seg_sum_ref(x.cpu(), idx.cpu(), n)
        times = []
        for path in CK.SEG_PATHS:
            CK._seg_sum_launch(x, plan, out, path)
            if not torch.equal(out.cpu(), want):
                raise AssertionError(f"{what}: the {path} path differs from the plain version")
            times.append(f"{path} {fmt_ms(queued_ms(lambda: CK._seg_sum_launch(x, plan, out, path)))}")
        print(f"{what} [{E}x{'x'.join(map(str, tail)) or '1'} -> {n}], chosen "
              f"{CK.seg_sum_path(E, n)}: device warm by path: {', '.join(times)}; "
              f"index_add_ {fmt_ms(queued_ms(lambda: zero.index_add_(0, idx, x)))}, plain "
              f"{fmt_ms(queued_ms(lambda: CK.seg_sum_ref(x, idx, n)))}; host us a call, "
              f"back-to-back without a sync: seg_sum "
              f"{host_us(lambda: CK.seg_sum(x, plan)):.1f}, plain "
              f"{host_us(lambda: CK.seg_sum_ref(x, idx, n)):.1f}", flush=True)
        if CK.seg_sum_path(E, n) == "sparse":
            # the sparse path's first pass alone (no rows), and PyTorch's fill
            none = CK.seg_plan(torch.empty(0, dtype=torch.int64, device="cuda"), n)
            x0 = x[:0]
            print(f"{what}: the sparse path's zero fill alone "
                  f"{fmt_ms(queued_ms(lambda: CK._seg_sum_launch(x0, none, out, 'sparse')))}"
                  f", Tensor.zero_ {fmt_ms(queued_ms(out.zero_))}", flush=True)
    for name, C, P, E in CELLS:
        arrays, _ = BA.synthetic_problem(C, P, E, seed=0)
        prob = BA.problem_from_numpy(arrays, torch.device("cuda"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            BA.ba_plans(prob, dense=True)
        torch.cuda.synchronize()
        print(f"{name} ba_plans on the device: {(time.perf_counter() - t0) / 20 * 1e3:.3f} "
              f"ms (synced)", flush=True)


def write_problems(path: str) -> None:
    """Step 3's problems, made with this version's seeded generators."""
    from orbslam2_tpu_torch.ops import ba as BA
    from orbslam2_tpu_torch.ops import pose_graph as PG
    data = {}
    for name, C, P, E in CELLS:
        arrays, intr = BA.synthetic_problem(C, P, E, seed=0)
        data.update({f"{name}/{k}": np.asarray(v) for k, v in arrays.items()})
        data[f"{name}/intr"] = np.asarray(intr, np.float64)
    for i, a in enumerate(PG.synthetic_problem(*PGO_CELL, seed=0)):
        data[f"pgo/{i}"] = np.asarray(a)
    np.savez(path, **data)


def solve_times(path: str) -> dict:
    """Step 3 in this process, for the package first on the path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import orbslam2_tpu_torch
    from orbslam2_tpu_torch.ops import ba as BA
    from orbslam2_tpu_torch.ops import pose_graph as PG
    data = np.load(path)
    dev = torch.device("cuda")
    solves = {}
    for name, *_ in CELLS:
        arrays = {k.split("/", 1)[1]: data[k] for k in data.files
                  if k.startswith(f"{name}/") and k != f"{name}/intr"}
        prob = BA.problem_from_numpy(arrays, dev)
        intr = [float(v) for v in data[f"{name}/intr"]]
        solves[f"ba {name}"] = (lambda prob=prob, intr=intr: BA.ba_solve(prob, *intr), 5)
    pgo = [torch.from_numpy(data[f"pgo/{i}"]).to(dev)
           for i in range(sum(k.startswith("pgo/") for k in data.files))]
    solves["pgo"] = (lambda: PG.optimize_pose_graph(*pgo), 3)
    out = {"package": str(Path(orbslam2_tpu_torch.__file__).parent)}
    for name, (fn, reps) in solves.items():
        for _ in range(2):  # builds the kernels, warms the allocator
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out[name] = {"device_ms": sum(e.self_device_time_total for e in kern) / 1e3,
                     "kernels": sum(e.count for e in kern),
                     "ms": start.elapsed_time(end) / reps}
    return out


def compare_solves(parent: str | None) -> None:
    """Step 3: this version's solves, and in turns another's."""
    turns = [("parent", parent), ("this", str(_ROOT)), ("this", str(_ROOT)),
             ("parent", parent)] if parent else [("this", str(_ROOT))]
    with tempfile.TemporaryDirectory() as tmp:
        problems = os.path.join(tmp, "problems.npz")
        write_problems(problems)
        for label, root in turns:
            env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                                   "--solve-times", problems], cwd=root, env=env,
                                  capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"solve times of {root}: exit {proc.returncode}\n"
                                   f"{proc.stderr[-3000:]}")
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            print(f"solves ({label}, {got.pop('package')}): " + "; ".join(
                f"{k} {v['device_ms']:.3f} device ms, {v['kernels']} kernels, "
                f"{v['ms']:.2f} ms (CUDA events)" for k, v in got.items()), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout of another version to time in turns")
    ap.add_argument("--solve-times", help=argparse.SUPPRESS)  # step 3's processes
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_seg_sum: no CUDA device", file=sys.stderr)
        return 2
    if a.solve_times:
        print(json.dumps(solve_times(a.solve_times)), flush=True)
        return 0
    from orbslam2_tpu_torch.utils.cuda_timing import card_line
    print(f"card: {card_line()}", flush=True)
    for line in ptxas_lines():
        print(f"ptxas: {line}", flush=True)
    kernel_times()
    compare_solves(a.parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
