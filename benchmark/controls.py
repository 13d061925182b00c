"""The controls: what `correct` has to reject, read at a cell's own size.

    python3 -m benchmark.controls --workload <cell> --seeds 1 2 3 [--program]

prints one JSON line a seed with the control's readings of the cell's
compared numbers, beside the cell's limits. The benchmark's own runs never
run it.

- GBA cells (the configuration states float32): the plain reference itself
  in the program's place, computed in the nearest precision below the
  stated one, TF32 (float32 with every matrix product in TF32), read
  against the float64 reference. Needs a card. With --program it also
  reads the program's float32 GBA on the same problem, without a window;
  --program-only reads that alone.
"""
from __future__ import annotations

import argparse
import json
import sys

from benchmark import harness as H


def gba_control(conf: dict, traffic: dict, seed: int, program: bool,
                control: bool = True) -> dict:
    import torch

    from benchmark.drivers.gba import gaps
    from benchmark.reference import ba as REF

    p = H.generator(conf["generator"]).make(conf, seed, "cuda")
    sched = (traffic["chunks"], traffic["iters1"], traffic["iters2"], traffic["cg_iters"])
    ref = REF.global_ba(p, *sched)
    out = {}
    if control:
        out["control_tf32"] = gaps(REF.global_ba(p, *sched, dtype=torch.float32, tf32=True),
                                   ref)
        out["reference_fp32"] = gaps(REF.global_ba(p, *sched, dtype=torch.float32), ref)
    if program:
        from orbslam2_tpu_torch.ops import ba as BA

        prob = BA.BAProblem(**{k: p[k] for k in BA.BAProblem._fields})
        for _ in range(traffic["chunks"]):
            res = BA.ba_solve(prob, *p["intrinsics"], iters1=traffic["iters1"],
                              iters2=traffic["iters2"], cg_iters=traffic["cg_iters"])
            prob = prob._replace(cam_T=res.cam_T, pts=res.pts)
        out["program"] = gaps((res.cam_T, res.pts, res.e_inlier, res.cost), ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--program-only", action="store_true")
    args = ap.parse_args(argv)
    w = H.cell(args.workload)
    conf, traffic = H.config(w["config"]), H.traffic(w["traffic"])
    limits = H.limits(w["name"])
    args.program |= args.program_only
    for seed in args.seeds:
        readings = gba_control(conf, traffic, seed, args.program,
                               control=not args.program_only)
        print(json.dumps({"workload": w["name"], "seed": seed, "limits": limits,
                          **readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
