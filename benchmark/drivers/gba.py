"""A loop closure's global bundle adjustment over a whole map, back to back.

Traffic parameters (traffic/<mix>.json): `chunks` (solves a GBA), `iters1`,
`iters2` (Huber and plain LM iterations a solve), `cg_iters`. The
configuration gives the problem, made by the generator it names
(gen/<generator>.py) from the seed.

One GBA is the port's `GlobalBA` schedule: `chunks` calls of
`ops.ba.ba_solve` with its default solver, each from the last one's poses
and points, the card synchronised after each; its time runs from the first
call to the last synchronise. Every GBA of the window starts from the problem as generated
from the seed. Once its time is taken, each GBA's poses, points, inlier
flags and cost are copied to the host, so that the card holds no more at
the window's end than after its first GBA. After the window each GBA's
copies are held to the plain float64 BA of reference/ba.py, run once from
the same problem, on the reference's device.

With --trace 1 one GBA of the window, from 40% of it on, runs under the
profiler with the program's spans recorded (benchmark/spans.py), and is left
out of the times.
"""
from __future__ import annotations

import gc
import time
import traceback

import torch

from benchmark import counts as CT
from benchmark import harness as H
from benchmark import spans as SP
from benchmark.reference import ba as REF


def problem(ctx, seed: int | None = None) -> dict:
    """The configuration's problem from `seed` (the run's by default)."""
    return H.generator(ctx.config["generator"]).make(
        ctx.config, ctx.seed if seed is None else seed, ctx.device)


def work(p: dict, t: dict) -> tuple[int, int]:
    """(bytes, FLOP) of one GBA by the frozen counts."""
    valid = p["e_valid"]
    n_bytes, flop = CT.ba_counts(p["cam_T"].shape[0], p["pts"].shape[0],
                                 p["e_cam"].shape[0], int(valid.sum()),
                                 int((p["e_stereo"] & valid).sum()),
                                 t["iters1"] + t["iters2"], t["cg_iters"])
    return t["chunks"] * n_bytes, t["chunks"] * flop


def gaps(out, ref) -> dict:
    """The distances of one GBA's result (cam_T, pts, inlier, cost) from the
    reference's: the relative gap of the final costs, the largest camera
    centre distance, the median point distance (a point seen by two or three
    cameras sits on a ridge of the cost along its rays, where float32 and
    float64 part by metres: the largest point distance reads 0.1 to 100 m
    on sound runs), and the share of observations classified otherwise."""
    cam, pts, inl, cost = out
    rcam, rpts, rinl, rcost = ref
    cam, pts = cam.double(), pts.double()

    def centres(T):
        return -(T[:, :, :3].transpose(1, 2) @ T[:, :, 3:])[..., 0]

    return {"cost_gap": float(((cost.double() - rcost).abs() / rcost.abs()).cpu()),
            "cam_gap_mm": 1e3 * float((centres(cam) - centres(rcam)).norm(dim=-1).max().cpu()),
            "pt_gap_p50_mm": 1e3 * float((pts - rpts).norm(dim=-1).median().cpu()),
            "inlier_gap_ppm": 1e6 * float((inl != rinl).double().mean().cpu())}


class GBA:
    def __init__(self, ctx):
        from orbslam2_tpu_torch.ops import ba as BA
        from orbslam2_tpu_torch.utils import metrics as M

        self.BA, self.M = BA, M
        self.ctx = ctx
        self.t = ctx.traffic
        self.cuda = torch.device(ctx.device).type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def gba(self, prob):
        t = self.t
        for _ in range(t["chunks"]):
            res = self.BA.ba_solve(prob, *self.intrinsics, iters1=t["iters1"],
                                   iters2=t["iters2"], cg_iters=t["cg_iters"])
            self.sync()
            prob = prob._replace(cam_T=res.cam_T, pts=res.pts)
        return res

    def counts(self) -> tuple:
        """The wall clock, the allocator's segments taken so far and the
        collector's passes by generation: read at the window's ends, to show
        what ran inside it."""
        segments = (torch.cuda.memory_stats().get("segment.all.allocated", 0)
                    if self.cuda else 0)
        return time.time(), segments, [s["collections"] for s in gc.get_stats()]

    def run(self) -> H.Run:
        ctx = self.ctx
        if self.cuda:
            from orbslam2_tpu_torch.ops import cuda_kernels as CK
            CK.build_kernels()
        p = problem(ctx)
        self.intrinsics = p["intrinsics"]
        prob = self.BA.BAProblem(**{k: p[k] for k in self.BA.BAProblem._fields})
        errors, times = [], []
        self.outs = outs = []  # each GBA's outputs, on the host
        trace, traced = None, None  # the trace, and the index of the GBA it holds
        records = None  # the program's spans in the traced GBA
        self.gba(prob)  # warm-up: one GBA
        self.sync()
        counts = [self.counts()]
        t_start = time.perf_counter()
        t_end = t_start + ctx.seconds
        try:
            while time.perf_counter() < t_end:
                profile = (ctx.trace and self.cuda and trace is None
                           and time.perf_counter() >= t_start + 0.4 * ctx.seconds)
                t0 = time.perf_counter()
                if profile:
                    with self.M.recording() as records:
                        res, trace = SP.capture(lambda: self.gba(prob))
                    traced = len(times)
                else:
                    res = self.gba(prob)
                t1 = time.perf_counter()
                outs.append(tuple(x.to("cpu", copy=True)
                                  for x in (res.cam_T, res.pts, res.e_inlier, res.cost)))
                times.append((t0, t1))
        except Exception:  # noqa: BLE001 - reported, and the run is not correct
            errors.append(traceback.format_exc())
        counts.append(self.counts())
        memory = torch.cuda.max_memory_allocated() if self.cuda else 0
        done = [i for i, (_, t1) in enumerate(times) if t1 <= t_end]
        del prob
        values, failed = {}, 0
        if outs:
            ref = REF.global_ba(p, self.t["chunks"], self.t["iters1"], self.t["iters2"],
                                self.t["cg_iters"])
            readings = [gaps(tuple(x.to(ref[0].device) for x in o), ref) for o in outs]
            values = {k: max(r[k] for r in readings) for k in readings[0]}
            failed = sum(not all(c.ok for c in H.checks(readings[i], ctx.workload["name"]))
                         for i in done)
        run = H.Run(setup_s=t_start - ctx.t_process, window_s=ctx.seconds,
                    attempted=len(done), failed=failed,
                    values=values, memory_peak_bytes=memory, chips=1, trace=trace,
                    errors=errors)
        # the profiled GBA ran slower under the profiler: left out of the times
        run.data.update(gba_s=[times[i][1] - times[i][0] for i in done if i != traced],
                        work=work(p, self.t),
                        window={"wall": [c[0] for c in counts],
                                "new_segments": counts[1][1] - counts[0][1],
                                "gc_passes": [b - a for a, b in zip(counts[0][2], counts[1][2])]})
        if records:
            run.data["program_spans"] = records
        return run


def run(ctx) -> H.Run:
    return GBA(ctx).run()
