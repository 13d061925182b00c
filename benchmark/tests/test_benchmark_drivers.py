"""Each driver's whole run on the CPU at a cut size: set-up, the window, the
comparison with the reference, and what the readers read; then with the
timed path broken underneath, the faults that `correct` has to reject."""
import pytest
import torch

from benchmark import harness as H
from benchmark.run import result

GBA_NUMBERS = {"cost_gap", "cam_gap_mm", "pt_gap_p50_mm", "inlier_gap_ppm"}


def failing(run, workload):
    return {c.name for c in H.checks(run.values, workload) if not c.ok}


def test_gba_runs_on_the_cpu(gba_ctx):
    ctx = gba_ctx(cameras=32, points=2048, observations=16384)
    run = H.driver("gba").run(ctx)
    assert not run.errors and run.attempted >= 1
    assert set(run.values) == GBA_NUMBERS
    assert run.values["cost_gap"] < 1e-4 and run.values["cam_gap_mm"] < 1.0
    assert len(run.data["gba_s"]) == run.attempted
    checks, line = result(run, ctx.workload, False, "cpu")
    assert set(line["metrics"]) == {"gba_solve_s", "setup_s"}


@pytest.mark.parametrize("fault,number", [("unchanged", "cam_gap_mm"),
                                          ("altered", "cam_gap_mm"),
                                          ("half", "cost_gap")])
def test_gba_faults_are_not_correct(monkeypatch, gba_ctx, fault, number):
    from orbslam2_tpu_torch.ops import ba as BA

    solve = BA.ba_solve

    def broken(p, *args, **kw):
        if fault == "unchanged":
            return BA.BAResult(p.cam_T, p.pts, p.e_valid, torch.zeros(()))
        if fault == "half":
            p = p._replace(e_valid=p.e_valid & (torch.arange(len(p.e_valid)) % 2 == 0))
        res = solve(p, *args, **kw)
        if fault == "altered":
            cam = res.cam_T.clone()
            cam[3, 0, 3] += 0.05
            res = res._replace(cam_T=cam)
        return res

    monkeypatch.setattr(BA, "ba_solve", broken)
    ctx = gba_ctx(cameras=32, points=2048, observations=16384, seconds=3.0)
    run = H.driver("gba").run(ctx)
    checks, line = result(run, ctx.workload, False, "cpu")
    assert line["correct"] is False
    assert number in failing(run, "gba-512-cg")
