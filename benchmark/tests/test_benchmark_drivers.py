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
    ctx = gba_ctx(cameras=32, points=2048, observations=16384, seconds=5.0)
    run = H.driver("gba").run(ctx)
    assert not run.errors and run.attempted >= 1
    assert set(run.values) == GBA_NUMBERS
    assert run.values["cost_gap"] < 1e-4 and run.values["cam_gap_mm"] < 1.0
    assert len(run.data["gba_s"]) == run.attempted
    checks, line = result(run, ctx.workload, False, "cpu")
    assert set(line["metrics"]) == {"gba_solve_s", "setup_s"}


def test_gba_holds_each_gbas_outputs_on_the_host(monkeypatch, gba_ctx):
    """Each GBA's outputs are copied to the host once its time is taken:
    the GBA driver keeps none of the tensors the program returned."""
    from benchmark.drivers import gba as G
    from orbslam2_tpu_torch.ops import ba as BA

    solve, returned = BA.ba_solve, []

    def kept(*args, **kw):
        returned.append(solve(*args, **kw))
        return returned[-1]

    monkeypatch.setattr(BA, "ba_solve", kept)
    g = G.GBA(gba_ctx(cameras=16, points=512, observations=4096, seconds=2.0))
    run = g.run()
    assert run.attempted >= 1 and len(g.outs) >= run.attempted
    assert all(x.device.type == "cpu" for out in g.outs for x in out)
    theirs = {x.data_ptr() for r in returned for x in (r.cam_T, r.pts, r.e_inlier, r.cost)}
    assert not {x.data_ptr() for out in g.outs for x in out} & theirs


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
