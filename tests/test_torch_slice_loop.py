"""Whole-System loop-closing slice: the same cut RGB-D lap of the corridor
circuit (torch_slice_common.LOOP_CUT, 320x240) through the JAX package's
System and through the port's on the CPU, each frame through track_rgbd
with the mapper inline, then shutdown(), which waits for the background
global BA and applies it.

Gates: both Systems track every frame and close at least one loop; they
close their first loop between the same two keyframes (the keyframe
schedules agree up to the closure, and the loop closer's candidates,
Sim(3) and support are held to JAX's in test_torch_loop_closing.py); both
apply a global BA; the port's metric ATE is at most 1.5 times JAX's and at
most 5 cm. The ATE is not compared closer: after the closure each
package's global BA moves the whole map, and f32 sums in another order
move it differently (tests/test_torch_ba.py holds the solver itself).
"""
import functools
import time

import numpy as np

import torch_slice_common as C
from orbslam2_tpu.system import System as JSystem
from orbslam2_tpu_torch.system import System
from orbslam2_tpu_torch.utils.evaluation import ate_rmse, camera_centers


@functools.lru_cache(maxsize=1)
def laps():
    cfg_j, cfg_t = C.configs("RGBD")
    gt, items = C.render_corridor(*C.LOOP_CUT)
    out = []
    for make in (lambda: JSystem(cfg_j), lambda: System(cfg_t, device="cpu")):
        t0 = time.perf_counter()
        slam = make()
        tracked = sum(slam.track_rgbd(d["image"], d["depth"], ts) is not None
                      for ts, d in items)
        slam.shutdown()
        ts, est = slam.tracker.trajectory()
        fids = np.round(np.asarray(ts) * 30).astype(int)
        ate = ate_rmse(camera_centers(est), camera_centers(gt[fids]), with_scale=False)
        out.append(dict(tracked=tracked, ate=ate, system=slam,
                        seconds=time.perf_counter() - t0))
    return out


def test_both_close_a_loop_and_apply_a_global_ba():
    n = C.LOOP_CUT[0]
    for r in laps():
        slam = r["system"]
        assert r["tracked"] == n
        assert slam.map_stats()["loops"] >= 1 and slam.loop_closer.n_loops_closed >= 1
        assert slam.global_ba.n_applied >= 1
        assert not slam.global_ba.running


def test_same_first_loop_pair():
    j, t = laps()
    assert t["system"].loop_closer.loop_edges[0] == j["system"].loop_closer.loop_edges[0]


def test_ate_within_gate():
    j, t = laps()
    assert np.isfinite(t["ate"])
    assert t["ate"] <= 1.5 * j["ate"] and t["ate"] <= 0.05, (t["ate"], j["ate"])


def test_port_records_the_closure():
    """The port's closure record (what chip_smoke.py prints) and the loop
    count of its MetricsLog."""
    slam = laps()[1]["system"]
    lc = slam.loop_closer
    c = lc.closures[0]
    assert (c["kf"], c["kc"]) == lc.loop_edges[0]
    assert c["ransac_inliers"] >= 20 and c["sim3_inliers"] >= 20 and c["support"] >= 40
    assert c["guided_matches"] >= c["bow_matches"] >= 20
    assert c["n_edges"] > 0 and c["fused"] >= 0
    assert set(c["ms"]) == {"detect", "compute", "correct", "fuse", "pgo"}
    assert all(v >= 0 for v in c["ms"].values())
    assert slam.metrics.records[-1].loops == lc.n_loops_closed
    assert all(d["loop"] >= 0 for d in slam.local_mapper.stage_ms)
    assert len(slam.global_ba.solve_ms) >= 1 and len(slam.global_ba.chunk_ms) == 5
