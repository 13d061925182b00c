"""The whole slice with local mapping: the port's System with the block
driver and the mapper against the JAX package's System on the 30-frame
0.15 m sweep (320x240, 500 features; tests/torch_slice_common.py).

The JAX side is System(cfg) with its mapper inline and the loop closer,
which the port does not have yet, switched off; both Systems build the
default vocabulary, the keyframe database and the relocalizer. Both run run_sequence(pipelined=True). On this sequence JAX tracks
30/30 at about 3.1 cm with 7 keyframes: at this size the mapper's ATE sits
near the README's 3 cm gate (ROADMAP queue 3), so the gates hold the port
to the JAX run, not to 3 cm:

- both track all 30 frames; keyframe counts within one;
- each metric ATE within 1.5x of the other, and at most 5 cm.

One more port run with async_mapping=True (the mapper on its worker
thread; which frames become keyframes then depends on timing): at least
90% of the frames tracked (bench.py's gate), and the map invariants of
tests/test_async_mapping.py: no binding to a dead point, finite poses.

And a second fresh port System, mapper inline, over the same frames: the
port repeats itself as the JAX package does, so every pose of the
trajectory and every map array (keyframe poses, point positions, kf_pt,
the covisibility weights) equal the first run's bit for bit.
"""
import time

import numpy as np
import pytest

from orbslam2_tpu.system import System as JSystem
from orbslam2_tpu_torch.io import synth
from orbslam2_tpu_torch.system import System
from torch_slice_common import _result, configs, render

N_FRAMES = 30


def _frames(frames):
    return ((i / 30.0, {"image": img, "depth": d}) for i, (img, d) in enumerate(frames))


@pytest.fixture(scope="module")
def sweep():
    gt = synth.sweep_trajectory(N_FRAMES, step=0.15)
    return gt, render(gt)


@pytest.fixture(scope="module")
def results(sweep):
    gt, frames = sweep
    cfg_j, cfg_t = configs()
    t0 = time.perf_counter()
    js = JSystem(cfg_j)
    js.local_mapper.loop_closer = None
    tracked = js.run_sequence(_frames(frames), pipelined=True)
    jres = _result(tracked, js.tracker, gt, time.perf_counter() - t0)

    t0 = time.perf_counter()
    ts = System(cfg_t, device="cpu")
    tracked = ts.run_sequence(_frames(frames), pipelined=True)
    tres = _result(tracked, ts.tracker, gt, time.perf_counter() - t0)
    tres["system"] = ts
    return jres, tres


def test_both_track_within_the_gates(results):
    j, t = results
    assert j["tracked"] == N_FRAMES and t["tracked"] == N_FRAMES
    assert abs(j["kfs"] - t["kfs"]) <= 1, (j["kfs"], t["kfs"])
    assert j["ate"] <= 0.05 and t["ate"] <= 0.05, (j["ate"], t["ate"])
    assert t["ate"] <= 1.5 * j["ate"] and j["ate"] <= 1.5 * t["ate"], (j["ate"], t["ate"])


def test_the_mapper_ran(results):
    _, t = results
    lm = t["system"].local_mapper
    assert lm.counters["keyframes"] == t["kfs"] - 1 >= 2  # all but the first
    assert lm.counters["ba_solves"] >= 1 and lm.counters["fuse_merges"] > 0
    assert len(lm.stage_ms) == lm.counters["keyframes"]
    ms = np.array([r.track_ms for r in t["system"].metrics.records])
    assert len(ms) == N_FRAMES and (ms > 0).all()


MAP_ARRAYS = ("kf_valid", "kf_pose", "kf_pt", "pt_valid", "pt_xyz", "pt_desc")


def test_the_port_repeats_itself_bit_for_bit(sweep, results):
    _, frames = sweep
    first = results[1]["system"]
    _, cfg_t = configs()
    again = System(cfg_t, device="cpu")
    assert again.run_sequence(_frames(frames), pipelined=True) == N_FRAMES
    (ts_a, poses_a), (ts_b, poses_b) = first.tracker.trajectory(), again.tracker.trajectory()
    np.testing.assert_array_equal(ts_a, ts_b)
    np.testing.assert_array_equal(poses_a, poses_b)
    for name in MAP_ARRAYS:
        np.testing.assert_array_equal(getattr(first.map, name), getattr(again.map, name),
                                      err_msg=name)
    np.testing.assert_array_equal(first.map.covis_matrix(), again.map.covis_matrix())
    assert first.map.next_kf_id == again.map.next_kf_id


def test_async_mapping(sweep):
    gt, frames = sweep
    _, cfg_t = configs()
    slam = System(cfg_t, device="cpu", async_mapping=True)
    tracked = slam.run_sequence(_frames(frames), pipelined=True)
    slam.shutdown()
    assert tracked >= 0.9 * N_FRAMES
    assert slam.local_mapper.counters["keyframes"] >= 1
    mp = slam.map
    with mp.lock:
        bound = mp.kf_pt[mp.kf_valid]
        bound = bound[bound >= 0]
        assert mp.pt_valid[bound].all(), "torn state: dangling binding"
        assert np.isfinite(mp.kf_pose[mp.kf_valid]).all()
    ts, poses = slam.tracker.trajectory()
    assert len(ts) >= 0.9 * N_FRAMES and np.isfinite(poses).all()
