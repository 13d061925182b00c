"""The monocular slice: the port's System against the JAX package's System
on the 30-frame room orbit (320x240, 500 features, doubled during
initialization; tests/torch_slice_common.run_systems), both through
run_sequence(pipelined=True) with the mapper inline.

The JAX side has the loop closer, which the port does not have yet,
switched off; both Systems build the default vocabulary, the keyframe
database and the relocalizer. Both
initialize by the fused step (`mono_init_step`, one attempt a frame), build
the initial map with its two-keyframe BA and median-depth scale, and then
track; every map point after initialization comes from the mapper's
triangulation (`map_new_points`), which the RGB-D room never exercises.

The two packages draw different RANSAC sets (threefry keys against a
torch.Generator), but the refits on the inliers forget the draws: both
initialize on the same frame with the same map (`test_initial_maps_agree`:
pose within 1e-4, the same points), and track alike until the first local
BA. From there they part: with one camera fixed a monocular BA leaves the
scale free, both solvers reach the same cost (to 1e-4 relative) at scales a
few percent apart, and the trajectories differ from then on. So the whole
runs are compared on gates: both initialize, the first OK frame within 3
frames of the other's, at least 90% of the later frames tracked, each
Sim(3)-aligned ATE within 2x of the other and at most MONO_ATE_CAP, and the
port's mapper triangulated points. At this size and length (26 tracked
frames) the JAX package reads 4.8 cm pipelined and 5.9 cm synchronously,
the port 6.2 to 7.3 cm and 6.2 to 6.6 cm depending on the number of CPU
threads: the gates hold the port to the JAX run, not to the 2 cm of the
full-size sequence.
"""
import numpy as np
import pytest

from orbslam2_tpu_torch.io import synth
from orbslam2_tpu_torch.system import System
from torch_slice_common import configs, render_sequence, run_systems

N_FRAMES = 30
MONO_ATE_CAP = 0.10


@pytest.fixture(scope="module")
def results():
    return run_systems(synth.orbit_trajectory(N_FRAMES), "MONOCULAR", with_scale=True)


def test_both_initialize_and_track_within_the_gates(results):
    j, t = results
    for r in (j, t):
        assert r["first_ok"] <= 8, r["first_ok"]  # tests/test_slam_e2e.py: within 8
        later = N_FRAMES - r["first_ok"]
        assert r["tracked"] >= 0.9 * later, (r["tracked"], later)
        assert r["ate"] <= MONO_ATE_CAP, r["ate"]
    assert abs(j["first_ok"] - t["first_ok"]) <= 3, (j["first_ok"], t["first_ok"])
    assert t["ate"] <= 2 * j["ate"] and j["ate"] <= 2 * t["ate"], (j["ate"], t["ate"])


def test_the_mapper_triangulated(results):
    j, t = results
    slam = t["system"]
    lm = slam.local_mapper
    assert lm.counters["points_created"] > 0
    assert lm.counters["ba_solves"] >= 2  # the initial map's BA, then local BA
    assert t["kfs"] >= 3 and abs(t["kfs"] - j["kfs"]) <= 2, (t["kfs"], j["kfs"])
    assert t["points"] > 300
    mp = slam.map
    kf = np.flatnonzero(mp.kf_valid)
    assert (mp.kf_ur[kf] < 0).all()  # no right-u measurement anywhere
    # the median scene depth of the first keyframe alive is of order 1: the
    # initial map was scaled to a median depth of 1
    k = kf[0]
    pts = mp.kf_pt[k][mp.kf_pt[k] >= 0]
    pc = mp.pt_xyz[pts] @ mp.kf_pose[k, :, :3].T + mp.kf_pose[k, :, 3]
    assert 0.5 < np.median(pc[:, 2]) < 2.0


def test_init_frames_record_not_initialized(results):
    _, t = results
    states = t["states"]
    assert len(states) == N_FRAMES
    assert set(states[:t["first_ok"]]) == {"NOT_INITIALIZED"}
    assert states[-1] == "OK"


def test_initial_maps_agree(results):
    """Frame by frame through both track_monocular until both are OK: the
    same init frame, the same pose of it (1e-4) and the same initial map."""
    from orbslam2_tpu.system import System as JSystem
    cfg_j, cfg_t = configs("MONOCULAR")
    js = JSystem(cfg_j)
    js.local_mapper.loop_closer = None
    ts = System(cfg_t, device="cpu")
    for stamp, d in render_sequence(synth.orbit_trajectory(N_FRAMES)[:9], "MONOCULAR"):
        pj, pt = js.track_monocular(d["image"], stamp), ts.track_monocular(d["image"], stamp)
        assert (pj is None) == (pt is None), stamp
        if pj is not None:
            break
    assert pj is not None and round(stamp * 30) == results[1]["first_ok"]
    np.testing.assert_allclose(pt, pj, atol=1e-4)
    assert js.map.n_keyframes == ts.map.n_keyframes == 2
    assert js.map.n_points == ts.map.n_points > 100
    ids = np.flatnonzero(js.map.pt_valid)
    np.testing.assert_array_equal(ids, np.flatnonzero(ts.map.pt_valid))
    rel = (np.abs(ts.map.pt_xyz[ids] - js.map.pt_xyz[ids]).max(-1)
           / np.abs(js.map.pt_xyz[ids, 2]))
    assert np.median(rel) < 1e-3 and (rel < 1e-2).mean() >= 0.99


def test_track_monocular_synchronously():
    """The entry point a live camera drives: initialized and OK at the end."""
    n = 14
    gt = synth.orbit_trajectory(N_FRAMES)[:n]
    slam = System(configs("MONOCULAR")[1], device="cpu")
    poses = [slam.track_monocular(d["image"], ts)
             for ts, d in render_sequence(gt, "MONOCULAR")]
    assert slam.tracker.state.name == "OK"
    first = next(i for i, p in enumerate(poses) if p is not None)
    assert first <= 8 and all(p is not None for p in poses[first:])
    assert slam.map.n_keyframes >= 2
