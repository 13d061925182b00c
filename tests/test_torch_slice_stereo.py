"""The stereo slice: the port's System against the JAX package's System on
a 30-frame stereo sweep (320x240, 500 features, the 0.5 m baseline of
bench.py scaled with the image; tests/torch_slice_common.run_systems), both
through run_sequence(pipelined=True) with the mapper inline.

The JAX side has the loop closer, which the port does not have yet,
switched off; both Systems build the default vocabulary, the keyframe
database and the relocalizer. The
right image is rendered as bench.py renders it. Every frame runs the second
extraction and `stereo_match` inside the fused frame, the first frame
initializes from the stereo depths, and the keyframes of the sweep run the
mapper with stereo observations (on this sequence it triangulates points,
which it never does on the RGB-D room).

Gates: both track all frames; keyframe counts within one; each metric ATE
within 1.5x of the other, and at most STEREO_ATE_CAP. At this size a
half-pixel of disparity is 4% of depth at 3 m: the JAX package itself reads
6.76 cm on the 0.15 m sweep of the RGB-D slice (3.1 cm there with depth
maps), 5.25 cm on the 0.12 m sweep used here (4 keyframes; the port 5.25
cm too) and 3.53 cm on a 0.10 m sweep that never leaves the first
keyframe. So the cap holds the port to the JAX run, not to the 3 cm of the
full-size sequence. Plus the first 12 frames synchronously through
`track_stereo`.
"""
import numpy as np
import pytest

from orbslam2_tpu_torch.io import synth
from orbslam2_tpu_torch.system import System
from orbslam2_tpu_torch.utils.evaluation import ate_rmse, camera_centers
from torch_slice_common import configs, render_sequence, run_systems

N_FRAMES = 30
STEP = 0.12
STEREO_ATE_CAP = 0.065


@pytest.fixture(scope="module")
def results():
    return run_systems(synth.sweep_trajectory(N_FRAMES, step=STEP), "STEREO",
                       with_scale=False)


def test_both_track_within_the_gates(results):
    j, t = results
    assert j["tracked"] == N_FRAMES and t["tracked"] == N_FRAMES
    assert j["first_ok"] == t["first_ok"] == 0
    assert abs(j["kfs"] - t["kfs"]) <= 1, (j["kfs"], t["kfs"])
    assert j["ate"] <= STEREO_ATE_CAP and t["ate"] <= STEREO_ATE_CAP, (j["ate"], t["ate"])
    assert t["ate"] <= 1.5 * j["ate"] and j["ate"] <= 1.5 * t["ate"], (j["ate"], t["ate"])


def test_the_stereo_mapper_ran(results):
    _, t = results
    slam = t["system"]
    lm = slam.local_mapper
    assert t["kfs"] >= 3
    assert lm.counters["keyframes"] >= 2 and lm.counters["ba_solves"] >= 1
    mp = slam.map
    kf = np.flatnonzero(mp.kf_valid)
    # stereo keyframes carry right-u measurements and depths
    assert ((mp.kf_ur[kf] >= 0).sum(1) > 100).all()
    assert ((mp.kf_depth[kf] > 0).sum(1) > 100).all()
    ms = np.array([r.track_ms for r in slam.metrics.records])
    assert len(ms) == N_FRAMES and (ms > 0).all()


def test_track_stereo_synchronously():
    """The entry point a live stereo camera drives, one frame at a time."""
    n = 12
    gt = synth.sweep_trajectory(N_FRAMES, step=STEP)[:n]
    slam = System(configs("STEREO")[1], device="cpu")
    poses = [slam.track_stereo(d["image"], d["right"], ts)
             for ts, d in render_sequence(gt, "STEREO")]
    assert all(p is not None and p.shape == (3, 4) for p in poses)
    assert slam.tracker.state.name == "OK"
    # metric scale comes from the baseline: no scale alignment
    ts, est = slam.tracker.trajectory()
    assert len(est) == n
    ate = ate_rmse(camera_centers(est), camera_centers(gt), with_scale=False)
    assert ate <= STEREO_ATE_CAP, ate
