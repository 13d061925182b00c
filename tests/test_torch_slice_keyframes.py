"""Keyframe creation in the slice: a fast sideways sweep (0.15 m a frame)
leaves the first keyframe's view, so both trackers run NeedNewKeyFrame's
insert branch, CreateNewKeyFrame's pose polish and the close-depth point
spawning (tracking._create_keyframe, _spawn_depth_points) on the same
frames (tests/torch_slice_common.py has the size).

Gates: both track every frame with a metric ATE of at most 3 cm, both make
at least 2 keyframes, and the keyframe counts agree within one (a decision
near a ratio threshold may fall one frame later on one side).
"""
import numpy as np
import pytest

from orbslam2_tpu_torch.io import synth
from torch_slice_common import run_both

N_FRAMES = 30


@pytest.fixture(scope="module")
def results():
    return run_both(synth.sweep_trajectory(N_FRAMES, step=0.15))


def test_keyframes_created_on_both(results):
    j, t = results
    assert j["tracked"] == N_FRAMES and t["tracked"] == N_FRAMES
    assert j["kfs"] >= 2 and t["kfs"] >= 2
    assert abs(j["kfs"] - t["kfs"]) <= 1, (j["kfs"], t["kfs"])
    assert j["ate"] <= 0.03 and t["ate"] <= 0.03, (j["ate"], t["ate"])


def test_spawned_points_are_live_and_observed(results):
    """Every keyframe's observations point at live map points, and the
    spawned points grow the map beyond the first keyframe's."""
    _, t = results
    mp = t["tracker"].map
    obs = mp.kf_pt[mp.kf_valid]
    assert mp.pt_valid[obs[obs >= 0]].all()
    first = (mp.kf_pt[0] >= 0).sum()
    assert mp.n_points > first
    assert np.isfinite(mp.pt_xyz[mp.pt_valid]).all()
