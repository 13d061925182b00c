"""The whole slice: the port's System (RGB-D, mapper off, CPU) against the
JAX package's tracker on the same 20-frame room orbit (tests/
torch_slice_common.py has the size and why).

Gates, as README "Accuracy" states them for RGB-D: both track every frame,
both have a metric ATE of at most 3 cm, and neither ATE is more than 1.5x
the other's. The first five poses agree within 1e-3 (rotation entries,
translation in m): same algorithm, f32 sums in another order. The maps agree
as well (the JAX map converted with interop.map_from_numpy).
"""
import numpy as np
import pytest

from orbslam2_tpu_torch import interop
from orbslam2_tpu_torch.io import synth
from torch_slice_common import configs, run_both

N_FRAMES = 20


@pytest.fixture(scope="module")
def results():
    return run_both(synth.orbit_trajectory(N_FRAMES))


def test_both_track_every_frame_within_the_ate_gates(results):
    j, t = results
    assert j["tracked"] == N_FRAMES and t["tracked"] == N_FRAMES
    assert j["ate"] <= 0.03 and t["ate"] <= 0.03, (j["ate"], t["ate"])
    assert t["ate"] <= 1.5 * j["ate"] and j["ate"] <= 1.5 * t["ate"]


def test_first_poses_agree(results):
    j, t = results
    np.testing.assert_allclose(t["poses"][:5], j["poses"][:5], atol=1e-3)


def test_maps_agree(results, tmp_path):
    """The JAX map, saved as its npz and loaded into the port's MapState,
    matches the map the port built itself."""
    j, t = results
    jmap, tmap = j["tracker"].map, t["tracker"].map
    path = tmp_path / "jax_map.npz"
    jmap.save(path)
    conv = interop.map_from_numpy(np.load(path), configs()[1])
    assert conv.n_keyframes == tmap.n_keyframes == jmap.n_keyframes
    assert conv.n_points == tmap.n_points
    np.testing.assert_array_equal(conv.pt_valid, tmap.pt_valid)
    np.testing.assert_allclose(conv.kf_pose[conv.kf_valid], tmap.kf_pose[tmap.kf_valid],
                               atol=1e-3)
    live = tmap.pt_valid
    np.testing.assert_allclose(conv.pt_xyz[live], tmap.pt_xyz[live], atol=1e-2)
    same = np.all(conv.pt_desc[live] == tmap.pt_desc[live], axis=1)
    assert same.mean() >= 0.99
    np.testing.assert_array_equal(interop.desc_i32_to_u32(conv.pt_desc), jmap.pt_desc)


def test_trajectory_file(results, tmp_path):
    _, t = results
    path = tmp_path / "traj.txt"
    t["system"].save_trajectory_tum(path)
    rows = np.loadtxt(path)
    assert rows.shape == (N_FRAMES, 8)
    np.testing.assert_allclose(rows[:, 0], np.arange(N_FRAMES) / 30.0, atol=1e-6)
