"""Multi-session map merging (map_merge.py) in the port against the JAX
package's, on the CPU: two overlapping RGB-D sessions over the halves of a
sweep of the 320x240 room of torch_slice_common (40 frames at 0.15 m a
frame; session A frames 0-23, session B frames 16-39, B's world its own
first camera), each through a System with the mapper inline.

Parity: JAX's sessions are saved and loaded into a fresh System of each
package (load_map: the same map and database on both sides, checked against
JAX's live database), B's map loaded in each package, and both merges run
with JAX's Sim(3) draws (PRNGKey(77), split once per RANSAC attempt,
replayed into the port). Equal: the keyframe pair the alignment came from,
its RANSAC inliers, the keyframe and point counts after the merge. Within
1e-4 (m, rad): the aligning Sim(3) (f32 Horn fits on the same inputs, as
tests/test_torch_loop_ops.py holds the RANSAC). Within 1 mm and 0.01
degree: the merged keyframe poses after the merge's fuse and local BA (f32
sums in another order, ROADMAP queue 3).

End to end: the port's own two Systems and its own merge, under the gates
of tests/test_map_merge.py adapted to RGB-D: the alignment found, A holds
n_a + n_b keyframes from both halves, and the merged keyframes' metric ATE
within 1.5 times JAX's merge of its own sessions on the same cell (the
slice tests' rule; at this image size the mapper alone sits at several cm,
ROADMAP queue 3) and under the JAX test's 60 cm.
"""
import jax
import numpy as np
import pytest

import torch_slice_common as C
from orbslam2_tpu import map_merge as JMM
from orbslam2_tpu.map.mapstate import MapState as JMap
from orbslam2_tpu_torch import map_merge as TMM
from orbslam2_tpu_torch.io import synth
from orbslam2_tpu_torch.map.mapstate import MapState as TMap
from orbslam2_tpu_torch.utils.evaluation import ate_rmse, camera_centers
from test_torch_loop_ops import jax_minimal_sets

N_FRAMES, STEP, HALF_A, HALF_B = 40, 0.15, (0, 24), (16, 40)


def _sessions(System, items, **kw):
    out = []
    for first, end in (HALF_A, HALF_B):
        slam = System(C.configs()[0 if not kw else 1], **kw)
        slam.run_sequence(iter(items[first:end]), pipelined=False)
        slam.shutdown()
        out.append(slam)
    return out


def _ate(mp, gt):
    ids = mp.kf_ids
    fids = np.round(mp.kf_timestamp[ids] * 30).astype(int)
    return ate_rmse(camera_centers(mp.kf_pose[ids]), camera_centers(gt[fids]),
                    with_scale=False), fids


def _jax_merge(sys_a, map_b, monkeypatch):
    """JAX's merge_maps with the alignment and its RANSAC inliers recorded."""
    found, inliers = [], []
    find, ransac = JMM.find_cross_map_alignment, JMM.S3.sim3_ransac

    def find_rec(*args, **kw):
        found.append(find(*args, **kw))
        return found[-1]

    def ransac_rec(*args, **kw):
        res = ransac(*args, **kw)
        inliers.append(int(res.n_inliers))
        return res

    monkeypatch.setattr(JMM, "find_cross_map_alignment", find_rec)
    monkeypatch.setattr(JMM.S3, "sim3_ransac", ransac_rec)
    ok = JMM.merge_maps(sys_a, map_b)
    monkeypatch.undo()
    return ok, found[-1][1], inliers


@pytest.fixture(scope="module")
def cell():
    gt = synth.sweep_trajectory(N_FRAMES, step=STEP)
    return gt, C.render_sequence(gt, "RGBD")


@pytest.fixture(scope="module")
def jax_sessions(cell):
    from orbslam2_tpu.system import System as JSystem
    return _sessions(JSystem, cell[1])


def test_merge_matches_jax_on_the_same_maps(cell, jax_sessions, tmp_path, monkeypatch):
    from orbslam2_tpu.system import System as JSystem
    from orbslam2_tpu_torch.system import System
    ja, jb = jax_sessions
    cfg_j, cfg_t = C.configs()
    ja.save_map(tmp_path / "a.npz")
    jb.save_map(tmp_path / "b.npz")
    js, ts = JSystem(cfg_j), System(cfg_t, device="cpu")
    js.load_map(tmp_path / "a.npz")
    ts.load_map(tmp_path / "a.npz")
    np.testing.assert_array_equal(ts.kf_db.word_ids, ja.kf_db.word_ids)
    np.testing.assert_array_equal(ts.kf_db.weights, ja.kf_db.weights)
    np.testing.assert_array_equal(ts.kf_db.registered, ja.kf_db.registered)
    n_a, n_b = ja.map.n_keyframes, jb.map.n_keyframes

    ok, Wj, inliers_j = _jax_merge(js, JMap.load(tmp_path / "b.npz", cfg_j), monkeypatch)
    key = [jax.random.PRNGKey(TMM.SEED)]

    def replay(valid):
        key[0], sub = jax.random.split(key[0])
        return jax_minimal_sets(sub, valid)

    Wt = TMM.merge_maps(ts, TMap.load(tmp_path / "b.npz", cfg_t), minimal_sets=replay)
    assert ok and Wt is not None
    assert (Wt["ka"], Wt["kb"]) == (Wj["ka"], Wj["kb"])
    assert Wt["n_inliers"] == inliers_j[-1] >= 20
    assert Wt["s"] == pytest.approx(float(Wj["s"]), abs=1e-4)
    np.testing.assert_allclose(Wt["R"], Wj["R"], atol=1e-4)
    np.testing.assert_allclose(Wt["t"], Wj["t"], atol=1e-4)
    assert ts.map.n_keyframes == js.map.n_keyframes == n_a + n_b
    assert ts.map.n_points == js.map.n_points
    np.testing.assert_array_equal(ts.map.kf_ids, js.map.kf_ids)
    for k in ts.map.kf_ids:
        Tt, Tj = ts.map.kf_pose[k].astype(np.float64), js.map.kf_pose[k].astype(np.float64)
        assert np.linalg.norm(camera_centers(Tt[None]) - camera_centers(Tj[None])) < 1e-3
        dR = Tt[:, :3] @ Tj[:, :3].T
        assert np.degrees(np.linalg.norm([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                                          dR[1, 0] - dR[0, 1]]) / 2) < 0.01
    # B's parent chain hangs on the aligned keyframe of A
    new = ts.map.kf_ids[n_a:]
    np.testing.assert_array_equal(ts.map.kf_parent[new], js.map.kf_parent[new])
    assert (ts.map.kf_parent[new] >= 0).all()


def test_port_sessions_merge_end_to_end(cell, jax_sessions, monkeypatch):
    """tests/test_map_merge.py's gates on the port's own sessions."""
    from orbslam2_tpu_torch.system import System
    gt, items = cell
    ja, jb = jax_sessions
    ok, _, _ = _jax_merge(ja, jb.map, monkeypatch)
    assert ok
    jax_ate, _ = _ate(ja.map, gt)
    sys_a, sys_b = _sessions(System, items, device="cpu")
    n_a, n_b = sys_a.map.n_keyframes, sys_b.map.n_keyframes
    assert n_a >= 1 and n_b >= 1
    W = TMM.merge_maps(sys_a, sys_b.map)
    assert W is not None, "cross-map alignment not found"
    assert W["s"] == 1.0  # RGB-D: fixed scale
    assert sys_a.map.n_keyframes == n_a + n_b
    ate, fids = _ate(sys_a.map, gt)
    assert np.isfinite(ate) and ate <= min(1.5 * jax_ate, 0.6), (ate, jax_ate)
    assert fids.min() <= 2 and fids.max() >= HALF_B[0] + 4, fids
