"""Map checkpoints and the rest of the port's System API against the JAX
package's, on the CPU: the 320x240 RGB-D room of torch_slice_common, a
30-frame sweep (0.15 m a frame) through each package's System with the
mapper inline.

Held exactly: the port's save/load round trip on every field; the files of
both packages (a map saved by one loads in the other's MapState.load with
every array, dtype and id counter equal to the other's own save of the same
map); the keyframe database that load_map rebuilds (JAX's word vectors and
gate nodes for the same file); the trajectory writers (JAX's text for the
same poses). A System loaded from a file keeps the keyframe and point
counts, starts LOST and relocalizes at a mapped viewpoint within 3 frames,
the camera within 10 cm of the ground truth as in
tests/test_torch_slice_reloc.py (this image size); request_reset is applied
at the next track_* call.
"""
import numpy as np
import pytest

import torch_slice_common as C
from orbslam2_tpu.io import trajectory as jtraj
from orbslam2_tpu.map.mapstate import MapState as JMap
from orbslam2_tpu_torch import interop
from orbslam2_tpu_torch.io import synth
from orbslam2_tpu_torch.io import trajectory as ttraj
from orbslam2_tpu_torch.map.mapstate import MapState as TMap

N_FRAMES, REVISIT = 30, 5


@pytest.fixture(scope="module")
def sessions():
    """(JAX System, port System, ground truth, items) after the sweep."""
    from orbslam2_tpu.system import System as JSystem
    from orbslam2_tpu_torch.system import System
    cfg_j, cfg_t = C.configs()
    gt = synth.sweep_trajectory(N_FRAMES, step=0.15)
    items = C.render_sequence(gt, "RGBD")
    js, ts = JSystem(cfg_j), System(cfg_t, device="cpu")
    for slam in (js, ts):
        slam.run_sequence(iter(items), pipelined=False)
        slam.shutdown()
    assert ts.map.n_keyframes >= 2 and js.map.n_keyframes >= 2
    return js, ts, gt, items


def _fields(mp, package: str) -> dict:
    """Every checkpointed array (descriptors as uint32 words), the id
    counters, the free point slots and the retired keyframes."""
    out = {k: getattr(mp, k) for k in mp._ARRAY_FIELDS}
    if package == "port":
        for k in ("kf_desc", "pt_desc"):
            out[k] = interop.desc_i32_to_u32(out[k])
    out["next_kf_id"], out["next_pt_id"] = mp.next_kf_id, mp.next_pt_id
    out["free"] = sorted(mp._pt_free)
    out["retired"] = {k: (a, np.asarray(T)) for k, (a, T) in mp.kf_retired.items()}
    return out


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if k == "retired":
            assert a[k].keys() == b[k].keys()
            for r in a[k]:
                assert a[k][r][0] == b[k][r][0]
                np.testing.assert_array_equal(a[k][r][1], b[k][r][1])
        elif isinstance(a[k], np.ndarray):
            assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_save_load_round_trip_is_exact(sessions, tmp_path):
    _, ts, _, _ = sessions
    ts.save_map(tmp_path / "map.npz")
    back = TMap.load(tmp_path / "map.npz", ts.cfg)
    mine = _fields(ts.map, "port")
    # a live map's freed slots sit in quarantine first; a loaded map frees
    # them at once
    mine["free"] = [int(i) for i in np.flatnonzero(~ts.map.pt_valid[:ts.map.next_pt_id])]
    _assert_same(_fields(back, "port"), mine)
    assert back._dirty_pts is None and back.pt_redirect.shape == back.pt_valid.shape


def test_files_load_in_either_package(sessions, tmp_path):
    """JAX's map carried into the port (interop.map_from_numpy) and saved
    there gives the file JAX saves; the port's map saved and read by JAX,
    saved by JAX and read back by the port is the port's map."""
    js, ts, _, _ = sessions
    cfg_j, cfg_t = C.configs()
    js.save_map(tmp_path / "jax.npz")
    arrays = {k: getattr(js.map, k) for k in js.map._ARRAY_FIELDS}
    arrays.update(n_feat=js.map.n_feat, next_kf_id=js.map.next_kf_id,
                  next_pt_id=js.map.next_pt_id,
                  retired_k=list(js.map.kf_retired),
                  retired_anchor=[a for a, _ in js.map.kf_retired.values()],
                  retired_T=[T for _, T in js.map.kf_retired.values()])
    interop.map_from_numpy(arrays, cfg_t).save(tmp_path / "port.npz")
    with np.load(tmp_path / "jax.npz") as zj, np.load(tmp_path / "port.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert (zj[k].dtype, zj[k].shape) == (zt[k].dtype, zt[k].shape), k
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    _assert_same(_fields(JMap.load(tmp_path / "port.npz", cfg_j), "jax"),
                 _fields(JMap.load(tmp_path / "jax.npz", cfg_j), "jax"))
    _assert_same(_fields(TMap.load(tmp_path / "jax.npz", cfg_t), "port"),
                 _fields(TMap.load(tmp_path / "port.npz", cfg_t), "port"))
    # the other way round: the port's own map through a JAX save
    ts.save_map(tmp_path / "port_own.npz")
    JMap.load(tmp_path / "port_own.npz", cfg_j).save(tmp_path / "via_jax.npz")
    _assert_same(_fields(TMap.load(tmp_path / "via_jax.npz", cfg_t), "port"),
                 _fields(TMap.load(tmp_path / "port_own.npz", cfg_t), "port"))


def test_loaded_database_matches_jax(sessions, tmp_path):
    """load_map registers every keyframe: the database holds JAX's word
    vectors and gate nodes for the same file."""
    from orbslam2_tpu.system import System as JSystem
    from orbslam2_tpu_torch.system import System
    _, ts, _, _ = sessions
    cfg_j, cfg_t = C.configs()
    ts.save_map(tmp_path / "map.npz")
    jl, tl = JSystem(cfg_j), System(cfg_t, device="cpu")
    jl.load_map(tmp_path / "map.npz")
    tl.load_map(tmp_path / "map.npz")
    live = tl.map.kf_ids
    assert tl.kf_db.registered[live].all() and tl.local_mapper.counters[
        "kfs_registered"] == len(live)
    np.testing.assert_array_equal(tl.kf_db.registered, jl.kf_db.registered)
    np.testing.assert_array_equal(tl.kf_db.word_ids, jl.kf_db.word_ids)
    np.testing.assert_array_equal(tl.kf_db.weights, jl.kf_db.weights)
    np.testing.assert_array_equal(tl.map.kf_bow_node, jl.map.kf_bow_node)
    assert tl.tracker.ref_kf == jl.tracker.ref_kf == int(live[-1])


def test_loaded_map_relocalizes(sessions, tmp_path):
    """tests/test_loop_closure_e2e.py::TestMapCheckpoint at the test size."""
    from orbslam2_tpu_torch.system import System
    _, ts, gt, items = sessions
    n_kf, n_pt = ts.map.n_keyframes, ts.map.n_points
    ts.save_map(tmp_path / "map.npz")
    fresh = System(ts.cfg, device="cpu")
    fresh.load_map(tmp_path / "map.npz")
    assert (fresh.map.n_keyframes, fresh.map.n_points) == (n_kf, n_pt)
    assert fresh.tracking_state.name == "LOST"
    f = 500.0 * C.W / 640
    scene = synth.make_room(seed=0, width=C.W, height=C.H, fx=f, fy=f)
    depth = items[REVISIT][1]["depth"]
    pose = None
    for j in range(3):
        img = np.clip(synth.render_room(scene, gt[REVISIT], seed=500 + j), 0, 255)
        pose = fresh.track_rgbd(img.astype(np.uint8), depth, (N_FRAMES + j) / 30.0)
        if pose is not None:
            break
    assert pose is not None, "no relocalization against the loaded map in 3 frames"
    # the map's world is the first camera of the sweep
    se3 = [np.vstack([T, [0, 0, 0, 1]]).astype(np.float64) for T in (gt[REVISIT], gt[0])]
    truth = (se3[0] @ np.linalg.inv(se3[1]))[:3]

    def centre(T):
        return -T[:, :3].T @ T[:, 3]
    assert np.linalg.norm(centre(pose) - centre(truth)) < 0.10
    assert fresh.tracking_state.name == "OK"


def test_trajectory_writers_match_jax(sessions, tmp_path):
    _, ts, _, _ = sessions
    ts.save_keyframe_trajectory_tum(tmp_path / "kf.txt")
    ids = ts.map.kf_ids
    order = ids[np.argsort(ts.map.kf_timestamp[ids])]
    jtraj.save_tum(tmp_path / "kf_jax.txt", ts.map.kf_timestamp[order],
                   ts.map.kf_pose[order])
    assert (tmp_path / "kf.txt").read_text() == (tmp_path / "kf_jax.txt").read_text()
    ts.save_trajectory_kitti(tmp_path / "kitti.txt")
    stamps, poses = ts.tracker.trajectory()
    jtraj.save_kitti(tmp_path / "kitti_jax.txt", poses)
    assert (tmp_path / "kitti.txt").read_text() == (tmp_path / "kitti_jax.txt").read_text()
    assert len((tmp_path / "kitti.txt").read_text().splitlines()) == N_FRAMES
    ts.save_trajectory_tum(tmp_path / "cam.txt")
    for got, want in zip(ttraj.load_tum(tmp_path / "cam.txt"),
                         jtraj.load_tum(tmp_path / "cam.txt")):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(ttraj.load_tum(tmp_path / "cam.txt")[0], stamps, atol=1e-6)


def test_request_reset_is_applied_at_the_next_frame(sessions):
    from orbslam2_tpu_torch.system import System
    _, _, _, items = sessions
    s = System(C.configs()[1], device="cpu")
    ts0, d0 = items[0]
    s.track_rgbd(d0["image"], d0["depth"], ts0)
    old = s.map
    assert old.n_keyframes == 1
    s.request_reset()
    assert s.map is old and s.tracking_state.name == "OK"
    ts1, d1 = items[1]
    s.track_rgbd(d1["image"], d1["depth"], ts1)
    # the reset ran first: the frame initialized a new map
    assert s.map is not old and s.map.n_keyframes == 1 and not s._reset_pending
    assert s.tracker.map is s.map and len(s.tracker.trajectory()[0]) == 1
