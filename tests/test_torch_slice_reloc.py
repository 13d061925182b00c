"""The relocalization slice, end to end, in both packages: the 320x240 RGB-D
room of torch_slice_common through the JAX package's System and the port's
(both with the default vocabulary, keyframe database and relocalizer on, the
mapper inline, JAX's loop closer off): a 30-frame sweep, a blackout of three
blank frames, a revisit of an early viewpoint with new noise, then
localization mode.

Held: both go LOST and both relocalize on the same revisit frame, within 4;
every keyframe is registered, and keyframes of the same frame carry the same
gate nodes; the relocalized camera centres agree within 2 mm and the
rotations within 0.05 degrees (two maps after their local BAs, then LM
solves in f32; seen: 0.03 mm, 0.0002 degrees) and lie within 10 cm of the
ground truth at this image size (seen: 5.2 cm in both); localization mode tracks every frame, uses the temporal
points, and adds no keyframe and no point. The port's PnP replays JAX's
draws."""
import jax
import numpy as np
import pytest

import torch_slice_common as C
from orbslam2_tpu_torch.io import synth
from test_torch_pnp import jax_minimal_sets, rot_deg

N_FRAMES, REVISIT, N_LOC = 30, 5, 8


def drive(slam, items, gt, scene):
    out = dict(system=slam)
    out["tracked"] = slam.run_sequence(iter(items), pipelined=False)
    slam.shutdown()
    out["kfs"] = slam.map.n_keyframes
    blank = np.full((C.H, C.W), 128, np.uint8)
    t = N_FRAMES / 30.0
    for _ in range(3):
        slam.track_rgbd(blank, items[0][1]["depth"], t)
        t += 1 / 30.0
    out["state_after_blackout"] = slam.tracking_state.name
    out["reloc_frame"], out["pose"] = None, None
    for j in range(4):
        img = np.clip(synth.render_room(scene, gt[REVISIT], seed=999 + j), 0, 255)
        pose = slam.track_rgbd(img.astype(np.uint8), synth.depth_room(scene, gt[REVISIT]), t)
        t += 1 / 30.0
        if pose is not None:
            out["reloc_frame"], out["pose"] = j, pose
            break
    slam.activate_localization_mode()
    before = (slam.map.n_keyframes, slam.map.n_points)
    out["loc_tracked"] = 0
    for i in range(REVISIT + 1, REVISIT + 1 + N_LOC):
        img = np.clip(synth.render_room(scene, gt[i], seed=2000 + i), 0, 255)
        out["loc_tracked"] += slam.track_rgbd(
            img.astype(np.uint8), synth.depth_room(scene, gt[i]), t) is not None
        t += 1 / 30.0
    out["map_unchanged"] = before == (slam.map.n_keyframes, slam.map.n_points)
    return out


@pytest.fixture(scope="module")
def results():
    from orbslam2_tpu.system import System as JSystem
    from orbslam2_tpu_torch.system import System
    cfg_j, cfg_t = C.configs()
    gt = synth.sweep_trajectory(N_FRAMES, step=0.15)
    items = C.render_sequence(gt, "RGBD")
    f = 500.0 * C.W / 640
    scene = synth.make_room(seed=0, width=C.W, height=C.H, fx=f, fy=f)
    js = JSystem(cfg_j)
    js.local_mapper.loop_closer = None
    ts = System(cfg_t, device="cpu")
    key = [jax.random.PRNGKey(17)]

    def replay(valid):
        key[0], sub = jax.random.split(key[0])
        return jax_minimal_sets(sub, valid)

    ts.relocalizer.minimal_sets = replay
    return drive(js, items, gt, scene), drive(ts, items, gt, scene), gt


def test_both_track_the_sweep_and_register_every_keyframe(results):
    j, t, _ = results
    assert j["tracked"] == t["tracked"] == N_FRAMES
    assert abs(j["kfs"] - t["kfs"]) <= 1 and t["kfs"] >= 3
    for r in (j, t):
        mp, db = r["system"].map, r["system"].kf_db
        live = mp.kf_ids
        assert db.registered[live].all()
        assert ((mp.kf_bow_node[live] >= 0).sum(1) > 300).all()
    lm = t["system"].local_mapper
    assert lm.counters["kfs_registered"] == lm.counters["keyframes"] + 1
    assert all("bow" in row and 0 <= row["bow"] <= row["prep"] for row in lm.stage_ms)


def test_keyframes_of_the_same_frame_have_the_same_gate_nodes(results):
    j, t, _ = results
    jm, tm = j["system"].map, t["system"].map
    by_frame = {int(jm.kf_frame_id[k]): int(k) for k in jm.kf_ids}
    shared = [(by_frame[int(tm.kf_frame_id[k])], int(k)) for k in tm.kf_ids
              if int(tm.kf_frame_id[k]) in by_frame]
    assert len(shared) >= 2
    for kj, kt in shared:
        np.testing.assert_array_equal(tm.kf_bow_node[kt], jm.kf_bow_node[kj])
        jw, tw = j["system"].kf_db.word_ids[kj], t["system"].kf_db.word_ids[kt]
        np.testing.assert_array_equal(tw, jw)


def test_both_go_lost_and_relocalize_on_the_same_frame(results):
    j, t, gt = results
    assert j["state_after_blackout"] == t["state_after_blackout"] == "LOST"
    assert j["reloc_frame"] is not None and t["reloc_frame"] == j["reloc_frame"] <= 3
    centre = lambda T: -T[:, :3].T @ T[:, 3]  # noqa: E731
    assert np.linalg.norm(centre(t["pose"]) - centre(j["pose"])) <= 0.002
    assert rot_deg(t["pose"][:, :3], j["pose"][:, :3]) <= 0.05
    world = np.linalg.inv(np.vstack([gt[0], [0, 0, 0, 1]]))
    truth = (np.vstack([gt[REVISIT], [0, 0, 0, 1]]) @ world)[:3]
    for r in (j, t):
        assert np.linalg.norm(centre(r["pose"]) - centre(truth)) <= 0.10
    a = t["system"].relocalizer.attempts
    assert [x["ok"] for x in a][-1] and a[-1]["tried"][-1]["final_inliers"] >= 50
    assert t["system"].tracker.last_reloc_frame_id >= N_FRAMES + 3


def test_localization_mode_tracks_and_freezes_the_map(results):
    j, t, _ = results
    for r in (j, t):
        assert r["loc_tracked"] == N_LOC and r["map_unchanged"]
        assert r["system"].localization_mode_active
    assert t["system"].tracker.n_temporal_frames > 0
