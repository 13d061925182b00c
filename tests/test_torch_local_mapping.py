"""The port's LocalMapper against the JAX package's on one map, and the map
operations local mapping adds (map/mapstate.py).

The JAX tracker (mapper off) builds a map on the 30-frame 0.15 m sweep
(tests/torch_slice_common.py has the size); MapState.save writes it, the
JAX package loads it back and interop.map_from_numpy carries it into the
port. A fresh JAX LocalMapper and a fresh port LocalMapper each process the
newest keyframe (observation refinement, point culling, triangulation,
fuse, local BA, keyframe culling) on their own copy.

Tolerances: new-point counts within 2%; the keyframe-to-point bindings
(kf_pt) equal on >= 98% of the live keyframes' feature slots (a fuse merge
decided by an observation count near a tie, or a BA edge near its chi2
threshold, can differ); poses after local BA within 1e-3 (rotation
entries, translation in m); the same keyframes culled.
"""
import numpy as np
import pytest
import torch

from orbslam2_tpu.local_mapping import LocalMapper as JMapper
from orbslam2_tpu.map.mapstate import MapState as JMap
from orbslam2_tpu_torch import interop
from orbslam2_tpu_torch.local_mapping import LocalMapper as TMapper
from orbslam2_tpu_torch.map.mapstate import MapState as TMap
from torch_slice_common import configs, jax_sweep_map


def _copies(tmp_path):
    """(JAX map, port map) loaded from one saved npz of the sweep map."""
    cfg_j, cfg_t = configs()
    path = tmp_path / "sweep_map.npz"
    jax_sweep_map().save(path)
    return JMap.load(path, cfg_j), interop.map_from_numpy(np.load(path), cfg_t)


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    jmap, tmap = _copies(tmp_path_factory.mktemp("lm"))
    cfg_j, cfg_t = configs()
    k = int(np.flatnonzero(jmap.kf_valid)[-1])
    kfs_before = jmap.kf_valid.copy()
    jm, tm = JMapper(cfg_j, jmap), TMapper(cfg_t, tmap, device="cpu")
    jm.process(k)
    tm.process(k)
    return dict(jmap=jmap, tmap=tmap, jm=jm, tm=tm, k=k, kfs_before=kfs_before)


def test_new_points_and_bindings(mapped):
    jmap, tmap, jm, tm = mapped["jmap"], mapped["tmap"], mapped["jm"], mapped["tm"]
    n_j, n_t = len(jm.recent), tm.counters["points_created"]
    assert n_t == len(tm.recent)
    assert abs(n_t - n_j) <= 0.02 * max(n_j, 1), (n_t, n_j)
    assert abs(tmap.n_points - jmap.n_points) <= 0.02 * jmap.n_points
    live = jmap.kf_valid & tmap.kf_valid
    same = tmap.kf_pt[live] == jmap.kf_pt[live]
    assert same.mean() >= 0.98, same.mean()
    assert tm.counters["fuse_merges"] > 0 and tm.counters["ba_solves"] == 1


def test_poses_after_local_ba(mapped):
    jmap, tmap = mapped["jmap"], mapped["tmap"]
    live = jmap.kf_valid & tmap.kf_valid
    moved = np.abs(jmap.kf_pose[live] - jax_sweep_map().kf_pose[live]).max()
    assert moved > 1e-4  # the BA did move the window
    np.testing.assert_allclose(tmap.kf_pose[live], jmap.kf_pose[live], atol=1e-3)


def test_same_keyframes_culled(mapped):
    np.testing.assert_array_equal(mapped["tmap"].kf_valid, mapped["jmap"].kf_valid)
    culled = mapped["kfs_before"] & ~mapped["tmap"].kf_valid
    assert mapped["tm"].counters["kfs_culled"] == culled.sum()


def test_stage_times_recorded(mapped):
    (row,) = mapped["tm"].stage_ms
    assert row["kf"] == mapped["k"]
    assert all(row[s] >= 0 for s in ("prep", "newpts", "fuse", "ba", "cull", "loop"))


def test_hooks_not_ported_raise(tmp_path):
    """Every hook is taken now. A loop closer (ported since the loop-closing
    slice) runs last in `process`, after keyframe culling, on the keyframe
    just mapped, under the map lock, with its kernel launches counted as
    "loop"; the keyframe database and the BoW encoder are taken, and a
    keyframe registered through them is in the database with its gate
    nodes."""
    from orbslam2_tpu_torch.utils.metrics import current_caller
    _, cfg_t = configs()
    _, tmap = _copies(tmp_path)
    k = int(np.flatnonzero(tmap.kf_valid)[-1])
    seen = []

    class Closer:
        def process(self, kf):
            seen.append((kf, tmap.lock._is_owned(), current_caller()))

    lm = TMapper(cfg_t, tmap, loop_closer=Closer(), device="cpu")
    lm.process(k)
    assert seen == [(k, True, "loop")]
    assert lm.stage_ms[0]["loop"] >= 0
    mp = TMap(cfg_t, 512)
    calls = []

    class DB:
        def add(self, kf, vec):
            calls.append((kf, vec))

    class Encoder:
        def frame_bow(self, desc, valid):
            return "vec", np.arange(len(valid), dtype=np.int32)

    lm = TMapper(cfg_t, mp, kf_db=DB(), bow_encode=Encoder(), device="cpu")
    lm.register_keyframe(3)
    assert calls == [(3, "vec")] and lm.counters["kfs_registered"] == 1
    np.testing.assert_array_equal(mp.kf_bow_node[3], np.arange(512))
    TMapper(cfg_t, mp, device="cpu").register_keyframe(4)  # no database: nothing happens
    assert (mp.kf_bow_node[4] == -1).all()


@pytest.mark.parametrize("with_bow,with_refined", [(True, True), (True, False),
                                                   (False, True), (False, False)])
def test_prep_reads_bow_and_refinement_back_together(with_bow, with_refined):
    """The keyframe prep's one readback returns the BoW triple and the
    refinement's offsets as they were on the device, bit for bit."""
    rng = np.random.default_rng(4)
    words = rng.integers(0, 150000, 64).astype(np.int32)
    ok = rng.random(64) < 0.9
    nodes = rng.integers(-1, 133, 64).astype(np.int32)
    feats = np.arange(0, 40, 2)
    delta = rng.normal(0, 1, (20, 2)).astype(np.float32)
    r_ok = rng.random(20) < 0.5
    bow = tuple(torch.from_numpy(a) for a in (words, ok, nodes)) if with_bow else None
    refined = (feats, torch.from_numpy(delta), torch.from_numpy(r_ok)) if with_refined else None
    got_bow, got_refined = TMapper._fetch_prep(bow, refined)
    assert (got_bow is None) == (not with_bow) and (got_refined is None) == (not with_refined)
    if with_bow:
        for got, want in zip(got_bow, (words, ok, nodes)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    if with_refined:
        assert got_refined[0] is feats
        np.testing.assert_array_equal(got_refined[1], delta)
        np.testing.assert_array_equal(got_refined[2], r_ok)


def test_remove_keyframe_and_retired_pose(tmp_path):
    """remove_keyframe reparents the dead keyframe's children and records
    its pose relative to an anchor, on both packages alike; a frame whose
    reference keyframe was culled keeps a recoverable pose, also after the
    map crosses to the port."""
    jmap, tmap = _copies(tmp_path)
    kfs = np.flatnonzero(jmap.kf_valid)
    for mp in (jmap, tmap):
        mp.kf_parent[kfs[1:]] = kfs[:-1]  # a chain: k_i's parent is k_{i-1}
        mp.remove_keyframe(int(kfs[1]))
    np.testing.assert_array_equal(tmap.kf_parent, jmap.kf_parent)
    np.testing.assert_array_equal(tmap.kf_valid, jmap.kf_valid)
    assert tmap.kf_parent[kfs[2]] == kfs[0]  # adopted by the dead KF's parent
    (k, (anchor, T_rel)), = tmap.kf_retired.items()
    assert k == kfs[1] and anchor == jmap.kf_retired[k][0]
    np.testing.assert_allclose(T_rel, jmap.kf_retired[k][1], atol=1e-6)
    # the retired keyframe's pose resolves through its anchor, to its old pose
    np.testing.assert_allclose(tmap.resolve_kf_pose(k), jmap.resolve_kf_pose(k), atol=1e-6)
    np.testing.assert_allclose(tmap.resolve_kf_pose(k), jax_sweep_map().kf_pose[k],
                               atol=1e-5)
    # the retired chain crosses with the map
    path = tmp_path / "retired.npz"
    jmap.save(path)
    conv = interop.map_from_numpy(np.load(path), configs()[1])
    np.testing.assert_allclose(conv.resolve_kf_pose(k), jmap.resolve_kf_pose(k), atol=1e-6)


def test_remove_and_replace_points():
    _, cfg_t = configs()
    mp = TMap(cfg_t, 8)
    ids = mp.add_points(np.ones((4, 3), np.float32), np.zeros((4, 8), np.int32), 0, 0)
    pt = np.full(8, -1, np.int32)
    pt[:4] = ids
    for _ in range(2):
        mp.add_keyframe(np.eye(3, 4, dtype=np.float32), 0.0, 0,
                        np.zeros((8, 2), np.float32), np.zeros(8, np.int32),
                        np.zeros(8, np.float32), np.zeros((8, 8), np.int32),
                        np.ones(8, bool), pt)
    mp.kf_pt[1, 4] = ids[1]  # keyframe 1 sees point 1 twice
    mp.replace_point(int(ids[0]), int(ids[1]))
    assert not mp.pt_valid[ids[0]] and mp.pt_redirect[ids[0]] == ids[1]
    # both keyframes already saw the survivor: the old observation goes
    assert (mp.kf_pt[:2, 0] == -1).all()
    np.testing.assert_array_equal(mp.resolve_point_ids(np.asarray(ids[:2])), [ids[1]] * 2)
    mp.remove_points(ids[2:3])
    assert not (mp.kf_pt == ids[2]).any() and not mp.pt_valid[ids[2]]
    np.testing.assert_array_equal(mp.covisible_kfs(0), [1])
    assert len(mp.covisible_kfs(0, min_weight=1)) == 1
