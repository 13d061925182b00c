"""The port's keyframe database (map/keyframe_db.py, host numpy) on the cases
of tests/test_place_recognition.py, and against the JAX package's database on
seeded data: the same candidates in the same order, for relocalization and
for loop detection (which only this test reaches until loop closing is
ported). Scores agree to 1e-6."""
import numpy as np
import pytest

from orbslam2_tpu.config import SlamConfig as JCfg
from orbslam2_tpu.map.keyframe_db import KeyFrameDatabase as JDB
from orbslam2_tpu.map.mapstate import MapState as JMap
from orbslam2_tpu_torch import interop
from orbslam2_tpu_torch.config import SlamConfig as TCfg
from orbslam2_tpu_torch.map.keyframe_db import KeyFrameDatabase as TDB
from orbslam2_tpu_torch.map.keyframe_db import to_sparse_bow
from orbslam2_tpu_torch.map.mapstate import MapState as TMap

N = 64


def world(n_words, port=True):
    cfg = (TCfg if port else JCfg)(max_keyframes=16, max_points=256)
    mp = (TMap if port else JMap)(cfg, N)
    return cfg, mp, (TDB if port else JDB)(cfg, mp, n_words=n_words)


def add_kf(mp, fid, port=True, pts=None):
    pose = np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32)
    return mp.add_keyframe(
        pose, 0.0, fid, np.zeros((N, 2), np.float32), np.zeros(N, np.int32),
        np.zeros(N, np.float32), np.zeros((N, 8), np.int32 if port else np.uint32),
        np.ones(N, bool), np.full(N, -1, np.int32) if pts is None else pts)


def dense(words, n=100):
    v = np.zeros(n, np.float32)
    v[words] = 1.0 / len(words)
    return v


def test_reloc_candidates_prefer_shared_words():
    _, mp, db = world(100)
    a, b = add_kf(mp, 0), add_kf(mp, 1)
    db.add(a, dense([1, 2, 3, 4]))
    db.add(b, dense([50, 51, 52, 53]))
    q = np.zeros(100, np.float32)
    q[[1, 2, 3, 9]] = 0.25
    cands = db.detect_reloc_candidates(q)
    assert a in cands and b not in cands


def test_erase_removes_candidate():
    _, mp, db = world(100)
    a = add_kf(mp, 0)
    db.add(a, dense([1, 2, 3]))
    db.erase(a)
    assert len(db.detect_reloc_candidates(dense([1, 2, 3]))) == 0
    assert not db.registered[a] and (db.word_ids[a] == -1).all()


def test_storage_independent_of_vocab_size():
    small, big = world(1000)[2], world(1_000_000)[2]
    assert small.word_ids.nbytes == big.word_ids.nbytes < 1 << 20


def test_million_word_queries():
    _, mp, db = world(1_000_000)
    a, b = add_kf(mp, 0), add_kf(mp, 1)
    db.add(a, (np.array([10, 999_000, 500_000, 123_456]), np.full(4, 0.25, np.float32)))
    db.add(b, (np.array([7, 8, 9, 11]), np.full(4, 0.25, np.float32)))
    cands = db.detect_reloc_candidates(
        (np.array([10, 999_000, 500_000]), np.full(3, 1 / 3, np.float32)))
    assert a in cands and b not in cands


def test_sparse_scores_match_dense_l1():
    rng = np.random.default_rng(0)
    _, mp, db = world(500)
    rows = []
    for fid in range(4):
        words = np.sort(rng.choice(500, 20, replace=False))
        wt = rng.random(20).astype(np.float32)
        wt /= wt.sum()
        db.add(add_kf(mp, fid), (words, wt))
        v = np.zeros(500, np.float32)
        v[words] = wt
        rows.append(v)
    qw = np.sort(rng.choice(500, 15, replace=False))
    qv = rng.random(15).astype(np.float32)
    qv /= qv.sum()
    qd = np.zeros(500, np.float32)
    qd[qw] = qv
    common, scores = db._common_and_scores(qw, qv)
    for k, v in enumerate(rows):
        np.testing.assert_allclose(scores[k], 1.0 - 0.5 * np.abs(qd - v).sum(), atol=1e-6)
        assert common[k] == ((v > 0) & (qd > 0)).sum()


def test_add_keeps_the_heaviest_words_beyond_capacity():
    cfg, mp, _ = world(1000)
    db = TDB(cfg, mp, n_words=1000, max_words_per_kf=8)
    k = add_kf(mp, 0)
    w = np.arange(20, dtype=np.int64)
    wt = np.linspace(1, 20, 20).astype(np.float32)
    db.add(k, (w, wt / wt.sum()))
    np.testing.assert_array_equal(db.word_ids[k], np.arange(12, 20))
    assert abs(db.weights[k].sum() - 1.0) < 1e-6
    words, weights = to_sparse_bow(dense([3, 5, 8]))
    np.testing.assert_array_equal(words, [3, 5, 8])


def seeded_worlds(seed):
    """Both packages' maps and databases with the same 12 keyframes: shared
    points give a covisibility graph, and BoW rows overlap by neighbourhood."""
    rng = np.random.default_rng(seed)
    n_words = 2000
    (_, jm, jdb), (tcfg, tm, tdb) = world(n_words, port=False), world(n_words)
    vecs = []
    for fid in range(12):
        pts = np.full(N, -1, np.int32)
        # keyframe f observes points [16 f, 16 f + 40): neighbours share 24
        pts[:40] = np.arange(16 * fid, 16 * fid + 40) % 256
        base = (fid % 6) * 150  # keyframes f and f + 6 see the same place
        words = np.unique(np.concatenate([rng.integers(base, base + 200, 45),
                                          rng.integers(0, n_words, 10)]))
        wt = rng.random(len(words)).astype(np.float32)
        vecs.append((words, wt / wt.sum()))
        for mp, db, port in ((jm, jdb, False), (tm, tdb, True)):
            k = add_kf(mp, fid, port, pts.copy())
            db.add(k, vecs[-1])
    for mp in (jm, tm):
        mp.pt_valid[:] = True
    return rng, (jm, jdb), (tcfg, tm, tdb), vecs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_candidates_as_jax_on_seeded_data(seed):
    rng, (jm, jdb), (tcfg, tm, tdb), vecs = seeded_worlds(seed)
    for q in range(6):
        words, wt = vecs[rng.integers(0, 12)]
        keep = rng.random(len(words)) < 0.8
        query = (words[keep], wt[keep])
        jc, tc = jdb.detect_reloc_candidates(query), tdb.detect_reloc_candidates(query)
        assert len(jc) > 0
        np.testing.assert_array_equal(tc, jc)
    n_loop = 0
    for kf in range(12):
        others = [k for k in range(12) if k != kf]
        np.testing.assert_allclose(tdb.scores_for_kf(kf, others),
                                   jdb.scores_for_kf(kf, others), atol=1e-6)
        jc = jdb.detect_loop_candidates(kf, 0.05)
        np.testing.assert_array_equal(tdb.detect_loop_candidates(kf, 0.05), jc)
        n_loop += len(jc)
    assert n_loop > 0
    # a culled keyframe leaves the candidates of both
    for mp, db in ((jm, jdb), (tm, tdb)):
        mp.remove_keyframe(3)
        db.erase(3)
    np.testing.assert_array_equal(tdb.detect_reloc_candidates(vecs[3]),
                                  jdb.detect_reloc_candidates(vecs[3]))
    # the JAX database carried over by interop answers the same
    tdb2 = interop.keyframe_db_from_numpy(jdb, tcfg, tm, 2000)
    np.testing.assert_array_equal(tdb2.detect_reloc_candidates(vecs[9]),
                                  jdb.detect_reloc_candidates(vecs[9]))


def test_database_grows_with_the_map():
    """Past cfg.max_keyframes the map doubles its keyframe arrays and the
    port's database grows its rows with it, so registration and both
    queries go on (ROADMAP F5; the JAX package's database keeps its first
    size and raises on the first keyframe past it)."""
    K = 16
    for port in (True, False):
        cfg, mp, db = world(100, port)
        assert cfg.max_keyframes == K
        try:
            for i in range(K + 5):
                db.add(add_kf(mp, i, port), dense([i % 50, 50 + i % 7]))
        except IndexError:
            assert not port and i == K  # JAX: the first id past capacity
            continue
        assert port and mp.kf_valid.shape[0] == 2 * K and db.registered.shape[0] == 2 * K
        assert db.registered[:K + 5].all() and not db.registered[K + 5:].any()
        assert int(db.detect_reloc_candidates(dense([K + 2, 50 + (K + 2) % 7]))[0]) == K + 2
        assert len(db.detect_loop_candidates(K + 4, min_score=0.0)) > 0
