"""The port's Relocalizer against the JAX package's on one constructed map
and query frame (the world of tests/test_reloc_rescue.py, rebuilt here for
both packages from the same seed): BoW matching alone yields about 45
inliers, below the 50-inlier acceptance gate, and some 30 more
correspondences are reachable only by the projective rescue (descriptors
corrupted past TH_LOW = 50 but inside ORBdist = 100).

Both tests of tests/test_reloc_rescue.py run on the port; and with JAX's own
PnP draws replayed into the port (its key 17, split once per PnP call), the
verdict and every binding are the same and the pose agrees within 1e-3."""
import types

import jax
import numpy as np
import pytest

import torch_slice_common  # noqa: F401  (caps torch's CPU threads)
import orbslam2_tpu.config as JC
import orbslam2_tpu_torch.config as TC
from orbslam2_tpu.frontend.frame import Frame as JFrame
from orbslam2_tpu.io.vocabulary import Vocabulary as JVoc
from orbslam2_tpu.map.keyframe_db import KeyFrameDatabase as JDB
from orbslam2_tpu.map.mapstate import MapState as JMap
from orbslam2_tpu.relocalization import Relocalizer as JReloc
from orbslam2_tpu.system import DEFAULT_VOCAB
from orbslam2_tpu_torch import interop
from orbslam2_tpu_torch.frontend.frame import Frame as TFrame
from orbslam2_tpu_torch.io.vocabulary import default_vocabulary
from orbslam2_tpu_torch.map.keyframe_db import KeyFrameDatabase as TDB
from orbslam2_tpu_torch.map.mapstate import MapState as TMap
from orbslam2_tpu_torch.relocalization import Relocalizer as TReloc
from test_torch_pnp import jax_minimal_sets

N, N_PTS = 128, 80
JAX = types.SimpleNamespace(
    C=JC, Frame=JFrame, DB=JDB, Map=JMap, desc=lambda d: d,
    reloc=lambda cfg, mp, db: JReloc(cfg, mp, JVoc.load(DEFAULT_VOCAB), db))
PORT = types.SimpleNamespace(
    C=TC, Frame=TFrame, DB=TDB, Map=TMap, desc=interop.desc_u32_to_i32,
    reloc=lambda cfg, mp, db: TReloc(cfg, mp, default_vocabulary(), db, device="cpu"))


def flip_bits(desc, n_bits, rng):
    bits = np.unpackbits(desc.view(np.uint8))
    bits[rng.choice(256, n_bits, replace=False)] ^= 1
    return np.packbits(bits).view(np.uint32)


def project(cam, T, X):
    Xc = X @ T[:, :3].T + T[:, 3]
    return np.stack([cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx,
                     cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy], -1).astype(np.float32)


def pad(a, fill=0):
    out = np.full((N,) + a.shape[1:], fill, a.dtype)
    out[:len(a)] = a
    return out


def build(pkg):
    """(relocalizer, query frame, query pose) of one package."""
    rng = np.random.default_rng(3)
    cfg = pkg.C.with_camera(pkg.C.SlamConfig(sensor=pkg.C.Sensor.MONOCULAR),
                            fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                            width=640, height=480)
    mp = pkg.Map(cfg, N)
    db = pkg.DB(cfg, mp, default_vocabulary().n_words)
    reloc = pkg.reloc(cfg, mp, db)
    X = np.stack([rng.uniform(-2, 2, N_PTS), rng.uniform(-1.5, 1.5, N_PTS),
                  rng.uniform(4, 8, N_PTS)], -1).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (N_PTS, 8), dtype=np.uint32)
    pt_ids = mp.add_points(X, pkg.desc(desc), ref_kf=0, first_kf=0)
    T_kf = np.eye(3, 4, dtype=np.float32)
    pt_of = np.full(N, -1, np.int32)
    pt_of[:N_PTS] = pt_ids
    k = mp.add_keyframe(T_kf, 0.0, 0, pad(project(cfg.camera, T_kf, X)),
                        np.zeros(N, np.int32), np.zeros(N, np.float32),
                        pkg.desc(pad(desc)), np.arange(N) < N_PTS, pt_of)
    dist = np.linalg.norm(X, axis=-1)
    mp.pt_max_dist[pt_ids] = dist
    mp.pt_min_dist[pt_ids] = dist / 10.0
    mp.pt_normal[pt_ids] = X / dist[:, None]
    vec, nodes = reloc.frame_bow(mp.kf_desc[k], mp.kf_feat_valid[k])
    mp.kf_bow_node[k] = nodes
    db.add(k, vec)
    # the query: a small offset from the keyframe; features 35..69 corrupted
    # past TH_LOW but inside ORBdist = 100
    T_q = np.hstack([np.eye(3), [[0.05], [0.02], [0.0]]]).astype(np.float32)
    uv = pad(project(cfg.camera, T_q, X))
    qdesc = desc.copy()
    for i in range(35, 70):
        qdesc[i] = flip_bits(desc[i].copy(), 70, rng)
    frame = pkg.Frame(
        frame_id=100, timestamp=1.0, xy=uv, xy_raw=uv.copy(),
        octave=np.zeros(N, np.int32), angle=np.zeros(N, np.float32),
        response=np.ones(N, np.float32), desc=pkg.desc(pad(qdesc)),
        valid=np.arange(N) < N_PTS, depth=np.full(N, -1.0, np.float32),
        ur=np.full(N, -1.0, np.float32))
    return reloc, frame, T_q


def test_rescue_reaches_50_gate():
    reloc, frame, T_q = build(PORT)
    assert reloc.relocalize(frame), "the rescue should lift 45 inliers past the gate"
    assert int((frame.pt_idx >= 0).sum()) >= 50
    assert np.allclose(frame.pose[:, 3], T_q[:, 3], atol=0.02)
    (attempt,) = reloc.attempts
    (tried,) = attempt["tried"]
    assert attempt["ok"] and attempt["candidates"] == 1 and attempt["ms"] > 0
    assert 15 <= tried["bow_matches"] < 50 <= tried["bound"]


def test_without_rescue_fails(monkeypatch):
    reloc, frame, _ = build(PORT)
    monkeypatch.setattr(type(reloc), "_rescue", lambda self, *a, **kw: 0)
    assert not reloc.relocalize(frame)
    assert not reloc.attempts[-1]["ok"]


def test_same_verdict_bindings_and_pose_as_jax_on_its_draws():
    jreloc, jframe, _ = build(JAX)
    treloc, tframe, T_q = build(PORT)
    key = [jax.random.PRNGKey(17)]  # the JAX relocalizer's key

    def replay(valid):
        key[0], sub = jax.random.split(key[0])
        return jax_minimal_sets(sub, valid)

    treloc.minimal_sets = replay
    # the keyframe's BoW side agrees first
    np.testing.assert_array_equal(treloc.map.kf_bow_node[0], jreloc.map.kf_bow_node[0])
    np.testing.assert_array_equal(treloc.db.word_ids, jreloc.db.word_ids)
    np.testing.assert_allclose(treloc.db.weights, jreloc.db.weights, atol=1e-7)
    jok, tok = jreloc.relocalize(jframe), treloc.relocalize(tframe)
    assert jok and tok
    np.testing.assert_array_equal(tframe.pt_idx, jframe.pt_idx)
    # one PnP hypothesis, three pose optimizations in f32: 1e-3
    np.testing.assert_allclose(tframe.pose, jframe.pose, atol=1e-3)
    assert np.allclose(tframe.pose[:, 3], T_q[:, 3], atol=0.02)


def test_frame_bow_is_one_sparse_vector_and_the_gate_nodes():
    reloc, frame, _ = build(PORT)
    (words, weights), nodes = reloc.frame_bow(frame.desc, frame.valid)
    assert words.dtype == np.int32 and weights.dtype == np.float32
    assert (np.diff(words) > 0).all() and abs(weights.sum() - 1.0) < 1e-5
    assert nodes.shape == (N,) and (nodes[:N_PTS] >= 0).all() and (nodes[N_PTS:] == -1).all()
    # the two halves give what the whole gives
    out = reloc.frame_bow_dispatch(frame.desc, frame.valid)
    (w2, wt2), n2 = reloc.frame_bow_finish(*reloc.frame_bow_fetch(out))
    np.testing.assert_array_equal(w2, words)
    np.testing.assert_array_equal(n2, nodes)
    np.testing.assert_allclose(wt2, weights)
    # no candidate on an empty database: the attempt fails and says so
    reloc.db.erase(0)
    assert not reloc.relocalize(frame) and reloc.attempts[-1]["candidates"] == 0
