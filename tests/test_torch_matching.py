"""The port's matchers (ops/matching.py, frontend/matcher.py) against the JAX
package on the same numpy inputs. Inputs carry deliberate ties (small
distance ranges, duplicate claims, tied histogram bins), and every integer
output (match index, distance, counts, masks) must agree exactly. The float
inputs are computed the same way in both, so the float gates (radius, level
window, frustum) see the same values up to the last bit of f32 rounding;
the geometry is drawn so that no candidate sits within 1e-3 px of a gate.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.frontend import matcher as JFM
from orbslam2_tpu.ops import matching as JM
from orbslam2_tpu_torch.frontend import matcher as TFM
from orbslam2_tpu_torch.ops import matching as TM


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(jres, tres):
    np.testing.assert_array_equal(np.asarray(jres.idx), tres.idx.numpy())
    np.testing.assert_array_equal(np.asarray(jres.dist), tres.dist.numpy())


def test_argmin_takes_first_index_among_ties():
    d = np.array([[3, 1, 1, 2], [0, 0, 0, 0], [5, 4, 4, 4]], np.int32)
    np.testing.assert_array_equal(torch.argmin(_t(d), dim=1).numpy(),
                                  np.asarray(jnp.argmin(jnp.asarray(d), axis=1)))


@pytest.mark.parametrize("ratio", [None, 0.8, 0.9])
def test_masked_best_match_with_ties(ratio):
    rng = np.random.default_rng(0)
    dist = rng.integers(0, 6, (64, 48)).astype(np.int32) * 20  # many ties
    cand = rng.random((64, 48)) < 0.5
    _eq(JM.masked_best_match(jnp.asarray(dist), jnp.asarray(cand), 100, ratio),
        TM.masked_best_match(_t(dist), _t(cand), 100, ratio))


@pytest.mark.parametrize("ratio", [None, 0.75, 0.9])
def test_hamming_best_match_is_the_unfused_pair(ratio):
    """The fused entry (hamming_best2, then the gate) returns what
    masked_best_match returns on the Hamming matrix, in the port and in JAX.
    Duplicated descriptors tie the best columns; some rows have no candidate."""
    s = _scene(6)
    a, b = s["pt_desc"], s["kp_desc"].copy()
    b[1::2] = b[0::2]
    cand = s["rng"].random((len(a), len(b))) < 0.1
    cand[::5] = False
    jr = JM.masked_best_match(JM.hamming_matrix(jnp.asarray(a), jnp.asarray(b)),
                              jnp.asarray(cand), 125, ratio)
    fused = TM.hamming_best_match(_t(a), _t(b), _t(cand), 125, ratio)
    unfused = TM.masked_best_match(TM.hamming_matrix(_t(a), _t(b)), _t(cand), 125, ratio)
    _eq(jr, fused)
    _eq(jr, unfused)
    if ratio is None:  # a tied best fails every ratio test
        assert (fused.idx.numpy() >= 0).sum() > 10
    assert (fused.idx.numpy()[::5] == -1).all()


def test_best_match_gate():
    """Distance gate, then the float ratio test best < ratio * second."""
    idx = _t(np.array([4, 5, 6, 0], np.int32))
    best = _t(np.array([40, 40, 101, TM.BIG], np.int32))
    second = _t(np.array([50, 51, TM.BIG, TM.BIG], np.int32))
    res = TM.best_match_gate(idx, best, second, 100, 0.8)
    np.testing.assert_array_equal(res.idx.numpy(), [-1, 5, -1, -1])
    np.testing.assert_array_equal(res.dist.numpy(), [TM.BIG, 40, TM.BIG, TM.BIG])
    res = TM.best_match_gate(idx, best, second, 100, None)
    np.testing.assert_array_equal(res.idx.numpy(), [4, 5, -1, -1])


def test_rotation_consistency_tied_bins():
    rng = np.random.default_rng(1)
    n = 90
    # three bins with equal counts plus a weak fourth, and half-step angles
    # that exercise round-half-to-even
    step = 2 * np.pi / 30
    rot = np.concatenate([np.full(25, 2.0), np.full(25, 7.0), np.full(25, 11.5),
                          np.full(15, 20.0)]) * step
    ang_b = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    idx = rng.permutation(n).astype(np.int32)
    ang_a = (ang_b[idx] + rot).astype(np.float32)
    idx[::9] = -1
    valid = idx >= 0
    j = np.asarray(JM.rotation_consistency(jnp.asarray(ang_a), jnp.asarray(ang_b),
                                           jnp.asarray(idx), jnp.asarray(valid)))
    t = TM.rotation_consistency(_t(ang_a), _t(ang_b), _t(idx), _t(valid)).numpy()
    np.testing.assert_array_equal(t, j)


def test_resolve_duplicate_targets_ties():
    rng = np.random.default_rng(2)
    idx = rng.integers(-1, 10, 200).astype(np.int32)  # heavy duplication
    dist = np.where(idx >= 0, rng.integers(0, 3, 200) * 10, JM.BIG).astype(np.int32)
    jr = JM.resolve_duplicate_targets(JM.MatchResult(jnp.asarray(idx), jnp.asarray(dist)), 12)
    tr = TM.resolve_duplicate_targets(TM.MatchResult(_t(idx), _t(dist)), 12)
    _eq(jr, tr)
    kept = tr.idx.numpy()
    assert len(set(kept[kept >= 0])) == (kept >= 0).sum()  # one claimant each


def _scene(seed, P=160, N=256, W=320, H=240):
    """Keypoints spread over the image; map points that project near half
    of them with descriptors a few bits away; random decoys elsewhere."""
    rng = np.random.default_rng(seed)
    kp_xy = np.stack([rng.uniform(20, W - 20, N), rng.uniform(20, H - 20, N)], -1)
    kp_xy = np.round(kp_xy * 8) / 8 + 1 / 16  # keep pixel offsets off the gates
    kp_xy = kp_xy.astype(np.float32)
    kp_oct = rng.integers(0, 4, N).astype(np.int32)
    kp_desc = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32)
    kp_valid = rng.random(N) < 0.95
    kp_angle = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    kp_ur = np.where(rng.random(N) < 0.7, kp_xy[:, 0] - rng.uniform(5, 30, N), -1.0
                     ).astype(np.float32)
    src = rng.choice(N, P, replace=True)  # duplicates -> contested keypoints
    z = rng.uniform(2.0, 6.0, P).astype(np.float32)
    fx = fy = 250.0
    cx, cy = W / 2, H / 2
    off = rng.choice([-1.0, 1.0], (P, 2)) * rng.uniform(0.3, 2.7, (P, 2))
    uv = kp_xy[src] + np.round(off * 8) / 8 + 1 / 32
    pts = np.stack([(uv[:, 0] - cx) / fx * z, (uv[:, 1] - cy) / fy * z, z], -1)
    pt_desc = kp_desc[src].copy()
    flips = rng.integers(0, 256, (P, 12))
    for p in range(P):
        for bit in flips[p, : rng.integers(0, 12)]:
            pt_desc[p, bit // 32] ^= np.uint32(1 << (bit % 32))
    decoy = rng.random(P) < 0.2
    pt_desc[decoy] = rng.integers(0, 2 ** 32, (decoy.sum(), 8), dtype=np.uint32)
    pt_oct = np.clip(kp_oct[src] + rng.integers(-1, 2, P), 0, 3).astype(np.int32)
    pt_angle = (kp_angle[src] + 0.05).astype(np.float32)
    return dict(pts=pts.astype(np.float32), pt_desc=pt_desc, pt_oct=pt_oct,
                pt_angle=pt_angle, pt_valid=rng.random(P) < 0.9,
                kp_xy=kp_xy, kp_oct=kp_oct, kp_desc=kp_desc, kp_valid=kp_valid,
                kp_angle=kp_angle, kp_ur=kp_ur, fx=fx, fy=fy, cx=cx, cy=cy,
                W=W, H=H, bf=60.0, rng=rng)


SF = (1.2 ** np.arange(4)).astype(np.float32)
T_ID = np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_search_by_projection(seed):
    s = _scene(seed)
    z = s["pts"][:, 2]
    uv = np.stack([s["fx"] * s["pts"][:, 0] / z + s["cx"],
                   s["fy"] * s["pts"][:, 1] / z + s["cy"]], -1).astype(np.float32)
    radius = np.full(len(z), 2.0, np.float32)
    args = (uv, s["pt_oct"], radius, s["pt_desc"], s["pt_valid"], s["kp_xy"],
            s["kp_oct"], s["kp_desc"], s["kp_valid"], SF)
    jr = JM.search_by_projection(*map(jnp.asarray, args), max_dist=100, ratio=0.8,
                                 level_window=(-1, 1))
    tr = TM.search_by_projection(*map(_t, args), max_dist=100, ratio=0.8,
                                 level_window=(-1, 1))
    _eq(jr, tr)
    assert (tr.idx.numpy() >= 0).sum() > 20


@pytest.mark.parametrize("radius_th", [1.0, 7.0])
def test_motion_model_core(radius_th):
    """radius 1 finds < 20 matches (the widened retry is selected), radius
    7 finds more (the base result is kept)."""
    s = _scene(3)
    args = (T_ID, s["pts"], s["pt_valid"], s["pt_desc"], s["pt_oct"], s["pt_angle"],
            s["kp_xy"], s["kp_oct"], s["kp_desc"], s["kp_valid"], s["kp_angle"],
            s["kp_ur"], SF)
    consts = (s["fx"], s["fy"], s["cx"], s["cy"], s["bf"], radius_th)
    jr, jn = JFM.motion_model_core(*map(jnp.asarray, args), *consts)
    tr, tn = TFM.motion_model_core(*map(_t, args), *consts)
    _eq(jr, tr)
    assert int(jn) == int(tn) > 0
    single_j = JFM.match_motion_model(*map(jnp.asarray, args), *consts[:-1],
                                      float(radius_th), 4, float(np.log(1.2)))
    single_t = TFM.match_motion_model(*map(_t, args), *consts[:-1], float(radius_th))
    _eq(single_j, single_t)


def test_local_points_core():
    s = _scene(4)
    rng = s["rng"]
    P = len(s["pts"])
    normal = s["pts"] / np.linalg.norm(s["pts"], axis=-1, keepdims=True)
    normal = normal + rng.normal(0, 0.02, normal.shape)
    normal = (normal / np.linalg.norm(normal, axis=-1, keepdims=True)).astype(np.float32)
    dist = np.linalg.norm(s["pts"], axis=-1)
    max_d = (dist * rng.uniform(0.9, 3.0, P)).astype(np.float32)
    min_d = (max_d / 1.2 ** 3).astype(np.float32)
    already = rng.random(P) < 0.1
    args = (T_ID, s["pts"], s["pt_valid"], s["pt_desc"], normal, min_d, max_d,
            already, s["kp_xy"], s["kp_oct"], s["kp_desc"], s["kp_valid"],
            s["kp_ur"], SF)
    consts = (s["fx"], s["fy"], s["cx"], s["cy"], s["bf"], s["W"], s["H"], 4,
              float(np.log(1.2)), 1.0)
    jr, jf = JFM.local_points_core(*map(jnp.asarray, args), *consts)
    tr, tf = TFM.local_points_core(*map(_t, args), *consts)
    _eq(jr, tr)
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    assert tf.numpy().sum() > P // 2


def test_match_descriptors_ratio():
    s = _scene(5)
    P = len(s["pts"])
    args = (s["pt_desc"], s["pt_valid"], s["pt_angle"], s["kp_desc"],
            s["kp_valid"], s["kp_angle"])
    _eq(JFM.match_descriptors_ratio(*map(jnp.asarray, args)),
        TFM.match_descriptors_ratio(*map(_t, args)))
    assert P > 0


def _bow_args(desc_a, valid_a, angle_a, node_a, desc_b, valid_b, angle_b, node_b):
    args = (desc_a, valid_a, angle_a, node_a, desc_b, valid_b, angle_b, node_b)
    return [jnp.asarray(a) for a in args], [_t(a) for a in args]


def test_match_by_bow_equals_jax_with_ties_and_invalid_rows():
    """Node-gated SearchByBoW: features spread over 7 nodes (some unassigned),
    duplicated descriptors that tie the best columns, invalid rows on both
    sides, angles over several histogram bins."""
    rng = np.random.default_rng(11)
    A, B = 96, 80
    desc_b = rng.integers(0, 2 ** 32, (B, 8), dtype=np.uint32)
    desc_b[1::4] = desc_b[0::4]                      # tied columns
    desc_a = desc_b[rng.integers(0, B, A)].copy()
    desc_a[::3, 0] ^= np.uint32(0x0F0F)              # a few bits off
    node_b = rng.integers(-1, 7, B).astype(np.int32)
    node_a = rng.integers(-1, 7, A).astype(np.int32)
    valid_a, valid_b = rng.random(A) < 0.9, rng.random(B) < 0.9
    angle_a = rng.choice([0.0, 0.3, 2.0], A).astype(np.float32)
    angle_b = rng.choice([0.0, 0.3, 2.0], B).astype(np.float32)
    j, t = _bow_args(desc_a, valid_a, angle_a, node_a, desc_b, valid_b, angle_b, node_b)
    jres, tres = JFM.match_by_bow(*j), TFM.match_by_bow(*t)
    _eq(jres, tres)
    idx = tres.idx.numpy()
    m = idx >= 0
    assert m.sum() > 5
    assert (node_a[m] == node_b[idx[m]]).all() and (node_a[m] >= 0).all()
    assert valid_a[m].all() and valid_b[idx[m]].all()


def test_match_by_bow_gate_blocks_cross_node_pairs():
    rng = np.random.default_rng(5)
    n = 64
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    angle, valid = np.zeros(n, np.float32), np.ones(n, bool)
    node = (np.arange(n) % 7).astype(np.int32)
    shifted = ((np.arange(n) + 1) % 7).astype(np.int32)
    j, t = _bow_args(desc, valid, angle, node, desc, valid, angle, node)
    _eq(JFM.match_by_bow(*j), TFM.match_by_bow(*t))
    np.testing.assert_array_equal(TFM.match_by_bow(*t).idx.numpy(), np.arange(n))
    j, t = _bow_args(desc, valid, angle, node, desc, valid, angle, shifted)
    _eq(JFM.match_by_bow(*j), TFM.match_by_bow(*t))
    assert (TFM.match_by_bow(*t).idx.numpy() == -1).all()


def test_match_by_bow_unassigned_node_never_matches():
    rng = np.random.default_rng(6)
    desc = rng.integers(0, 2 ** 32, (16, 8), dtype=np.uint32)
    angle, valid = np.zeros(16, np.float32), np.ones(16, bool)
    none = np.full(16, -1, np.int32)
    j, t = _bow_args(desc, valid, angle, none, desc, valid, angle, none)
    _eq(JFM.match_by_bow(*j), TFM.match_by_bow(*t))
    assert (TFM.match_by_bow(*t).idx.numpy() == -1).all()
