"""The port's local-mapping device functions against the JAX package's, on
the same numpy inputs: the keyframes of the JAX tracker's map after the
30-frame 0.15 m sweep (tests/torch_slice_common.py has the size), with
every valid feature free (an RGB-D keyframe binds nearly all of its
features to depth points, which would leave the matcher little to match),
and seeded synthetic correspondences for the triangulation.

Tolerances:
- triangulate_gated: X within 1e-4 relative where accepted; the accept
  mask exact, except for pairs within 1e-4 (relative) of one of its gates;
- epipolar_match_core: exact;
- map_new_points over K=10 neighbours (the older keyframes, then padding
  slots with k_valid False): integer outputs
  exact, X and the LK offsets within 1e-4;
- fuse_targets and local_points_core(dedup=False): exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu import engine_keyframe as JEK
from orbslam2_tpu.frontend import matcher as JFM
from orbslam2_tpu.ops import features as JF
from orbslam2_tpu.ops import triangulation as JTRI
from orbslam2_tpu_torch import engine_keyframe as TEK
from orbslam2_tpu_torch.frontend import matcher as TFM
from orbslam2_tpu_torch.ops import triangulation as TTRI
from torch_slice_common import configs, jax_sweep_map


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


@pytest.fixture(scope="module")
def kf():
    mp = jax_sweep_map()
    cfg_j, _ = configs()
    kfs = np.flatnonzero(mp.kf_valid)
    assert len(kfs) >= 3
    return dict(mp=mp, cfg=cfg_j, cam=cfg_j.camera, k=int(kfs[-1]),
                nb=[int(k) for k in kfs[-2::-1]],
                sf=JF.scale_factors(cfg_j.orb), sigma2=JF.sigma2_per_octave(cfg_j.orb))


def _gate_margin(X, T1, T2, xy1, xy2, oct1, oct2, sigma2, sf, cam, scale_factor):
    """Relative distance of each pair to the nearest acceptance gate of
    triangulate_gated, from the JAX triangulation in float64."""
    X = X.astype(np.float64)
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
    out = []
    Os, pcs, ds = [], [], []
    for T, xy, o in ((T1, xy1, oct1), (T2, xy2, oct2)):
        T = T.astype(np.float64)
        pc = X @ T[:, :3].T + T[:, 3]
        Os.append(-T[:, :3].T @ T[:, 3])
        ds.append(np.linalg.norm(X - Os[-1], axis=-1))
        pcs.append(pc)
        out.append(np.abs(pc[:, 2] - 0.05) / 0.05)
        proj = pc @ K.T
        uv = proj[:, :2] / np.maximum(proj[:, 2:], 1e-9)
        chi2 = ((uv - xy) ** 2).sum(-1) / sigma2[o]
        out.append(np.abs(chi2 - 5.991) / 5.991)
    cos = ((X - Os[0]) * (X - Os[1])).sum(-1) / np.maximum(ds[0] * ds[1], 1e-12)
    out.append(np.abs(cos - 0.9998) / 0.9998)
    ratio = ds[1] / np.maximum(ds[0], 1e-12)
    r_oct = sf[oct1] / sf[oct2]
    f = 1.5 * scale_factor
    out.append(np.abs(ratio - r_oct * f) / (r_oct * f))
    out.append(np.abs(ratio * f - r_oct) / r_oct)
    return np.min(np.nan_to_num(np.stack(out), nan=0.0), axis=0)


def test_triangulate_gated(kf):
    mp, cam, rng = kf["mp"], kf["cam"], np.random.default_rng(5)
    T1, T2 = mp.kf_pose[kf["k"]], mp.kf_pose[kf["nb"][-1]]
    M = 4000
    Xw = np.stack([rng.uniform(-4, 4, M), rng.uniform(-3, 3, M),
                   rng.uniform(0.5, 9, M)], -1).astype(np.float32)
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]], np.float32)

    def proj(T):
        p = (Xw @ T[:, :3].T + T[:, 3]) @ K.T
        return (p[:, :2] / p[:, 2:]).astype(np.float32)

    oct1 = rng.integers(0, 8, M).astype(np.int32)
    oct2 = np.clip(oct1 + rng.integers(-1, 2, M), 0, 7).astype(np.int32)
    xy1 = proj(T1) + rng.normal(0, 1.0, (M, 2)).astype(np.float32)
    xy2 = proj(T2) + rng.normal(0, 1.0, (M, 2)).astype(np.float32)
    wild = rng.random(M) < 0.2  # mismatches
    xy2[wild] = rng.uniform(0, 320, (wild.sum(), 2)).astype(np.float32)
    valid = rng.random(M) < 0.95
    args = (T1, T2, xy1, xy2, oct1, oct2, valid, kf["sigma2"], kf["sf"])
    consts = (cam.fx, cam.fy, cam.cx, cam.cy, 1.2)
    Xj, okj = (np.asarray(a) for a in JTRI.triangulate_gated(*map(_j, args), *consts))
    Xt, okt = TTRI.triangulate_gated(*map(_t, args), *consts)
    Xt, okt = Xt.numpy(), okt.numpy()
    assert 0.3 * M < okj.sum() < 0.9 * M
    margin = _gate_margin(Xj, T1, T2, xy1, xy2, oct1, oct2, kf["sigma2"], kf["sf"],
                          cam, 1.2)
    clear = margin > 1e-4
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(okt[clear], okj[clear])
    both = okt & okj
    np.testing.assert_allclose(Xt[both], Xj[both], rtol=1e-4, atol=1e-6)


def test_epipolar_match_core(kf):
    mp, cam, k = kf["mp"], kf["cam"], kf["k"]
    for kn in kf["nb"][:3]:
        args = (mp.kf_pose[k], mp.kf_pose[kn], mp.kf_xy0[k], mp.kf_octave[k],
                mp.kf_desc[k], mp.kf_feat_valid[k],
                mp.kf_xy0[kn], mp.kf_octave[kn], mp.kf_desc[kn],
                mp.kf_feat_valid[kn], kf["sigma2"])
        consts = (cam.fx, cam.fy, cam.cx, cam.cy)
        rj = JFM.epipolar_match_core(*map(_j, args), *consts)
        rt = TFM.epipolar_match_core(*map(_t, args), *consts)
        assert (np.asarray(rj.idx) >= 0).sum() > 10
        np.testing.assert_array_equal(rt.idx.numpy(), np.asarray(rj.idx))
        np.testing.assert_array_equal(rt.dist.numpy(), np.asarray(rj.dist))


def test_map_new_points(kf):
    mp, cam, k = kf["mp"], kf["cam"], kf["k"]
    nb = np.asarray(kf["nb"] + [kf["nb"][0]] * (10 - len(kf["nb"])))
    k_valid = np.arange(10) < len(kf["nb"])
    args = (mp.kf_pose[k], mp.kf_xy0[k], mp.kf_octave[k], mp.kf_desc[k],
            mp.kf_feat_valid[k], mp.kf_patch[k],
            mp.kf_pose[nb], mp.kf_xy0[nb], mp.kf_octave[nb], mp.kf_desc[nb],
            mp.kf_feat_valid[nb], mp.kf_patch[nb], k_valid,
            kf["sigma2"], kf["sf"])
    consts = (cam.fx, cam.fy, cam.cx, cam.cy, 1.2)
    ints, flts = (np.asarray(a) for a in JEK.map_new_points(*map(_j, args), *consts))
    out = TEK.map_new_points(*map(_t, args), *consts)
    idx, okj, okrj = ints[..., 0], ints[..., 1] % 2 != 0, ints[..., 1] // 2 != 0
    assert okj.sum() > 20 and (idx[~k_valid] < 0).all()
    np.testing.assert_array_equal(out.idx.numpy(), idx)
    np.testing.assert_array_equal(out.ok.numpy(), okj)
    np.testing.assert_array_equal(out.okr.numpy(), okrj)
    np.testing.assert_allclose(out.X.numpy()[okj], flts[..., 0:3][okj],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.delta.numpy(), flts[..., 3:5], atol=1e-4)
    # the carried free mask: an anchor feature is triangulated once at most
    assert (out.ok.numpy().sum(0) <= 1).all()


def _point_set(mp, kfs, cap):
    pts = mp.kf_pt[kfs]
    pids = np.unique(pts[pts >= 0])
    pids = pids[mp.pt_valid[pids]][:cap]
    pad = cap - len(pids)
    return (np.concatenate([pids, np.zeros(pad, pids.dtype)]),
            np.concatenate([np.ones(len(pids), bool), np.zeros(pad, bool)]))


def test_fuse_targets(kf):
    mp, cam, k = kf["mp"], kf["cam"], kf["k"]
    tg = np.asarray(kf["nb"])
    a_lp, a_pv = _point_set(mp, np.asarray([k]), mp.kf_pt.shape[1])
    b_lp, b_pv = _point_set(mp, tg, 2048)

    def pts(lp, pv):
        return (mp.pt_xyz[lp], pv, mp.pt_desc[lp], mp.pt_normal[lp],
                mp.pt_min_dist[lp], mp.pt_max_dist[lp])

    args = (mp.kf_pose[tg], mp.kf_xy[tg], mp.kf_octave[tg], mp.kf_desc[tg],
            mp.kf_feat_valid[tg], mp.kf_ur[tg], *pts(a_lp, a_pv),
            mp.kf_pose[k], mp.kf_xy[k], mp.kf_octave[k], mp.kf_desc[k],
            mp.kf_feat_valid[k], mp.kf_ur[k], *pts(b_lp, b_pv), kf["sf"])
    consts = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cam.width, cam.height, 8,
              float(np.log(1.2)))
    ja, jb = (np.asarray(a) for a in JEK.fuse_targets(*map(_j, args), *consts))
    ta, tb = TEK.fuse_targets(*map(_t, args), *consts)
    assert (ja >= 0).sum() > 100 and (jb >= 0).sum() > 100
    np.testing.assert_array_equal(ta.numpy(), ja)
    np.testing.assert_array_equal(tb.numpy(), jb)


def test_local_points_core_without_dedup(kf):
    """dedup=False keeps every point's best keypoint: several points may
    claim one keypoint (what the fuse merges)."""
    mp, cam, k = kf["mp"], kf["cam"], kf["k"]
    lp, pv = _point_set(mp, np.asarray(kf["nb"]), 2048)
    args = (mp.kf_pose[k], mp.pt_xyz[lp], pv, mp.pt_desc[lp], mp.pt_normal[lp],
            mp.pt_min_dist[lp], mp.pt_max_dist[lp], np.zeros(len(lp), bool),
            mp.kf_xy[k], mp.kf_octave[k], mp.kf_desc[k], mp.kf_feat_valid[k],
            mp.kf_ur[k], kf["sf"])
    consts = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cam.width, cam.height, 8,
              float(np.log(1.2)), 3.0)
    for dedup in (False, True):
        rj, fj = JFM.local_points_core(*map(_j, args), *consts, dedup=dedup)
        rt, ft = TFM.local_points_core(*map(_t, args), *consts, dedup=dedup)
        np.testing.assert_array_equal(rt.idx.numpy(), np.asarray(rj.idx))
        np.testing.assert_array_equal(rt.dist.numpy(), np.asarray(rj.dist))
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        m = np.asarray(rj.idx)
        n_dup = (m >= 0).sum() - len(np.unique(m[m >= 0]))
        assert n_dup > 0 if not dedup else n_dup == 0
