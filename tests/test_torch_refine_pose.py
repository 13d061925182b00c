"""The port's LK refinement (ops/refine.py), pose LM (ops/pose_opt.py,
ops/ba_core.py) and geometry (geometry/se3.py, geometry/camera.py) against
the JAX package on the same numpy inputs.

Tolerances: both sides compute in f32 with sums in different orders.
- refine_offsets: 8 LK steps on 11x11 windows; the offsets agree within
  1e-4 px and the accept flags exactly.
- pose_optimize: 40 LM steps; a reordered sum can flip an LM accept, so
  the pose is compared within 1e-4 (rotation entries, translation in m)
  and the inlier masks may differ only where chi2 sits within 1% of its
  threshold.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.geometry import camera as JCam
from orbslam2_tpu.geometry import se3 as JSE3
from orbslam2_tpu.ops import ba_core as JBC
from orbslam2_tpu.ops import pose_opt as JPO
from orbslam2_tpu.ops import refine as JRF
from orbslam2_tpu_torch.geometry import camera as TCam
from orbslam2_tpu_torch.geometry import se3 as TSE3
from orbslam2_tpu_torch.ops import ba_core as TBC
from orbslam2_tpu_torch.ops import pose_opt as TPO
from orbslam2_tpu_torch.ops import refine as TRF


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _smooth_field(rng, size=64):
    f = rng.uniform(0, 255, (size, size))
    k = np.array([1, 4, 6, 4, 1], np.float64) / 16
    for ax in (0, 1):
        for _ in range(3):
            f = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), ax, f)
    return f


def _bilinear(f, x, y):
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = x - x0, y - y0
    return ((f[y0, x0] * (1 - fx) + f[y0, x0 + 1] * fx) * (1 - fy)
            + (f[y0 + 1, x0] * (1 - fx) + f[y0 + 1, x0 + 1] * fx) * fy)


def test_refine_offsets_parity():
    rng = np.random.default_rng(0)
    M = 64
    field = _smooth_field(rng)
    cx = rng.uniform(20, 44, M)
    cy = rng.uniform(20, 44, M)
    true = rng.uniform(-1.5, 1.5, (M, 2))
    true[::7] = rng.uniform(-4, 4, (len(true[::7]), 2))  # outside the trust region
    g = np.arange(-7, 8)
    patches = np.stack([_bilinear(field, cx[i] + g[None, :], cy[i] + g[:, None])
                        for i in range(M)]).astype(np.float32)
    g5 = np.arange(-5, 6)
    templates = np.stack([_bilinear(field, cx[i] - true[i, 0] + g5[None, :],
                                    cy[i] - true[i, 1] + g5[:, None])
                          for i in range(M)]).astype(np.float32)
    templates[5] = 100.0  # flat template: not conditioned
    valid = rng.random(M) < 0.9
    dj, okj = JRF.refine_offsets(jnp.asarray(patches), jnp.asarray(templates),
                                 jnp.asarray(valid))
    dt, okt = TRF.refine_offsets(_t(patches), _t(templates), _t(valid))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-4)
    assert okt.numpy().sum() > M // 2
    np.testing.assert_array_equal(TRF.template_of(_t(patches)).numpy(),
                                  np.asarray(JRF.template_of(jnp.asarray(patches))))


def _pose_problem(seed, N=300, stereo_frac=0.5, outliers=0.1):
    rng = np.random.default_rng(seed)
    fx = fy = 500.0
    cx, cy, bf = 320.0, 240.0, 250.0
    pts = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N),
                    rng.uniform(3, 9, N)], -1)
    T_true = np.asarray(JSE3.se3_exp(jnp.asarray(rng.normal(0, 0.05, 6),
                                                 jnp.float32)))
    pc = pts @ T_true[:, :3].T + T_true[:, 3]
    u = fx * pc[:, 0] / pc[:, 2] + cx
    v = fy * pc[:, 1] / pc[:, 2] + cy
    ur = u - bf / pc[:, 2]
    obs = np.stack([u, v, ur], -1) + rng.normal(0, 0.7, (N, 3))
    bad = rng.random(N) < outliers
    obs[bad, :2] += rng.uniform(-30, 30, (bad.sum(), 2))
    is_st = rng.random(N) < stereo_frac
    octave = rng.integers(0, 8, N)
    info = (1.0 / 1.2 ** (2 * octave)).astype(np.float32)
    valid = rng.random(N) < 0.95
    T0 = np.asarray(JSE3.retract(jnp.asarray(T_true), jnp.asarray(rng.normal(0, 0.02, 6),
                                                                  jnp.float32)))
    return (T0.astype(np.float32), pts.astype(np.float32), obs.astype(np.float32),
            is_st, info, valid), (fx, fy, cx, cy, bf)


@pytest.mark.parametrize("seed,stereo_frac", [(0, 0.5), (1, 0.0), (2, 1.0)])
def test_pose_optimize_parity(seed, stereo_frac):
    args, consts = _pose_problem(seed, stereo_frac=stereo_frac)
    rj = JPO.pose_optimize(*map(jnp.asarray, args), *consts)
    rt = TPO.pose_optimize(*map(_t, args), *consts)
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=1e-4)
    inl_j, inl_t = np.asarray(rj.inliers), rt.inliers.numpy()
    # a flip is allowed only where chi2 sits within 1% of its threshold
    res, _ = JBC.project_residual(rj.T, *map(jnp.asarray, (args[1], args[2], args[3])),
                                  *consts[:4], consts[4])
    chi2 = np.asarray(jnp.sum(res * res, -1)) * args[4]
    th = np.where(args[3], JBC.CHI2_STEREO, JBC.CHI2_MONO)
    near = np.abs(chi2 / th - 1) < 0.01
    assert not ((inl_j != inl_t) & ~near).any()
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= int(near.sum())
    assert int(rt.n_inliers) > 200


def test_ba_core_parity():
    args, (fx, fy, cx, cy, bf) = _pose_problem(3)
    T0, pts, obs, is_st, info, _ = args
    rj, pcj = JBC.project_residual(*map(jnp.asarray, (T0, pts, obs, is_st)),
                                   fx, fy, cx, cy, bf)
    rt, pct = TBC.project_residual(*map(_t, (T0, pts, obs, is_st)), fx, fy, cx, cy, bf)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-3)
    Jj, Pj = JBC.residual_jacobians(pcj, jnp.asarray(is_st), fx, fy, bf)
    Jt, Pt = TBC.residual_jacobians(pct, _t(is_st), fx, fy, bf)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), rtol=1e-5, atol=1e-3)
    for robust in (True, False):
        cj, wj = JBC.chi2_and_weight(rj, jnp.asarray(is_st), jnp.asarray(info), robust)
        ct, wt = TBC.chi2_and_weight(rt, _t(is_st), _t(info), robust)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-4)
        np.testing.assert_allclose(
            TBC.robust_cost(ct, _t(is_st), robust).numpy(),
            np.asarray(JBC.robust_cost(cj, jnp.asarray(is_st), robust)), rtol=1e-4, atol=1e-4)


def test_se3_parity():
    rng = np.random.default_rng(4)
    xi = rng.normal(0, 0.5, (20, 6)).astype(np.float32)
    xi[0] = 0.0
    xi[1, 3:] = 1e-5  # Taylor branch
    Tj = np.asarray(JSE3.se3_exp(jnp.asarray(xi)))
    Tt = TSE3.se3_exp(_t(xi)).numpy()
    np.testing.assert_allclose(Tt, Tj, atol=1e-6)
    np.testing.assert_allclose(TSE3.se3_log(_t(Tt)).numpy(),
                               np.asarray(JSE3.se3_log(jnp.asarray(Tj))), atol=1e-4)
    np.testing.assert_allclose(
        TSE3.retract(_t(Tt[2]), _t(xi[3])).numpy(),
        np.asarray(JSE3.retract(jnp.asarray(Tj[2]), jnp.asarray(xi[3]))), atol=1e-6)
    np.testing.assert_allclose(TSE3.inverse(_t(Tt)).numpy(),
                               np.asarray(JSE3.inverse(jnp.asarray(Tj))), atol=1e-6)
    np.testing.assert_allclose(TSE3.camera_center(_t(Tt)).numpy(),
                               np.asarray(JSE3.camera_center(jnp.asarray(Tj))), atol=1e-5)


def test_camera_parity_with_distortion():
    from orbslam2_tpu_torch.geometry.camera import Intrinsics
    kw = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3, k1=0.26, k2=-0.95,
              p1=-0.005, p2=0.002, k3=1.16, width=640, height=480)
    cj, ct = JCam.Intrinsics(**kw), Intrinsics(**kw)
    uv = np.random.default_rng(5).uniform(0, 640, (100, 2)).astype(np.float32)
    np.testing.assert_allclose(TCam.undistort_pixels(ct, _t(uv)).numpy(),
                               np.asarray(JCam.undistort_pixels(cj, jnp.asarray(uv))),
                               atol=1e-3)
    np.testing.assert_allclose(TCam.undistorted_bounds(ct), JCam.undistorted_bounds(cj),
                               atol=1e-3)
    pc = np.random.default_rng(6).uniform(1, 5, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(TCam.project(ct, _t(pc)).numpy(),
                               np.asarray(JCam.project(cj, jnp.asarray(pc))), rtol=1e-6)
    d = pc[:, 2].copy()
    np.testing.assert_allclose(TCam.backproject(ct, _t(uv[:50]), _t(d)).numpy(),
                               np.asarray(JCam.backproject(cj, jnp.asarray(uv[:50]),
                                                           jnp.asarray(d))), rtol=1e-6)
