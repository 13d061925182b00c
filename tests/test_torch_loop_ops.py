"""The loop-closing ops of the port against the JAX package's, on the CPU:
Sim(3) geometry, the Horn closed form, the Sim(3) RANSAC on JAX's own
minimal sets, the Gauss-Newton Sim(3) refinement, the essential-graph
pose-graph solver, and the corridor scene.

Tolerances: Sim(3) geometry 1e-5 (f32 on both sides, the same formulas);
the RANSAC and the refinement 1e-4 on s, R and t with the inlier sets
equal; the pose graph 1e-3 on the poses after 20 Gauss-Newton iterations of
numeric Jacobians (f32 central differences, which amplify rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.geometry import se3 as jse3
from orbslam2_tpu.geometry import sim3 as jsim3
from orbslam2_tpu.io import synth as jsynth
from orbslam2_tpu.ops import pose_graph as JPG
from orbslam2_tpu.ops import sim3_solver as JS3
from orbslam2_tpu_torch.geometry import sim3 as tsim3
from orbslam2_tpu_torch.io import synth as tsynth
from orbslam2_tpu_torch.ops import pose_graph as TPG
from orbslam2_tpu_torch.ops import sim3_solver as TS3

INTR = (500.0, 500.0, 320.0, 240.0)


def t_(a):
    return torch.from_numpy(np.array(a))


def to_np(S):
    return {k: np.asarray(v) for k, v in S.items()}


def jax_minimal_sets(key, valid):
    """The [256, 3] index sets jax sim3_ransac draws from `key`
    (orbslam2_tpu/ops/sim3_solver.py:82-87), replayed outside its program."""
    v = jnp.asarray(valid)
    probs = v.astype(jnp.float32) / jnp.maximum(jnp.sum(v), 1.0)
    keys = jax.random.split(key, JS3.N_HYPOTHESES)
    return np.asarray(jax.vmap(lambda k: jax.random.choice(
        k, v.shape[0], (3,), replace=False, p=probs))(keys))


def _xi(theta, sigma, seed=0):
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    return np.concatenate([rng.normal(0, 0.5, 3), theta * axis, [sigma]]).astype(np.float32)


BRANCHES = [(th, sg) for th in (0.0, 1e-8, 1e-3, 1.0) for sg in (0.0, 1e-8, 0.5)]


class TestSim3Geometry:
    @pytest.mark.parametrize("theta,sigma", BRANCHES)
    def test_exp_log_both_branches(self, theta, sigma):
        """exp and log agree with JAX on both sides of each Taylor switch of
        _V_coeffs, and exp(log(S)) returns S."""
        xi = _xi(theta, sigma)
        Sj = to_np(jsim3.exp(jnp.asarray(xi)))
        St = tsim3.exp(t_(xi))
        for k in ("s", "R", "t"):
            np.testing.assert_allclose(St[k].numpy(), Sj[k], atol=1e-5)
        for Vj, Vt in zip(jsim3._V_coeffs(jnp.asarray(xi[3:6]), jnp.asarray(xi[6])),
                          tsim3._V_coeffs(t_(xi[3:6]), t_(xi[6]))):
            assert np.isfinite(Vt.item())
            np.testing.assert_allclose(Vt.item(), float(Vj), rtol=1e-5, atol=1e-6)
        lj = np.asarray(jsim3.log({k: jnp.asarray(v) for k, v in Sj.items()}))
        lt = tsim3.log(St).numpy()
        np.testing.assert_allclose(lt, lj, atol=1e-5)
        back = tsim3.exp(tsim3.log(St))
        for k in ("s", "R", "t"):
            np.testing.assert_allclose(back[k].numpy(), St[k].numpy(), atol=1e-5)

    def test_group_operations_batched(self):
        """compose, inverse, apply, retract, to_se3 and from_se3 on a batch
        of 5 similarities, against JAX."""
        rng = np.random.default_rng(3)
        xa = np.stack([_xi(rng.uniform(0, 2), rng.uniform(-0.5, 0.5), i)
                       for i in range(5)])
        xb = np.stack([_xi(rng.uniform(0, 2), rng.uniform(-0.5, 0.5), 10 + i)
                       for i in range(5)])
        pts = rng.normal(0, 2, (5, 7, 3)).astype(np.float32)
        Ja, Jb = jsim3.exp(jnp.asarray(xa)), jsim3.exp(jnp.asarray(xb))
        Ta, Tb = tsim3.exp(t_(xa)), tsim3.exp(t_(xb))
        pairs = [
            (jsim3.compose(Ja, Jb), tsim3.compose(Ta, Tb)),
            (jsim3.inverse(Ja), tsim3.inverse(Ta)),
            (jsim3.retract(Ja, jnp.asarray(xb)), tsim3.retract(Ta, t_(xb))),
        ]
        for J, T in pairs:
            for k in ("s", "R", "t"):
                np.testing.assert_allclose(T[k].numpy(), np.asarray(J[k]), atol=1e-5)
        np.testing.assert_allclose(tsim3.apply(Ta, t_(pts)).numpy(),
                                   np.asarray(jsim3.apply(Ja, jnp.asarray(pts))),
                                   atol=1e-5)
        Tse3 = tsim3.to_se3(Ta)
        np.testing.assert_allclose(Tse3.numpy(), np.asarray(jsim3.to_se3(Ja)), atol=1e-5)
        for k in ("s", "R", "t"):
            np.testing.assert_allclose(tsim3.from_se3(Tse3)[k].numpy(),
                                       np.asarray(jsim3.from_se3(jnp.asarray(Tse3.numpy()))[k]),
                                       atol=1e-6)
        ident = tsim3.compose(Ta, tsim3.inverse(Ta))
        np.testing.assert_allclose(ident["R"].numpy(), np.tile(np.eye(3), (5, 1, 1)),
                                   atol=1e-5)
        assert tsim3.identity()["s"].item() == 1.0


def make_pair(seed=0, s_gt=1.4, n=100, noise=0.0, n_out=0):
    """tests/test_loop_ops.py TestSim3Solver.make_pair."""
    rng = np.random.default_rng(seed)
    P2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(3, 8, n)], -1).astype(np.float32)
    R_gt = np.asarray(jse3.so3_exp(jnp.asarray([0.1, -0.2, 0.15])))
    t_gt = np.array([0.4, -0.1, 0.3], np.float32)
    P1 = s_gt * P2 @ R_gt.T + t_gt
    P1 += rng.normal(0, noise, P1.shape)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        P1[idx] += rng.uniform(1, 3, (n_out, 3))
    return P1.astype(np.float32), P2, s_gt, R_gt, t_gt


class TestSim3Solver:
    @pytest.mark.parametrize("fix_scale", [False, True])
    def test_horn_exact_pairs(self, fix_scale):
        P1, P2, s_gt, R_gt, t_gt = make_pair(seed=4, s_gt=1.0 if fix_scale else 1.4,
                                             n=12)
        sj, Rj, tj = JS3._horn_sim3(jnp.asarray(P1), jnp.asarray(P2), fix_scale)
        st, Rt, tt = TS3._horn_sim3(t_(P1), t_(P2), fix_scale)
        np.testing.assert_allclose(float(st), float(sj), atol=1e-5)
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
        np.testing.assert_allclose(Rt.numpy(), R_gt, atol=1e-4)
        assert abs(float(st) - s_gt) < 1e-4

    # the three cases of tests/test_loop_ops.py TestSim3Solver, each with
    # the PRNGKey its JAX test uses
    @pytest.mark.parametrize("case", [
        dict(seed=0, key=0, fix_scale=False),
        dict(seed=1, key=1, fix_scale=False, noise=0.005, n_out=25),
        dict(seed=2, key=2, fix_scale=True, s_gt=1.0),
    ], ids=["exact", "outliers", "fix_scale"])
    def test_ransac_on_jax_minimal_sets(self, case):
        P1, P2, s_gt, R_gt, _ = make_pair(seed=case["seed"], s_gt=case.get("s_gt", 1.4),
                                          noise=case.get("noise", 0.0),
                                          n_out=case.get("n_out", 0))
        n = len(P1)
        key = jax.random.PRNGKey(case["key"])
        valid = np.ones(n, bool)
        rj = JS3.sim3_ransac(key, jnp.asarray(P1), jnp.asarray(P2), jnp.ones(n),
                             jnp.ones(n), jnp.asarray(valid), *INTR,
                             fix_scale=case["fix_scale"])
        idx = jax_minimal_sets(key, valid)
        rt = TS3.sim3_ransac(t_(P1), t_(P2), torch.ones(n), torch.ones(n), t_(valid),
                             *INTR, fix_scale=case["fix_scale"], idx=t_(idx))
        np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
        assert int(rt.n_inliers) == int(rj.n_inliers)
        np.testing.assert_allclose(float(rt.s), float(rj.s), atol=1e-4)
        np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-4)
        np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-4)
        assert abs(float(rt.s) - s_gt) < 0.05

    def test_ransac_draws_from_generator(self):
        """Without given sets the RANSAC draws its own from a generator,
        among the valid rows only, and still recovers the similarity."""
        P1, P2, s_gt, R_gt, t_gt = make_pair(seed=1, noise=0.005, n_out=25)
        pad = np.zeros((28, 3), np.float32)
        P1p, P2p = np.concatenate([P1, pad]), np.concatenate([P2, pad])
        valid = np.arange(128) < 100
        gen = torch.Generator()
        gen.manual_seed(5)
        idx = TS3.draw_minimal_sets(t_(valid), gen)
        assert idx.shape == (TS3.N_HYPOTHESES, 3) and int(idx.max()) < 100
        assert (idx[:, 0] != idx[:, 1]).all() and (idx[:, 1] != idx[:, 2]).all()
        gen.manual_seed(5)
        r = TS3.sim3_ransac(t_(P1p), t_(P2p), torch.ones(128), torch.ones(128),
                            t_(valid), *INTR, generator=gen)
        assert abs(float(r.s) - s_gt) < 0.05 and int(r.n_inliers) >= 60
        assert not r.inliers[100:].any()

    def test_optimize_sim3_refines_noisy_init(self):
        """tests/test_loop_ops.py TestOptimizeSim3 on both packages (1e-4)."""
        rng = np.random.default_rng(11)
        n = 128
        P2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                       rng.uniform(3, 8, n)], -1).astype(np.float32)
        R_gt = np.asarray(jse3.so3_exp(jnp.asarray([0.05, -0.1, 0.07])))
        t_gt = np.array([0.3, -0.1, 0.2], np.float32)
        s_gt = 1.25
        P1 = (s_gt * P2 @ R_gt.T + t_gt).astype(np.float32)

        def proj(P):
            return np.stack([500 * P[:, 0] / P[:, 2] + 320,
                             500 * P[:, 1] / P[:, 2] + 240], -1).astype(np.float32)

        uv1 = proj(P1) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
        uv2 = proj(P2) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
        R0 = np.asarray(jse3.so3_exp(jnp.asarray([0.07, -0.08, 0.05]))).astype(np.float32)
        t0 = (t_gt + [0.05, -0.03, 0.02]).astype(np.float32)
        for fix_scale in (False, True):
            outj = JS3.optimize_sim3(
                jnp.asarray(1.1, jnp.float32), jnp.asarray(R0), jnp.asarray(t0),
                jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(uv1), jnp.asarray(uv2),
                jnp.ones(n, jnp.float32), jnp.ones(n, jnp.float32), jnp.ones(n, bool),
                *INTR, fix_scale=fix_scale)
            outt = TS3.optimize_sim3(
                torch.tensor(1.1), t_(R0), t_(t0), t_(P1), t_(P2), t_(uv1), t_(uv2),
                torch.ones(n), torch.ones(n), torch.ones(n, dtype=torch.bool), *INTR,
                fix_scale=fix_scale)
            for a, b in zip(outt[:3], outj[:3]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
            np.testing.assert_array_equal(outt[3].numpy(), np.asarray(outj[3]))
            assert int(outt[4]) == int(outj[4])
            if not fix_scale:
                assert abs(float(outt[0]) - s_gt) < 0.02 and int(outt[4]) > 110


def drift_problem():
    """tests/test_loop_ops.py TestPoseGraph: a 12-keyframe circle with
    drifting odometry edges and one exact loop edge."""
    K = 12
    rng = np.random.default_rng(0)
    gt = []
    for i in range(K):
        a = 2 * np.pi * i / K
        Rwc = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]], np.float32)
        C = np.array([np.sin(a), 0.0, 1 - np.cos(a)], np.float32) * 2
        gt.append({"s": np.float32(1.0), "R": Rwc.T, "t": -Rwc.T @ C})
    e_i, e_j, ms, mR, mt = [], [], [], [], []

    def rel(a, b):
        Sa = {k: jnp.asarray(v) for k, v in gt[a].items()}
        Sb = {k: jnp.asarray(v) for k, v in gt[b].items()}
        return jsim3.compose(Sa, jsim3.inverse(Sb))

    drift = np.concatenate([rng.normal(0, 0.02, 3), rng.normal(0, 0.01, 3), [0.015]])
    for i in range(1, K):
        m = jsim3.compose(jsim3.exp(jnp.asarray(drift, jnp.float32)), rel(i, i - 1))
        e_i.append(i)
        e_j.append(i - 1)
        ms.append(float(m["s"]))
        mR.append(np.asarray(m["R"]))
        mt.append(np.asarray(m["t"]))
    m = rel(K - 1, 0)
    e_i.append(K - 1)
    e_j.append(0)
    ms.append(float(m["s"]))
    mR.append(np.asarray(m["R"]))
    mt.append(np.asarray(m["t"]))
    est = [dict(gt[0])]
    for i in range(1, K):
        Sm = {"s": jnp.asarray(ms[i - 1]), "R": jnp.asarray(mR[i - 1]),
              "t": jnp.asarray(mt[i - 1])}
        Si = jsim3.compose(Sm, {k: jnp.asarray(v) for k, v in est[i - 1].items()})
        est.append({"s": np.float32(Si["s"]), "R": np.asarray(Si["R"]),
                    "t": np.asarray(Si["t"])})
    args = (np.array([e["s"] for e in est], np.float32),
            np.stack([e["R"] for e in est]).astype(np.float32),
            np.stack([e["t"] for e in est]).astype(np.float32),
            np.arange(K) == 0, np.array(e_i, np.int32), np.array(e_j, np.int32),
            np.array(ms, np.float32), np.stack(mR).astype(np.float32),
            np.stack(mt).astype(np.float32), np.ones(len(e_i), bool))
    return gt[K - 1], args


def test_pose_graph_drift_correction():
    """optimize_pose_graph on the drift problem: the port's poses within
    1e-3 of JAX's, the same first and final cost (1% relative; the costs in
    between follow the noisy numeric Jacobians) and drift reduction."""
    g_last, args = drift_problem()

    def drift_err(sv, R, t):
        Se = {"s": jnp.asarray(sv[-1]), "R": jnp.asarray(R[-1]), "t": jnp.asarray(t[-1])}
        Sg = {k: jnp.asarray(v) for k, v in g_last.items()}
        return float(jnp.abs(jsim3.log(jsim3.compose(Se, jsim3.inverse(Sg)))).max())

    outj = [np.asarray(x) for x in JPG.optimize_pose_graph(
        *(jnp.asarray(a) for a in args), iters=20)]
    outt = [x.numpy() for x in TPG.optimize_pose_graph(*(t_(a) for a in args), iters=20)]
    for a, b in zip(outt[:3], outj[:3]):
        np.testing.assert_allclose(a, b, atol=1e-3)
    np.testing.assert_allclose(outt[3][[0, -1]], outj[3][[0, -1]], rtol=1e-2)
    before = drift_err(*args[:3])
    after_j, after_t = drift_err(*outj[:3]), drift_err(*outt[:3])
    assert after_t < before * 0.35 and abs(after_t - after_j) < 1e-3
    assert outt[3][-1] < outt[3][0] * 0.5


def test_pose_graph_fixed_and_invalid():
    """A fixed vertex does not move, and an invalid edge does not pull."""
    _, args = drift_problem()
    args = list(args)
    args[3] = np.arange(12) < 3          # three fixed vertices
    args[9] = np.arange(12) != 11        # the loop edge switched off
    outj = [np.asarray(x) for x in JPG.optimize_pose_graph(
        *(jnp.asarray(a) for a in args), iters=5)]
    outt = [x.numpy() for x in TPG.optimize_pose_graph(*(t_(a) for a in args), iters=5)]
    for a, b in zip(outt[:3], outj[:3]):
        np.testing.assert_allclose(a, b, atol=1e-3)
    np.testing.assert_array_equal(outt[1][:3], args[1][:3])
    np.testing.assert_array_equal(outt[2][:3], args[2][:3])


@pytest.mark.parametrize("size", [(640, 480, 500.0), (320, 240, 250.0)])
def test_corridor_scene_byte_equal(size):
    """make_corridor and corridor_trajectory are copies of JAX's: the
    rendered images and depth maps are byte-equal for the same seed."""
    W, H, f = size
    js = jsynth.make_corridor(seed=3, width=W, height=H, fx=f, fy=f)
    ts = tsynth.make_corridor(seed=3, width=W, height=H, fx=f, fy=f)
    gj = jsynth.corridor_trajectory(240, radius=8.0)
    gt = tsynth.corridor_trajectory(240, radius=8.0)
    assert gj.tobytes() == gt.tobytes()
    assert jsynth.loop_trajectory(30).tobytes() == tsynth.loop_trajectory(30).tobytes()
    for i in (0, 117):
        assert (jsynth.render_room(js, gj[i], noise=2.5, seed=i).tobytes()
                == tsynth.render_room(ts, gt[i], noise=2.5, seed=i).tobytes())
        assert jsynth.depth_room(js, gj[i]).tobytes() == tsynth.depth_room(ts, gt[i]).tobytes()
