"""Parity of the two-view initialization (ops/twoview.py): the JAX functions
and the port's on the same numpy inputs, made from a seed.

H and F are homogeneous and `eigh` / `svd` fix neither sign nor the order of
equal values, so models are compared up to sign and scale, motion hypotheses
as sets, and the result of `initialize_two_view` by R, t and the good mask.
The JAX package draws its minimal sets from threefry keys inside its
program; `jax_draws` reproduces those draws here (jax.random.split and
jax.random.choice, called as `_ransac_model` calls them) and the port takes
them as inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.ops import twoview as JTV
from orbslam2_tpu_torch.ops import twoview as TTV
from test_twoview import K, angular_err_deg, synth_pair


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jax_draws(key, w, n_hyp=JTV.N_HYPOTHESES):
    """The [n_hyp, 8] minimal sets initialize_two_view(key, ...) draws for
    the homography and the fundamental sweep."""
    w = jnp.asarray(w)
    probs = w.astype(jnp.float32) / jnp.maximum(jnp.sum(w), 1.0)
    out = []
    for k in jax.random.split(key):
        keys = jax.random.split(k, n_hyp)
        out.append(np.asarray(jax.vmap(lambda kk: jax.random.choice(
            kk, w.shape[0], (8,), replace=False, p=probs))(keys)))
    return out


def rot_angle_deg(Ra, Rb):
    """Angle between two rotations from the skew part of Ra^T Rb: exact for
    small angles, where the trace formula of tests/test_twoview.py loses
    0.05 degrees to the f32 rounding of the matrices."""
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    s = 0.5 * np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return np.degrees(np.arctan2(s, (np.trace(M) - 1) / 2))


def unit_sign(M):
    """A homogeneous model normalised to unit norm and a positive largest
    entry."""
    M = np.asarray(M, np.float64)
    M = M / np.linalg.norm(M)
    return M * np.sign(M.flat[np.argmax(np.abs(M))])


@pytest.fixture(scope="module")
def pair():
    _, R, t, xy1, xy2, w = synth_pair()
    return R, t, xy1, xy2, w


def test_normalize(pair):
    _, _, xy1, _, w = pair
    jx, jT = JTV._normalize(jnp.asarray(xy1), jnp.asarray(w))
    tx, tT = TTV._normalize(t_(xy1), t_(w))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("model", ["H", "F"])
def test_minimal_dlt_up_to_sign_and_scale(pair, model):
    """A batch of 8-point fits against JAX's one at a time.

    The null vector comes from the f32 Gram matrix, whose conditioning is
    the square of the system's: where the two smallest eigenvalues lie
    within 2e-5 of the largest of each other, JAX's own vector is off the
    f64 one by 1e-3 to 1 (8 points leave F's 8x9 system an exact null
    space, so this is the common case there). Those sets are held by their
    algebraic residual |A f| / |A| only (F: H's 16 noisy rows have no exact
    null vector); the others elementwise to 1e-3."""
    _, _, xy1, xy2, w = pair
    rng = np.random.default_rng(1)
    ok = np.flatnonzero(w)
    n = 64
    idx = np.stack([rng.choice(ok, 8, replace=False) for _ in range(n)])
    xn1 = np.asarray(JTV._normalize(jnp.asarray(xy1), jnp.asarray(w))[0])
    xn2 = np.asarray(JTV._normalize(jnp.asarray(xy2), jnp.asarray(w))[0])
    a, b = t_(xn1)[t_(idx)], t_(xn2)[t_(idx)]
    if model == "H":
        jf, tf, A = JTV._dlt_H, TTV._dlt_H, torch.cat(TTV._rows_H(a, b), dim=-2)
    else:
        jf, tf, A = JTV._dlt_F, TTV._dlt_F, TTV._rows_F(a, b)
    A = A.numpy().astype(np.float64)
    got = tf(a, b).numpy()
    assert got.shape == (n, 3, 3)
    compared = 0
    for i in range(n):
        ref = np.asarray(jf(jnp.asarray(xn1[idx[i]]), jnp.asarray(xn2[idx[i]])))
        ev = np.linalg.eigvalsh(A[i].T @ A[i])
        if model == "F":
            for f in (got[i], ref):
                assert (np.linalg.norm(A[i] @ unit_sign(f).ravel())
                        <= 2e-3 * np.linalg.norm(A[i]))
        if (ev[1] - ev[0]) / ev[-1] >= 2e-5:
            np.testing.assert_allclose(unit_sign(got[i]), unit_sign(ref), atol=1e-3)
            compared += 1
    assert compared >= 8, compared


@pytest.mark.parametrize("model", ["H", "F"])
def test_scores(pair, model):
    R, t, xy1, xy2, w = pair
    rng = np.random.default_rng(2)
    if model == "H":
        Ms = np.eye(3, dtype=np.float32) + rng.normal(0, 1e-4, (5, 3, 3)).astype(np.float32)
        Ms[:, :2, 2] += rng.normal(0, 20.0, (5, 2)).astype(np.float32)
        jf, tf = JTV._score_H, TTV._score_H
    else:
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        Kinv = np.linalg.inv(K)
        F0 = Kinv.T @ tx @ R @ Kinv
        Ms = (F0 / np.linalg.norm(F0) + rng.normal(0, 1e-7, (5, 3, 3))).astype(np.float32)
        jf, tf = JTV._score_F, TTV._score_F
    score, ok = tf(t_(Ms), t_(xy1), t_(xy2), t_(w))
    assert score.shape == (5,) and ok.shape == (5, len(w))
    for i in range(5):
        js, jok = jf(jnp.asarray(Ms[i]), jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(w))
        assert (ok[i].numpy() == np.asarray(jok)).mean() >= 0.99
        np.testing.assert_allclose(float(score[i]), float(js), rtol=1e-4, atol=1e-2)
    assert float(score.max()) > 0  # the cases score something


@pytest.mark.parametrize("model", ["H", "F"])
def test_masked_refit_up_to_sign_and_scale(model):
    _, _, _, xy1, xy2, w = synth_pair(seed=1, planar=(model == "H"))
    jf, tf = ((JTV._dlt_H_masked, TTV._dlt_H_masked) if model == "H"
              else (JTV._dlt_F_masked, TTV._dlt_F_masked))
    ref = jf(jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(w))
    got = tf(t_(xy1), t_(xy2), t_(w)).numpy()
    np.testing.assert_allclose(unit_sign(got), unit_sign(ref), atol=1e-3)


def test_check_rt_batched(pair):
    """The true motion and three wrong ones in one batch against JAX's one
    at a time."""
    R, t, xy1, xy2, w = pair
    tn = (t / np.linalg.norm(t)).astype(np.float32)
    Rs = np.stack([R, R, R.T, np.eye(3)]).astype(np.float32)
    ts = np.stack([tn, -tn, tn, tn[[1, 0, 2]]]).astype(np.float32)
    n_good, par, X, good = TTV._check_rt(t_(Rs), t_(ts), t_(xy1), t_(xy2), t_(w), t_(K))
    for i in range(4):
        jn, jp, jX, jg = JTV._check_rt(jnp.asarray(Rs[i]), jnp.asarray(ts[i]), jnp.asarray(xy1),
                                       jnp.asarray(xy2), jnp.asarray(w), jnp.asarray(K))
        jg = np.asarray(jg)
        assert abs(int(n_good[i]) - int(jn)) <= max(1, 0.01 * int(jn))
        assert (good[i].numpy() == jg).mean() >= 0.99
        np.testing.assert_allclose(float(par[i]), float(jp), rtol=1e-3, atol=1e-3)
        both = good[i].numpy() & jg
        np.testing.assert_allclose(X[i].numpy()[both], np.asarray(jX)[both], rtol=1e-4, atol=1e-4)
    assert int(n_good[0]) > 100 and int(n_good[1]) == 0


def assert_same_motions(got, ref, atol=1e-4):
    """Two lists of (R, t) hold the same set of motions."""
    (gR, gt), (rR, rt) = got, ref
    assert len(gR) == len(rR)
    left = list(range(len(rR)))
    for R, t in zip(gR, gt):
        hit = [j for j in left if np.abs(R - rR[j]).max() < atol
               and np.abs(t - rt[j]).max() < atol]
        assert hit, (R, t)
        left.remove(hit[0])


def test_decompose_E_same_set(pair):
    R, t, *_ = pair
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = (tx @ R).astype(np.float32)
    ref = [np.asarray(a) for a in JTV._decompose_E(jnp.asarray(E))]
    got = [a.numpy() for a in TTV._decompose_E(t_(E))]
    assert_same_motions(got, ref)
    assert any(angular_err_deg(Rg, R) < 0.01 for Rg in got[0])


def test_decompose_H_same_set():
    _, R, t, *_ = synth_pair(seed=1, planar=True)
    n = np.array([0.0, 0.0, 1.0])
    Hn = R + np.outer(t, n) / 4.0  # the plane z = 4 of the planar pair
    H = (K @ Hn @ np.linalg.inv(K)).astype(np.float32)
    ref = [np.asarray(a) for a in JTV._decompose_H(jnp.asarray(H), jnp.asarray(K))]
    got = [a.numpy() for a in TTV._decompose_H(t_(H), t_(K))]
    assert got[0].shape == (8, 3, 3) and got[1].shape == (8, 3)
    assert_same_motions(got, ref)
    assert any(angular_err_deg(Rg, R) < 0.05 for Rg in got[0])


@pytest.mark.parametrize("seed,planar", [(0, False), (1, True)])
def test_initialize_two_view_with_jax_draws(seed, planar):
    _, R, t, xy1, xy2, w = synth_pair(seed=seed, planar=planar)
    key = jax.random.PRNGKey(seed)
    ref = JTV.initialize_two_view(key, jnp.asarray(xy1), jnp.asarray(xy2),
                                  jnp.asarray(w), jnp.asarray(K))
    idx_H, idx_F = jax_draws(key, w)
    got = TTV.initialize_two_view(t_(xy1), t_(xy2), t_(w), t_(K),
                                  idx_H=t_(idx_H), idx_F=t_(idx_F))
    assert bool(got.success) == bool(ref.success) is True
    assert bool(got.used_homography) == bool(ref.used_homography) == planar
    assert rot_angle_deg(got.R.numpy(), ref.R) < 0.05
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-3)
    assert (got.good.numpy() == np.asarray(ref.good)).mean() >= 0.99
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= 0.01 * int(ref.n_inliers)


def test_initialize_two_view_with_its_own_generator():
    """The physical gates of tests/test_twoview.py; the same seed gives the
    same draws and the same result, another seed other draws (the result
    may still be the same: the refits on the inliers forget the draws)."""
    pts, R, t, xy1, xy2, w = synth_pair()

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return TTV.initialize_two_view(t_(xy1), t_(xy2), t_(w), t_(K), generator=g)

    a, b, c = run(0), run(0), run(1)
    assert bool(a.success)
    assert angular_err_deg(a.R.numpy().astype(np.float64), R) < 1.0
    assert abs(a.t.numpy() @ t / np.linalg.norm(t)) > 0.995
    good = a.good.numpy()
    assert good.sum() > 100
    X = a.points3d.numpy()[good]
    scale = np.median(X[:, 2] / pts[good][:, 2])
    assert np.median(np.abs(X / scale - pts[good]).max(axis=-1)) < 0.15
    assert torch.equal(a.R, b.R) and torch.equal(a.points3d, b.points3d)
    assert bool(c.success)
    draws = [TTV.draw_minimal_sets(t_(w), generator=torch.Generator().manual_seed(sd))
             for sd in (0, 0, 1)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])


def test_pure_rotation_is_rejected_and_few_matches_do_not_raise():
    _, _, _, xy1, xy2, w = synth_pair(seed=4, t=np.zeros(3, np.float32), noise=0.1)
    g = torch.Generator().manual_seed(3)
    assert not bool(TTV.initialize_two_view(t_(xy1), t_(xy2), t_(w), t_(K),
                                            generator=g).success)
    # fewer than 8 matches (the first frame of an attempt has none): the
    # draw stays valid and the attempt fails
    few = np.zeros_like(w)
    few[:3] = True
    res = TTV.initialize_two_view(t_(xy1), t_(xy2), t_(few), t_(K), generator=g)
    assert not bool(res.success)
    idx = TTV.draw_minimal_sets(t_(w), generator=g)
    assert idx.shape == (TTV.N_HYPOTHESES, 8)
    assert w[idx.numpy()].all()  # only matched rows are drawn
    assert all(len(set(r)) == 8 for r in idx.numpy().tolist())
