"""ops/pnp.py of the port against orbslam2_tpu/ops/pnp.py on JAX's own
minimal sets (reproduced from its threefry keys and handed to the port).

A 4-point minimal set leaves EPnP's 12x12 system an exactly 4-dimensional
kernel whose `eigh` basis is arbitrary, so single hypotheses are not
comparable elementwise between two solvers: they are held by what they
achieve (the share of noiseless minimal sets whose pose is recovered, within
3 points of JAX's share on the same sets), and the RANSAC result by its
inlier count (within 3 of JAX's), its pose (within 5 mm and 0.1 degrees of
JAX's) and the gates of tests/test_place_recognition.py themselves. Seen on
these problems: the same inlier count in all three (128, 88, 38) and poses
within 1.2 mm of JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_slice_common  # noqa: F401  (caps torch's CPU threads)
from orbslam2_tpu.geometry import se3 as JSE3
from orbslam2_tpu.ops import pnp as JP
from orbslam2_tpu_torch.ops import pnp as TP

INTR = (500.0, 500.0, 320.0, 240.0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jax_minimal_sets(key, valid):
    """The [256, 4] minimal sets pnp_ransac(key, ...) draws."""
    valid = jnp.asarray(valid)
    probs = valid.astype(jnp.float32) / jnp.maximum(jnp.sum(valid), 1.0)
    keys = jax.random.split(key, JP.N_HYPOTHESES)
    return np.asarray(jax.vmap(lambda k: jax.random.choice(
        k, valid.shape[0], (JP.MIN_SET,), replace=False, p=probs))(keys))


def rot_deg(Ra, Rb):
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    s = 0.5 * np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return np.degrees(np.arctan2(s, (np.trace(M) - 1) / 2))


def problem(seed, xi, n_out, noise):
    rng = np.random.default_rng(seed)
    n = 128
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(4, 9, n)], -1).astype(np.float32)
    T_gt = np.asarray(JSE3.se3_exp(jnp.asarray(xi, jnp.float32)))
    pc = X @ T_gt[:, :3].T + T_gt[:, 3]
    uv = np.stack([500 * pc[:, 0] / pc[:, 2] + 320,
                   500 * pc[:, 1] / pc[:, 2] + 240], -1).astype(np.float32)
    if noise:
        uv = (uv + rng.normal(0, noise, uv.shape)).astype(np.float32)
    out = rng.choice(n, n_out, replace=False)
    uv[out] = rng.uniform([0, 0], [640, 480], (n_out, 2))
    return X, uv, T_gt, out


def run_both(X, uv, key):
    n = len(X)
    ones, valid = np.ones(n, np.float32), np.ones(n, bool)
    jres = JP.pnp_ransac(key, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(ones),
                         jnp.asarray(valid), *INTR)
    idx = jax_minimal_sets(key, valid)
    tres = TP.pnp_ransac(_t(X), _t(uv), _t(ones), _t(valid), *INTR, idx=_t(idx))
    return jres, tres


# (seed, twist of the true pose, outliers, pixel noise, least inliers): the
# three RANSAC cases of tests/test_place_recognition.py
CASES = {
    "recover_pose": (4, [0.3, -0.1, 0.2, 0.05, -0.04, 0.08], 0, 0.5, 101),
    "outliers": (5, [0.1, 0.0, 0.2, 0.0, 0.0, 0.0], 40, 0.0, 70),
    "low_inlier_regime": (11, [0.1, 0.2, -0.1, 0.02, 0.05, -0.03], 90, 0.5, 30),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pnp_ransac_against_jax_on_its_draws(case):
    seed, xi, n_out, noise, least = CASES[case]
    X, uv, T_gt, out = problem(seed, xi, n_out, noise)
    jres, tres = run_both(X, uv, jax.random.PRNGKey(1))
    T, inl = tres.T.numpy(), tres.inliers.numpy()
    assert abs(int(tres.n_inliers) - int(jres.n_inliers)) <= 3
    assert inl.sum() == int(tres.n_inliers) >= least
    assert inl[out].sum() <= 2
    Tj = np.asarray(jres.T)
    assert np.abs(T[:, 3] - Tj[:, 3]).max() <= 5e-3
    assert rot_deg(T[:, :3], Tj[:, :3]) <= 0.1
    assert np.abs(T - T_gt).max() < 0.05


def test_epnp_minimal_set_recovery_rate_matches_jax():
    """Noiseless 4-point sets: the port recovers the pose on the same share
    of them as JAX does, within 3 points of 100, and on at least 80%."""
    rng = np.random.default_rng(4)
    T_gt = np.asarray(JSE3.se3_exp(jnp.asarray([0.3, -0.1, 0.2, 0.05, -0.04, 0.08])))
    n_sets = 200
    X = np.stack([rng.uniform(-2, 2, (n_sets, 4)), rng.uniform(-1.5, 1.5, (n_sets, 4)),
                  rng.uniform(4, 9, (n_sets, 4))], -1).astype(np.float32)
    pc = X @ T_gt[:, :3].T + T_gt[:, 3]
    uv = np.stack([500 * pc[..., 0] / pc[..., 2] + 320,
                   500 * pc[..., 1] / pc[..., 2] + 240], -1).astype(np.float32)
    Tj = np.asarray(jax.vmap(lambda x, u: JP._epnp_pose(x, u, *INTR))(
        jnp.asarray(X), jnp.asarray(uv)))
    Tt = TP._epnp_pose(_t(X), _t(uv), *INTR).numpy()
    assert Tt.shape == (n_sets, 3, 4)
    good_j = np.abs(Tj - T_gt).max((1, 2)) < 0.05
    good_t = np.abs(Tt - T_gt).max((1, 2)) < 0.05
    assert good_t.mean() >= 0.8
    assert abs(good_t.mean() - good_j.mean()) <= 0.03, (good_t.mean(), good_j.mean())
    # one set alone gives the pose of its row in the batch
    one = TP._epnp_pose(_t(X[7]), _t(uv[7]), *INTR).numpy()
    np.testing.assert_allclose(one, Tt[7], atol=1e-4)


def test_drawn_sets_are_valid_rows_without_repeats():
    valid = np.zeros(1024, bool)
    valid[[3, 40, 41, 500, 900, 1023]] = True
    gen = torch.Generator()
    gen.manual_seed(17)
    idx = TP.draw_minimal_sets(_t(valid), gen).numpy()
    assert idx.shape == (TP.N_HYPOTHESES, TP.MIN_SET)
    assert valid[idx].all()
    assert all(len(set(row)) == TP.MIN_SET for row in idx)
    gen.manual_seed(17)
    np.testing.assert_array_equal(TP.draw_minimal_sets(_t(valid), gen).numpy(), idx)
