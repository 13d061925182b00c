"""The port's Schur-complement BA (ops/ba.py) and its problem builder
(local_mapping.build_ba_problem) against the JAX package's.

Tolerances:
- ba_solve on a seeded, perturbed problem (C=8, P=256, E=1024; mono and
  stereo edges; the first camera fixed), with the dense-Schur and with the
  PCG solver: final cost within 1e-3 relative, poses within 1e-4 (rotation
  entries; translations, up to 5.6 m here, within 1e-4 m + 1e-4 relative),
  inlier
  masks equal on >= 99.5% of edges. The segment sums run in another order
  (index_add_ against XLA's segment_sum), so an LM accept or an edge near
  its chi2 threshold may flip. Points are not compared: the few seen by
  one or two cameras far away are weakly constrained.
- build_ba_problem on one map: every array equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu import local_mapping as JLM
from orbslam2_tpu.ops import ba as JBA
from orbslam2_tpu.ops import features as JF
from orbslam2_tpu_torch import interop
from orbslam2_tpu_torch import local_mapping as TLM
from orbslam2_tpu_torch.ops import ba as TBA
from torch_slice_common import configs, jax_sweep_map

C, P, E = 8, 256, 1024


@pytest.fixture(scope="module")
def problem():
    return TBA.synthetic_problem(C, P, E, seed=3)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_ba_solve_matches_jax(problem, solver):
    arrays, intr = problem
    jp = JBA.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jr = jax.tree.map(np.asarray, JBA.ba_solve(jp, *intr, solver=solver))
    tr = TBA.ba_solve(TBA.problem_from_numpy(arrays, torch.device("cpu")), *intr,
                      solver=solver)
    cost0 = float(JBA.ba_solve(jp, *intr, iters1=0, iters2=0, solver=solver).cost)
    assert float(jr.cost) < 0.5 * cost0 or not np.isfinite(cost0)  # it converged
    np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-3)
    np.testing.assert_allclose(tr.cam_T.numpy()[..., :3], jr.cam_T[..., :3], atol=1e-4)
    np.testing.assert_allclose(tr.cam_T.numpy()[..., 3], jr.cam_T[..., 3],
                               rtol=1e-4, atol=1e-4)
    assert (tr.e_inlier.numpy() == jr.e_inlier).mean() >= 0.995
    assert jr.e_inlier.sum() > 0.9 * arrays["e_valid"].sum()


def test_solver_choice():
    assert TBA._use_dense_schur(16, 2048, "auto")
    assert TBA._use_dense_schur(128, 8192, "auto")
    assert not TBA._use_dense_schur(128, 65536, "auto")
    assert TBA._use_dense_schur(128, 65536, "dense")
    assert not TBA._use_dense_schur(8, 256, "cg")


def test_build_ba_problem_matches_jax():
    jmap = jax_sweep_map()
    cfg_j, cfg_t = configs()
    tmap = interop.map_from_numpy(
        {k: getattr(jmap, k) for k in jmap._ARRAY_FIELDS}, cfg_t)
    kfs = [int(k) for k in np.flatnonzero(jmap.kf_valid)]
    cams, fixed = kfs, kfs[:1]
    sigma2 = JF.sigma2_per_octave(cfg_j.orb)
    jprob, jmeta = JLM.build_ba_problem(jmap, cfg_j, sigma2, cams, fixed)
    tprob, tmeta = TLM.build_ba_problem(tmap, cfg_t, sigma2, cams, fixed)
    assert jmeta["E_need"] == tmeta["E_need"] > 100
    for k in ("points", "kf_of_e", "fi"):
        np.testing.assert_array_equal(tmeta[k], jmeta[k])
    for name in JBA.BAProblem._fields:
        np.testing.assert_array_equal(getattr(tprob, name).numpy(),
                                      np.asarray(getattr(jprob, name)), err_msg=name)
