"""Parity of the monocular-initialization step: `search_for_initialization`
and `engine_step.mono_init_step`, the JAX functions and the port's on the
same inputs (frames 0 and 6 of the 30-frame room orbit at 320x240, 500
features doubled to 1000, as the tracker doubles them to initialize).

The JAX step draws its RANSAC sets from its key inside the program; the
test reproduces those draws from the key and JAX's match mask
(tests/test_torch_twoview.jax_draws) and injects them into the port.

Tolerances: match indices exact on JAX's own features; on each package's own
extraction `n_valid` and `n_matches` exact, `success` equal, `n_good` within
2%, R and t within 1e-3, and the packed frame as tests/test_torch_engine_step
.py holds it (octave and valid exact, descriptors on >= 99% of rows, floats
to 1e-3, u8 windows within one level).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu import engine_step as JES
from orbslam2_tpu.ops import features as JF
from orbslam2_tpu.ops import matching as JM
from orbslam2_tpu_torch import engine_step as TES
from orbslam2_tpu_torch.io import synth
from orbslam2_tpu_torch.ops import matching as TM
from test_torch_twoview import jax_draws
from torch_slice_common import H, NF, W, configs

N = 1024  # the capacity of the doubled budget


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    cfg_j, cfg_t = configs("MONOCULAR")
    from dataclasses import replace
    orb_j = replace(cfg_j.orb, n_features=2 * NF)
    orb_t = replace(cfg_t.orb, n_features=2 * NF)
    f = 500.0 * W / 640
    scene = synth.make_room(seed=0, width=W, height=H, fx=f, fy=f)
    gt = synth.orbit_trajectory(30)
    imgs = [np.clip(synth.render_room(scene, gt[i], seed=i), 0, 255).astype(np.uint8)
            for i in (0, 6)]
    sf = JF.scale_factors(orb_j)
    zeros = (np.zeros((N, 2), np.float32), np.zeros((N, 8), np.uint32),
             np.zeros(N, bool), np.zeros(N, np.float32),
             np.zeros((N, 15, 15), np.uint8))
    key = jax.random.PRNGKey(5)

    def jstep(img, k, ref):
        out = JES.mono_init_step(jnp.asarray(img), k, *map(jnp.asarray, ref),
                                 jnp.asarray(sf), params=orb_j, cam=cfg_j.camera)
        return jax.tree.map(np.asarray, out)

    def tstep(img, ref, **kw):
        return TES.mono_init_step(_t(img), *map(_t, ref), _t(sf), params=orb_t,
                                  cam=cfg_t.camera, **kw)

    def ref_of(o):
        get = (lambda a: a.numpy()) if isinstance(o.hdr, torch.Tensor) else np.asarray
        return (get(o.fmat)[:, 0:2], get(o.desc), get(o.imat)[:, 4] != 0,
                get(o.fmat)[:, 9], get(o.patch))

    j0 = jstep(imgs[0], jax.random.PRNGKey(4), zeros)
    t0 = tstep(imgs[0], zeros, generator=torch.Generator().manual_seed(0))
    j1 = jstep(imgs[1], key, ref_of(j0))
    idx_H, idx_F = jax_draws(key, j1.idx >= 0)
    t1 = tstep(imgs[1], ref_of(t0), idx_H=_t(idx_H), idx_F=_t(idx_F))
    return dict(j0=j0, t0=t0, j1=j1, t1=t1, ref_j=ref_of(j0))


def test_search_for_initialization_indices_exact(setup):
    """Both matchers on JAX's features of both frames."""
    s = setup
    xy_a, desc_a, valid_a, ang_a, _ = s["ref_j"]
    j1 = s["j1"]
    cur = (j1.fmat[:, 0:2], j1.desc, j1.imat[:, 4] != 0, j1.fmat[:, 9])
    jr = JM.search_for_initialization(*map(jnp.asarray, (xy_a, desc_a, valid_a, ang_a)),
                                      *map(jnp.asarray, cur))
    tr = TM.search_for_initialization(*map(_t, (xy_a, desc_a, valid_a, ang_a)),
                                      *map(_t, cur))
    np.testing.assert_array_equal(tr.idx.numpy(), np.asarray(jr.idx))
    np.testing.assert_array_equal(tr.dist.numpy(), np.asarray(jr.dist))
    np.testing.assert_array_equal(np.asarray(jr.idx), j1.idx)  # what the step matched
    assert (np.asarray(jr.idx) >= 0).sum() >= 100


def _assert_frame_packing(t, j):
    imat_j, imat_t = j.imat, t.imat.numpy()
    np.testing.assert_array_equal(imat_t[:, [0, 1, 2, 4]], imat_j[:, [0, 1, 2, 4]])
    assert (imat_t[:, 3] != imat_j[:, 3]).mean() <= 0.01  # the refined flag
    assert np.all(t.desc.numpy() == j.desc.view(np.int32), axis=1).mean() >= 0.99
    np.testing.assert_allclose(t.fmat.numpy(), j.fmat, rtol=1e-5, atol=1e-3)
    assert np.abs(t.patch.numpy().astype(int) - j.patch.astype(int)).max() <= 1


def test_first_attempt_without_a_reference(setup):
    j, t = setup["j0"], setup["t0"]
    hj, ht = j.hdr, t.hdr.numpy()
    assert ht[0] == hj[0] > 100        # n_valid
    assert ht[1] == hj[1] == 0         # nothing to match
    assert ht[2] == hj[2] == 0         # no success
    assert np.isfinite(ht).all()
    _assert_frame_packing(t, j)


def test_mono_init_step_with_jax_draws(setup):
    j, t = setup["j1"], setup["t1"]
    hj, ht = j.hdr, t.hdr.numpy()
    assert ht[0] == hj[0] and ht[1] == hj[1] >= 100  # n_valid, n_matches
    assert ht[2] == hj[2] == 1                       # success
    assert abs(ht[3] - hj[3]) <= 0.02 * hj[3] and hj[3] >= 50  # n_good
    np.testing.assert_allclose(ht[4:16], hj[4:16], atol=1e-3)  # R, t
    np.testing.assert_array_equal(t.idx.numpy(), j.idx)
    m = j.idx >= 0
    assert (t.good.numpy() == j.good)[m].mean() >= 0.98
    assert (t.ref_ok.numpy() == j.ref_ok).mean() >= 0.99
    both = t.ref_ok.numpy() & j.ref_ok
    np.testing.assert_allclose(t.xy2.numpy()[both], j.xy2[both], atol=2e-2)
    np.testing.assert_allclose(t.xy2_raw.numpy()[both], j.xy2_raw[both], atol=2e-2)
    g = t.good.numpy() & j.good & m
    # triangulated points: relative to their depth (the parallax is small)
    rel = np.abs(t.X.numpy()[g] - j.X[g]).max(-1) / np.abs(j.X[g, 2])
    assert np.median(rel) < 1e-2
    _assert_frame_packing(t, j)


def test_mono_init_step_draws_from_its_generator(setup):
    """Without injected sets the step draws from the generator it is given:
    the same seed gives the same header, and the attempt succeeds as with
    JAX's draws."""
    import orbslam2_tpu_torch.ops.twoview as TTV
    calls = []
    real = TTV.draw_minimal_sets

    def spy(w, n_hyp=TTV.N_HYPOTHESES, generator=None):
        calls.append(generator)
        return real(w, n_hyp, generator)

    cfg_t = configs("MONOCULAR")[1]
    from dataclasses import replace
    orb_t = replace(cfg_t.orb, n_features=2 * NF)
    f = 500.0 * W / 640
    scene = synth.make_room(seed=0, width=W, height=H, fx=f, fy=f)
    img = np.clip(synth.render_room(scene, synth.orbit_trajectory(30)[6], seed=6),
                  0, 255).astype(np.uint8)
    t0 = setup["t0"]
    ref = (t0.fmat[:, 0:2], t0.desc, t0.imat[:, 4] != 0, t0.fmat[:, 9], t0.patch)
    sf = _t(JF.scale_factors(orb_t))
    TTV.draw_minimal_sets = spy
    try:
        hdrs = []
        for seed in (0, 0):
            g = torch.Generator().manual_seed(seed)
            hdrs.append(TES.mono_init_step(_t(img), *ref, sf, params=orb_t,
                                           cam=cfg_t.camera, generator=g).hdr)
            assert calls[-2:] == [g, g]  # the H and the F sweep
    finally:
        TTV.draw_minimal_sets = real
    assert torch.equal(hdrs[0], hdrs[1])
    assert hdrs[0][2] == 1 and hdrs[0][1] == setup["t1"].hdr[1]
