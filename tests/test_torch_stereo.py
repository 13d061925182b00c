"""Parity of stereo matching (ops/stereo.stereo_match) and of stereo frame
construction: the JAX functions and the port's on the same numpy inputs.

- Seeded random inputs built so that the matched count is even, odd, one
  and zero: the trim threshold is 1.5 * 1.4 * median, and for an even count
  jnp.nanmedian averages the two middle distances where torch.nanmedian
  would return the lower one. Each left descriptor is a right descriptor
  with a known number of bits flipped, so the distances, and which matches
  the trim drops, are known.
- The features of a rendered stereo pair (320x240, 500 features, the camera
  of tests/torch_slice_common.py).

The matched set must be equal; `ur` and `depth` within 1e-5 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.frontend.stereo import stereo_depths_for_frame
from orbslam2_tpu.ops import features as JF
from orbslam2_tpu.ops import stereo as JST
from orbslam2_tpu_torch.frontend.frame import FrameBuilder
from orbslam2_tpu_torch.io import synth
from orbslam2_tpu_torch.ops import features as TF
from orbslam2_tpu_torch.ops import stereo as TST
from torch_slice_common import H, NF, W, configs

SF = np.float32(1.2) ** np.arange(8, dtype=np.float32)
BF, FX = 125.0, 250.0


def _both(l_xy, l_oct, l_desc, l_valid, r_xy, r_oct, r_desc, r_valid):
    args = (l_xy, l_oct, l_desc, l_valid, r_xy, r_oct, r_desc, r_valid)
    ju, jd = JST.stereo_match(*(jnp.asarray(a) for a in args), jnp.asarray(SF), BF, FX)
    targs = [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
             for a in args]
    tu, td = TST.stereo_match(*targs, torch.from_numpy(SF), BF, FX)
    return (np.asarray(ju), np.asarray(jd)), (tu.numpy(), td.numpy())


def _assert_same(j, t):
    (ju, jd), (tu, td) = j, t
    np.testing.assert_array_equal(tu >= 0, ju >= 0)  # the matched set
    np.testing.assert_array_equal(td > 0, jd > 0)
    np.testing.assert_allclose(tu, ju, rtol=1e-5)
    np.testing.assert_allclose(td, jd, rtol=1e-5)


def _pairs(flips, n=32, seed=0):
    """n left and n right features; left i is right i with flips[i] bits
    flipped, shifted by a valid disparity on its own row, for i <
    len(flips); the other rows are far from every band."""
    rng = np.random.default_rng(seed)
    r_desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    l_desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    r_xy = np.stack([rng.uniform(20, 150, n), 12.0 * np.arange(n)], -1).astype(np.float32)
    l_xy = np.stack([rng.uniform(20, 150, n), 12.0 * np.arange(n) + 6.0], -1).astype(np.float32)
    for i, k in enumerate(flips):
        d = r_desc[i].copy()
        for b in rng.choice(256, k, replace=False):
            d[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
        l_desc[i] = d
        l_xy[i] = r_xy[i] + np.array([5.0 + i, 0.5], np.float32)
    octs = np.zeros(n, np.int32)
    valid = np.ones(n, bool)
    return l_xy, octs, l_desc, valid, r_xy, octs.copy(), r_desc, valid.copy()


@pytest.mark.parametrize("flips,kept", [
    # even count: the median is (10 + 30) / 2 = 20, the trim 42: 50 goes.
    # With the lower middle value (10, trim 21) 30 would go too.
    ([4, 10, 30, 50], 3),
    # odd count: median 10, trim 21
    ([4, 10, 30], 2),
    ([7], 1),
    ([], 0),
    # even, all kept
    ([10, 12, 14, 16, 18, 20], 6),
], ids=["even", "odd", "one", "zero", "even-all-kept"])
def test_stereo_match_median_trim(flips, kept):
    j, t = _both(*_pairs(flips))
    _assert_same(j, t)
    assert int((t[0] >= 0).sum()) == kept
    assert int((j[0] >= 0).sum()) == kept


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stereo_match_random_gates(seed):
    """Random rows, octaves, validity and disparities: every gate (row
    band by the right octave, octave window, disparity range) is hit."""
    rng = np.random.default_rng(seed)
    n = 96
    base = rng.integers(0, 2 ** 32, (12, 8), dtype=np.uint32)

    def feats():
        desc = base[rng.integers(0, 12, n)].copy()
        desc[:, 0] ^= rng.integers(0, 2 ** 12, n, dtype=np.uint32)  # a few bits
        xy = np.stack([rng.uniform(0, 320, n), rng.integers(0, 24, n) * 10.0
                       + rng.uniform(-3, 3, n)], -1).astype(np.float32)
        return xy, rng.integers(0, 8, n).astype(np.int32), desc, rng.random(n) < 0.9

    j, t = _both(*feats(), *feats())
    _assert_same(j, t)
    assert 0 < (t[0] >= 0).sum() < n


@pytest.fixture(scope="module")
def rendered_pair():
    cfg_j, cfg_t = configs("STEREO")
    f = 500.0 * W / 640
    scene = synth.make_room(seed=0, width=W, height=H, fx=f, fy=f)
    gt = synth.orbit_trajectory(4)[2]
    T_r = gt.copy()
    T_r[:, 3] -= np.array([cfg_t.camera.bf / cfg_t.camera.fx, 0, 0], np.float32)
    left = np.clip(synth.render_room(scene, gt, seed=2), 0, 255).astype(np.uint8)
    right = np.clip(synth.render_room(scene, T_r, seed=10_002), 0, 255).astype(np.uint8)
    return cfg_j, cfg_t, left, right


def test_stereo_match_on_a_rendered_pair(rendered_pair):
    """The JAX extraction's features of both images through both matchers."""
    cfg_j, _, left, right = rendered_pair
    fl = JF.extract_orb(jnp.asarray(left), cfg_j.orb, H, W)
    fr = JF.extract_orb(jnp.asarray(right), cfg_j.orb, H, W)
    args = [np.asarray(a) for f in (fl, fr) for a in (f.xy, f.octave, f.desc, f.valid)]
    np.testing.assert_allclose(JF.scale_factors(cfg_j.orb), SF, rtol=1e-6)
    j, t = _both(*args)
    _assert_same(j, t)
    assert (t[0] >= 0).sum() > 100


def test_stereo_frame_builder(rendered_pair):
    """FrameBuilder.build(right_img=...) against stereo_depths_for_frame:
    each package on its own extraction. Descriptors agree on >= 99% of the
    rows (tests/test_torch_features.py), so a match may differ on 1% of
    them; the rest agree within 1e-4 relative."""
    cfg_j, cfg_t, left, right = rendered_pair
    fl = JF.extract_orb(jnp.asarray(left), cfg_j.orb, H, W)
    ju, jd, _ = stereo_depths_for_frame(cfg_j, fl, right)
    ju, jd = np.asarray(ju), np.asarray(jd)
    frame = FrameBuilder(cfg_t, torch.device("cpu")).build(left, 0.0, right_img=right)
    assert frame.capacity == TF.padded_capacity(NF) == len(ju)
    same = (frame.ur >= 0) == (ju >= 0)
    assert same.mean() >= 0.99, (~same).sum()
    both = (frame.ur >= 0) & (ju >= 0)
    assert both.sum() > 100
    close = np.isclose(frame.ur[both], ju[both], rtol=1e-4) & np.isclose(
        frame.depth[both], jd[both], rtol=1e-4)
    assert close.mean() >= 0.99
    np.testing.assert_array_equal(frame.ur0, frame.ur)
    assert (frame.depth[both] > 0).all() and (frame.depth[~(frame.ur >= 0)] == -1).all()
