"""The port's ORB extraction (ops/features.py extract_orb) against the JAX
package's on the same rendered room frames.

Level 0 works on the u8 image itself, so its corners, FAST scores and the
selection are computed from integers and must agree exactly. The levels
above are float images (antialiased bilinear resize, a matrix product whose
sums run in another order than XLA's): a FAST comparison d > th can flip at
a few pixels there. So the whole set is compared by (octave, x, y) and must
agree on at least 99% of the valid keypoints; matched keypoints must carry
identical descriptors on at least 99%, angles within 1e-3 rad and patches
within 0.01 gray levels (f32 rounding of the same sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import OrbParams as JOrb
from orbslam2_tpu.io import synth
from orbslam2_tpu.ops import features as JF
from orbslam2_tpu_torch.config import OrbParams as TOrb
from orbslam2_tpu_torch.ops import features as TF

CASES = [  # (width, height, levels, features)
    (160, 120, 4, 300),
    (320, 240, 8, 500),
]


def _frame(W, H, i=3):
    f = 500.0 * W / 640
    scene = synth.make_room(seed=0, width=W, height=H, fx=f, fy=f)
    gt = synth.orbit_trajectory(10)
    return np.clip(synth.render_room(scene, gt[i], seed=i), 0, 255).astype(np.uint8)


def _extract_both(W, H, L, NF):
    img = _frame(W, H)
    j = jax.tree.map(np.asarray, JF.extract_orb(
        jnp.asarray(img), JOrb(n_features=NF, n_levels=L), H, W))
    t = TF.extract_orb(torch.from_numpy(img), TOrb(n_features=NF, n_levels=L), H, W)
    return j, [x.numpy() for x in t]


@pytest.mark.parametrize("W,H,L,NF", CASES)
def test_extract_orb_parity(W, H, L, NF):
    j, t = _extract_both(W, H, L, NF)
    xy_j, resp_j, ang_j, oct_j, desc_j, val_j, patch_j = j
    xy_t, resp_t, ang_t, oct_t, desc_t, val_t, patch_t = t
    assert xy_t.shape == xy_j.shape and desc_t.dtype == np.int32
    assert val_j.sum() > 0.8 * NF

    # level 0: integer positions, validity and descriptors exactly equal;
    # subpixel positions within f32 rounding of the same quadratic fit
    l0 = (oct_j == 0) & val_j
    np.testing.assert_array_equal(oct_t == 0, oct_j == 0)
    np.testing.assert_array_equal(val_t[oct_t == 0], val_j[oct_j == 0])
    np.testing.assert_array_equal(np.round(xy_t[l0] * 4), np.round(xy_j[l0] * 4))
    np.testing.assert_allclose(xy_t[l0], xy_j[l0], atol=1e-3)
    np.testing.assert_array_equal(desc_t[l0], desc_j[l0].view(np.int32))

    # the whole set, keyed by (octave, integer position)
    def keys(oct_, xy, val):
        return {(int(o), int(round(x * 8)), int(round(y * 8))): i
                for i, (o, (x, y), v) in enumerate(zip(oct_, xy, val)) if v}
    kj, kt = keys(oct_j, xy_j, val_j), keys(oct_t, xy_t, val_t)
    common = sorted(set(kj) & set(kt))
    assert len(common) >= 0.99 * len(kj), (len(common), len(kj))
    ij = np.array([kj[k] for k in common])
    it = np.array([kt[k] for k in common])
    same_desc = np.all(desc_t[it] == desc_j[ij].view(np.int32), axis=1)
    assert same_desc.mean() >= 0.99, same_desc.mean()
    np.testing.assert_allclose(ang_t[it], ang_j[ij], atol=1e-3)
    np.testing.assert_allclose(patch_t[it], patch_j[ij], atol=1e-2)
    np.testing.assert_allclose(resp_t[it], resp_j[ij], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("hw", [(480, 640), (400, 533), (57, 80)])
def test_pyramid_weights_match_jax_resize(hw):
    """One pyramid step: the port's two weight matrices against
    jax.image.resize(..., "bilinear"), which antialiases when it shrinks."""
    H, W = hw
    h, w = int(round(H / 1.2)), int(round(W / 1.2))
    img = np.random.default_rng(0).uniform(0, 255, (H, W)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (h, w), method="bilinear"))
    wy = torch.from_numpy(TF._resize_weights(H, h))
    wx = torch.from_numpy(TF._resize_weights(W, w))
    out = (wy @ torch.from_numpy(img) @ wx.T).numpy()
    # f32: the weights differ from JAX's in the last bits and the two
    # contractions sum in another order; measured up to 1.5e-5 relative
    np.testing.assert_allclose(out, ref, rtol=5e-5, atol=1e-3)


def test_static_tables_match():
    p = JOrb()
    np.testing.assert_array_equal(TF.brief_pattern(), JF.brief_pattern())
    assert TF.features_per_level(1000, 8, 1.2) == JF.features_per_level(1000, 8, 1.2)
    assert TF.level_sizes(480, 640, 8, 1.2) == JF.level_sizes(480, 640, 8, 1.2)
    np.testing.assert_array_equal(TF.scale_factors(TOrb()), JF.scale_factors(p))
    np.testing.assert_array_equal(TF.sigma2_per_octave(TOrb()), JF.sigma2_per_octave(p))
    assert TF.padded_capacity(1000) == JF.padded_capacity(1000) == 1024
    for a, b in zip(TF._ic_angle_masks(), JF._ic_angle_masks()):
        np.testing.assert_array_equal(a, b)


def test_stable_descending_sort_matches_top_k_ties():
    """Selection ties keep the lower flat index, as lax.top_k does (tier
    scores on u8 images tie often)."""
    x = np.array([1, 3, 3, 0, 3, 2, 2, 0, 1, 3], np.float32)
    vj, ij = jax.lax.top_k(jnp.asarray(x), 6)
    vt, it = torch.sort(torch.from_numpy(x), descending=True, stable=True)
    np.testing.assert_array_equal(it[:6].numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt[:6].numpy(), np.asarray(vj))


def test_blur_matches_jax():
    atlas = np.random.default_rng(4).uniform(0, 255, (3, 40, 50)).astype(np.float32)
    j = np.asarray(JF.gaussian_blur7_batched(jnp.asarray(atlas)))
    t = TF.gaussian_blur7_batched(torch.from_numpy(atlas)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-4)  # same taps, same order


def test_fast_nms_match_jax():
    """FAST + NMS on an integer-valued atlas: scores are sums of integers,
    so the response maps agree exactly."""
    atlas = np.random.default_rng(5).integers(0, 256, (2, 48, 64)).astype(np.float32)
    jh, jl = JF._fast_response_batched(jnp.asarray(atlas), 20, 7)
    th, tl = TF._fast_response_batched(torch.from_numpy(atlas), 20, 7)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(TF._nms3_batched(th).numpy(),
                                  np.asarray(JF._nms3_batched(jh)))
