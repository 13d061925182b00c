"""The port's block function (engine_step.track_frames_block) against the
JAX package's on identical inputs: a room map bootstrapped by the JAX
tracker from orbit frames 0-1 (320x240, 500 features), then frames 2-7 as
one 6-frame block with the device-side constant-velocity prediction.

Tolerances, those for one fused frame (tests/test_torch_engine_step.py),
applied to every frame of the block: octave and valid exact; whole
descriptor rows on >= 99% (a BRIEF sample whose rotated offset sits at .5
px may round the other way); at most 1% of the rows of the other integer
fields, of in_frustum and of kp_pt differ; counts within 1% (+1); poses
within 1e-4; fmat's f32 columns within 1e-5 relative (1e-3 absolute);
u8 patches within 1. The carried chain agrees to the same tolerances.
_predict_pose (the SVD of the JAX package against the port's Newton polar
iteration) agrees within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu import engine_step as JES
from orbslam2_tpu.geometry import se3 as JSE3
from orbslam2_tpu.map.mapstate import MapState as JMap
from orbslam2_tpu.ops import features as JF
from orbslam2_tpu.tracking import Tracker as JTracker
from orbslam2_tpu.tracking import _depth_wire, _ensure_patch
from orbslam2_tpu_torch import engine_step as TES
from orbslam2_tpu_torch.io import synth
from torch_slice_common import NF, configs, render

K = 6


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype == np.uint16:
        a = a.astype(np.int32)
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def blocks():
    cfg_j, cfg_t = configs()
    frames = render(synth.orbit_trajectory(20)[:2 + K])
    jt = JTracker(cfg_j, JMap(cfg_j, JF.padded_capacity(NF)), None, relocalizer=None)
    for i in range(2):
        assert jt.process_image(frames[i][0], i / 30.0, depth_map=frames[i][1]) is not None
    mp, last = jt.map, jt.last_frame
    _ensure_patch(last)
    lp_pad, pvalid, _ = jt._select_local_points(last.pt_idx)
    wired = [_depth_wire(d, cfg_j.depth_map_factor) for _, d in frames[2:]]
    T_prev = mp.kf_pose[0]  # frame 0 is the first keyframe
    inputs = (np.stack([f[0] for f in frames[2:]]), np.stack([w[0] for w in wired]),
              last.pose, T_prev, last.pt_idx, last.xy, last.desc, last.octave,
              last.angle, np.clip(np.round(last.patch), 0, 255).astype(np.uint8),
              last.valid, last.depth, mp.pt_xyz, mp.pt_desc,
              np.clip(np.round(mp.pt_patch), 0, 255).astype(np.uint8),
              mp.pt_normal, mp.pt_min_dist, mp.pt_max_dist, mp.pt_valid,
              lp_pad, pvalid, jt.sf, jt.sigma2)
    statics = dict(close_th=float(cfg_j.close_depth_threshold),
                   depth_factor=wired[0][1], log_scale=float(np.log(1.2)),
                   sensor="rgbd")
    jo, jchain, _ = JES.track_frames_block(*map(jnp.asarray, inputs), params=cfg_j.orb,
                                           cam=cfg_j.camera, **statics)
    to, tchain = TES.track_frames_block(*map(_t, inputs), params=cfg_t.orb,
                                        cam=cfg_t.camera, **statics)
    return (jax.tree.map(np.asarray, jo), jax.tree.map(np.asarray, jchain),
            to, tchain)


def test_every_field_of_every_frame(blocks):
    jo, _, to, _ = blocks
    for k in range(K):
        hj, ht = jo.hdr[k], to.hdr[k].numpy()
        assert hj[27] > 100  # the frame tracked on the map
        np.testing.assert_allclose(ht[24:28], hj[24:28], rtol=0.01, atol=1)
        np.testing.assert_allclose(ht[:24], hj[:24], atol=1e-4)
        np.testing.assert_allclose(to.T_out[k].numpy(), jo.T_out[k], atol=1e-4)
        imat_j, imat_t = jo.imat[k], to.imat[k].numpy()
        np.testing.assert_array_equal(imat_t[:, [0, 4]], imat_j[:, [0, 4]])
        same_desc = np.all(to.desc[k].numpy() == jo.desc[k].view(np.int32), axis=1)
        assert same_desc.mean() >= 0.99
        rows_differ = np.any(imat_t[:, 1:4] != imat_j[:, 1:4], axis=1)
        assert rows_differ.mean() <= 0.01, (k, rows_differ.sum())
        assert (to.in_frustum[k].numpy() != jo.in_frustum[k]).mean() <= 0.01
        assert (to.kp_pt[k].numpy() != jo.kp_pt[k]).mean() <= 0.01
        fm_t, fm_j = to.fmat[k].numpy(), jo.fmat[k]
        np.testing.assert_allclose(fm_t[:, 4:], fm_j[:, 4:], rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(fm_t[~rows_differ, :4], fm_j[~rows_differ, :4],
                                   atol=1e-3)
        assert np.abs(to.patch[k].numpy().astype(int) - jo.patch[k].astype(int)).max() <= 1


def test_chain_is_the_last_frame(blocks):
    jo, jchain, to, tchain = blocks
    np.testing.assert_allclose(tchain[0].numpy(), jchain[0], atol=1e-4)  # T_out
    np.testing.assert_allclose(tchain[1].numpy(), jchain[1], atol=1e-4)  # T of K-2
    assert (tchain[2].numpy() != jchain[2]).mean() <= 0.01               # kp_pt
    assert tchain[7].dtype == torch.uint8
    assert torch.equal(tchain[2], to.kp_pt[-1]) and torch.equal(tchain[4], to.desc[-1])


def test_predict_pose_within_1e6():
    rng = np.random.default_rng(1)
    for _ in range(20):
        Tl = np.asarray(JSE3.se3_exp(jnp.asarray(rng.normal(0, 0.3, 6), jnp.float32))).copy()
        Tp = np.asarray(JSE3.se3_exp(jnp.asarray(rng.normal(0, 0.3, 6), jnp.float32)))
        Tl[:, :3] *= 1.001  # a slightly scaled rotation, as f32 chains leave it
        j = np.asarray(JES._predict_pose(jnp.asarray(Tl), jnp.asarray(Tp)))
        t = TES._predict_pose(_t(Tl), _t(Tp)).numpy()
        np.testing.assert_allclose(t, j, atol=1e-6)
