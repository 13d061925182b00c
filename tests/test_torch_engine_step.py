"""The port's fused frame (engine_step.py) against the JAX package's, on
identical inputs: a room map bootstrapped from frame 0's depth by the JAX
tracker, and frame 1 of the orbit.

Tolerances:
- extraction agrees at this size (tests/test_torch_features.py): octave
  and valid exactly, descriptors on >= 99% of rows; the other integer fields
  of `imat` follow from the matching and, with the LM sums in another order a few bindings near a
  chi2 threshold may flip, so at most 1% of the rows may differ;
- the counts in `hdr` within 1% (+1);
- poses within 1e-4 (rotation entries, translation in m): 40 LM steps of
  f32 normal equations summed in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu import config as JC
from orbslam2_tpu import engine_step as JES
from orbslam2_tpu.io import synth
from orbslam2_tpu.map.mapstate import MapState as JMap
from orbslam2_tpu.ops import features as JF
from orbslam2_tpu.tracking import Tracker as JTracker
from orbslam2_tpu.tracking import _depth_wire as j_depth_wire
from orbslam2_tpu_torch import config as TC
from orbslam2_tpu_torch import engine_step as TES
from orbslam2_tpu_torch.tracking import _depth_wire as t_depth_wire

W, H, NF = 320, 240, 500


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype == np.uint16:
        a = a.astype(np.int32)
    return torch.from_numpy(np.array(a))  # a writable copy


@pytest.fixture(scope="module")
def setup():
    f = 500.0 * W / 640
    scene = synth.make_room(seed=0, width=W, height=H, fx=f, fy=f)
    gt = synth.orbit_trajectory(20)
    cam = dict(fx=f, fy=f, cx=float(scene.K[0, 2]), cy=float(scene.K[1, 2]),
               width=W, height=H, bf=250.0 * W / 640)
    kw = dict(th_depth=25.0, local_points_cap=1024, max_points=4096, max_keyframes=16)
    cfg_j = JC.with_camera(JC.SlamConfig(sensor=JC.Sensor.RGBD, orb=JC.OrbParams(
        n_features=NF), **kw), **cam)
    cfg_t = TC.with_camera(TC.SlamConfig(sensor=TC.Sensor.RGBD, orb=TC.OrbParams(
        n_features=NF), **kw), **cam)
    frames = [(np.clip(synth.render_room(scene, gt[i], seed=i), 0, 255).astype(np.uint8),
               synth.depth_room(scene, gt[i])) for i in (0, 2)]
    jt = JTracker(cfg_j, JMap(cfg_j, JF.padded_capacity(NF)), None, relocalizer=None)
    jt.process_image(frames[0][0], 0.0, depth_map=frames[0][1])
    assert jt.state.name == "OK"
    mp, last = jt.map, jt.last_frame
    lp_pad, pvalid, _ = jt._select_local_points(last.pt_idx)
    d16, factor = j_depth_wire(frames[1][1], cfg_j.depth_map_factor)
    patch_u8 = np.clip(np.round(last.patch), 0, 255).astype(np.uint8)
    mirror = (mp.pt_xyz, mp.pt_desc,
              np.clip(np.round(mp.pt_patch), 0, 255).astype(np.uint8),
              mp.pt_normal, mp.pt_min_dist, mp.pt_max_dist, mp.pt_valid)
    inputs = (frames[1][0], d16, last.pose, last.pose, last.pt_idx, last.xy,
              last.desc, last.octave, last.angle, patch_u8, last.valid,
              last.depth, np.asarray(False), *mirror, lp_pad, pvalid,
              np.float32(1.0), jt.sf, jt.sigma2)
    statics = dict(close_th=float(cfg_j.close_depth_threshold), depth_factor=factor,
                   log_scale=float(np.log(1.2)), sensor="rgbd")
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, inputs=inputs, statics=statics,
                frames=frames, mp=mp, lp=lp_pad[pvalid], last=last, jt=jt)


def test_track_frame_full_rgbd(setup):
    s = setup
    jo = JES.track_frame_full(*map(jnp.asarray, s["inputs"]), params=s["cfg_j"].orb,
                              cam=s["cfg_j"].camera, **s["statics"])
    to = TES.track_frame_full(*map(_t, s["inputs"]), params=s["cfg_t"].orb,
                              cam=s["cfg_t"].camera, **s["statics"])
    jo = jax.tree.map(np.asarray, jo)
    hj, ht = jo.hdr, to.hdr.numpy()
    counts_j, counts_t = hj[24:28], ht[24:28]
    assert counts_j[3] > 100  # the frame tracked
    np.testing.assert_allclose(counts_t, counts_j, rtol=0.01, atol=1)
    np.testing.assert_allclose(to.T_out.numpy(), jo.T_out, atol=1e-4)
    np.testing.assert_allclose(ht[:24], hj[:24], atol=1e-4)

    imat_j, imat_t = jo.imat, to.imat.numpy()
    np.testing.assert_array_equal(imat_t[:, [0, 4]], imat_j[:, [0, 4]])  # octave, valid
    # a BRIEF sample whose rotated offset sits at .5 px may round the other
    # way after an angle differing in the last bits: whole rows must agree
    # on >= 99%
    same_desc = np.all(to.desc.numpy() == jo.desc.view(np.int32), axis=1)
    assert same_desc.mean() >= 0.99
    rows_differ = np.any(imat_t[:, 1:4] != imat_j[:, 1:4], axis=1)
    assert rows_differ.mean() <= 0.01, rows_differ.sum()
    frus_differ = to.in_frustum.numpy() != jo.in_frustum
    assert frus_differ.mean() <= 0.01
    kp_differ = to.kp_pt.numpy() != jo.kp_pt
    assert kp_differ.mean() <= 0.01
    # xy0, ur, ur0, depth, angle and FAST response (up to ~3000): f32
    np.testing.assert_allclose(to.fmat.numpy()[:, 4:], jo.fmat[:, 4:], rtol=1e-5,
                               atol=1e-3)
    same_rows = ~rows_differ
    np.testing.assert_allclose(to.fmat.numpy()[same_rows, :4], jo.fmat[same_rows, :4],
                               atol=1e-3)
    # patches are rounded u8: a value at .5 may round either way
    assert np.abs(to.patch.numpy().astype(int) - jo.patch.astype(int)).max() <= 1


def test_tracking_step(setup):
    s = setup
    mp, lp = s["mp"], s["lp"]
    octs = np.zeros(mp.pt_xyz.shape[0], np.int32)
    kf0 = s["jt"].map.kf_pt[0]
    octs[kf0[kf0 >= 0]] = mp.kf_octave[0][kf0 >= 0]
    T = np.asarray(s["last"].pose)
    args = (s["frames"][1][0], T, mp.pt_xyz[lp], mp.pt_desc[lp], octs[lp],
            mp.pt_valid[lp], s["jt"].sf, s["jt"].sigma2)
    cam = s["cfg_j"].camera
    consts = dict(height=H, width=W, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                  bf=cam.bf)
    Tj, nj, _ = JES.tracking_step(*map(jnp.asarray, args), params=s["cfg_j"].orb,
                                  **consts)
    Tt, nt, _ = TES.tracking_step(*map(_t, args), params=s["cfg_t"].orb, **consts)
    assert int(nj) > 50
    assert abs(int(nt) - int(nj)) <= max(1, int(0.01 * int(nj)))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)


def test_rgbd_depth(setup):
    s = setup
    cam_j, cam_t = s["cfg_j"].camera, s["cfg_t"].camera
    d16, factor = j_depth_wire(s["frames"][1][1], 1.0)
    t16, tfactor = t_depth_wire(s["frames"][1][1], 1.0)
    np.testing.assert_array_equal(d16, t16)
    assert factor == tfactor
    dm = d16.astype(np.float32) * np.float32(factor)
    xy = s["last"].xy_raw
    dj, urj = JES._rgbd_depth(jnp.asarray(dm), jnp.asarray(xy), jnp.asarray(xy[:, 0]),
                              cam_j, H, W)
    dt, urt = TES._rgbd_depth(_t(dm), _t(xy), _t(xy[:, 0]), cam_t, H, W)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(urt.numpy(), np.asarray(urj), rtol=1e-6, atol=1e-4)
    assert (dt.numpy() > 0).sum() > 100


def test_predict_pose():
    """U Vt is unique even where U and V are not: compare the result."""
    from orbslam2_tpu.geometry import se3 as JSE3
    rng = np.random.default_rng(0)
    for _ in range(5):
        Tl = np.asarray(JSE3.se3_exp(jnp.asarray(rng.normal(0, 0.3, 6), jnp.float32)))
        Tp = np.asarray(JSE3.se3_exp(jnp.asarray(rng.normal(0, 0.3, 6), jnp.float32)))
        Tl = Tl.copy()
        Tl[:, :3] *= 1.001  # a slightly scaled rotation, as f32 chains leave it
        j = np.asarray(JES._predict_pose(jnp.asarray(Tl), jnp.asarray(Tp)))
        t = TES._predict_pose(_t(Tl), _t(Tp)).numpy()
        np.testing.assert_allclose(t, j, atol=1e-5)
