"""The port's background, abortable global BA (global_ba.GlobalBA) on the
CPU: the three fast cases of tests/test_global_ba.py on the port (a
keyframe and a point created mid-solve are corrected through the spanning
tree; a second launch aborts the first; an abort discards the result), and
the applied result against the JAX package's on the same map.

Tolerance of the applied result: ba_solve's parity tolerance
(tests/test_torch_ba.py): rotations 1e-4, translations and points 1e-4
absolute plus 1e-4 relative.
"""
import threading
import time

import numpy as np
import pytest

from orbslam2_tpu.config import SlamConfig as JConfig, Sensor as JSensor
from orbslam2_tpu.global_ba import GlobalBA as JGlobalBA
from orbslam2_tpu_torch.config import SlamConfig, Sensor
from orbslam2_tpu_torch.global_ba import GlobalBA
from orbslam2_tpu_torch.interop import map_from_numpy

from test_global_ba import _build_map, _pose_err


@pytest.fixture
def cfgs():
    kw = dict(max_keyframes=32, max_points=1024)
    return (JConfig(sensor=JSensor.MONOCULAR, **kw),
            SlamConfig(sensor=Sensor.MONOCULAR, **kw))


def port_map(jmp, cfg):
    """The port's copy of a JAX MapState."""
    arrays = {k: getattr(jmp, k) for k in jmp._ARRAY_FIELDS}
    arrays.update(next_kf_id=jmp.next_kf_id, next_pt_id=jmp.next_pt_id)
    return map_from_numpy(arrays, cfg)


def build(cfgs, **kw):
    jmp, poses_gt, pts_gt, pt_ids = _build_map(cfgs[0], **kw)
    return jmp, port_map(jmp, cfgs[1]), poses_gt, pts_gt, pt_ids


class TestGlobalBA:
    def test_background_solve_corrects_late_keyframe(self, cfgs):
        _, mp, poses_gt, _, _ = build(cfgs)
        err_before = _pose_err(mp, poses_gt, range(1, 8))
        gba = GlobalBA(cfgs[1], mp, device="cpu")
        mid, release = threading.Event(), threading.Event()

        def hook(chunk):
            if chunk == 0:
                mid.set()
                release.wait(timeout=60)

        gba.chunk_hook = hook
        gba.launch(fixed_kf=0)
        assert mid.wait(timeout=120), "solver never reached chunk 0"
        assert gba.running
        # tracking continues: a keyframe and a point created mid-solve,
        # offset from keyframe 7 by a known relative pose
        T_rel = np.hstack([np.eye(3), [[0.15], [0.0], [0.0]]]).astype(np.float32)
        T7 = mp.kf_pose[7]
        T_new = np.hstack([T_rel[:, :3] @ T7[:, :3],
                           (T_rel[:, :3] @ T7[:, 3] + T_rel[:, 3])[:, None]])
        n = mp.n_feat
        k_late = mp.add_keyframe(
            T_new.astype(np.float32), 8.0, 8, np.zeros((n, 2), np.float32),
            np.zeros(n, np.int32), np.zeros(n, np.float32),
            np.zeros((n, 8), np.int32), np.zeros(n, bool), np.full(n, -1, np.int32))
        mp.kf_parent[k_late] = 7
        p_late = mp.add_points(np.array([[0.0, 0.0, 7.0]], np.float32),
                               np.zeros((1, 8), np.int32), ref_kf=7,
                               first_kf=k_late)[0]
        Xc_before = mp.kf_pose[7][:, :3] @ mp.pt_xyz[p_late] + mp.kf_pose[7][:, 3]
        assert not gba.poll()  # nothing to apply yet
        release.set()
        assert gba.wait_and_apply(timeout=300)
        assert not gba.running
        err_after = _pose_err(mp, poses_gt, range(1, 8))
        assert err_after < 0.5 * err_before, (err_before, err_after)
        T7n = mp.kf_pose[7]
        T_exp = np.hstack([T_rel[:, :3] @ T7n[:, :3],
                           (T_rel[:, :3] @ T7n[:, 3] + T_rel[:, 3])[:, None]])
        np.testing.assert_allclose(mp.kf_pose[k_late], T_exp, atol=1e-4)
        Xc_after = T7n[:, :3] @ mp.pt_xyz[p_late] + T7n[:, 3]
        np.testing.assert_allclose(Xc_after, Xc_before, atol=1e-4)
        assert len(gba.chunk_ms) == 5 and len(gba.solve_ms) == 1

    def test_second_launch_aborts_first(self, cfgs):
        _, mp, _, _, _ = build(cfgs)
        gba = GlobalBA(cfgs[1], mp, device="cpu")
        started, block = threading.Event(), threading.Event()

        def hook(chunk):
            started.set()
            block.wait(timeout=60)

        gba.chunk_hook = hook
        gba.launch(fixed_kf=0)
        assert started.wait(timeout=120)
        t = threading.Thread(target=lambda: (time.sleep(0.2), block.set()))
        t.start()
        gba.chunk_hook = None
        gba.launch(fixed_kf=0)
        t.join(timeout=60)
        assert not t.is_alive()
        assert gba.n_aborted == 1
        assert gba.full_ba_idx == 2
        assert gba.wait_and_apply(timeout=300)
        assert gba.n_applied == 1

    def test_abort_discards_result(self, cfgs):
        _, mp, _, _, _ = build(cfgs)
        pose_copy = mp.kf_pose.copy()
        gba = GlobalBA(cfgs[1], mp, device="cpu")
        gba.chunk_hook = lambda chunk: gba.request_abort()
        gba.launch(fixed_kf=0)
        gba.abort_and_join()
        assert not gba.poll()
        assert gba.n_aborted == 1
        np.testing.assert_array_equal(mp.kf_pose, pose_copy)


def test_applied_result_matches_jax(cfgs):
    """One synchronous launch on the same map in both packages: the applied
    poses and points agree within ba_solve's tolerance, and both move the
    keyframes toward the ground truth."""
    jmp, mp, poses_gt, _, _ = build(cfgs, seed=1)
    before = _pose_err(mp, poses_gt, range(1, 8))
    jg, tg = JGlobalBA(cfgs[0], jmp), GlobalBA(cfgs[1], mp, device="cpu")
    for g in (jg, tg):
        g.launch(fixed_kf=0, background=False)
        assert g.poll() and g.n_applied == 1
    np.testing.assert_allclose(mp.kf_pose[..., :3], jmp.kf_pose[..., :3], atol=1e-4)
    np.testing.assert_allclose(mp.kf_pose[..., 3], jmp.kf_pose[..., 3],
                               rtol=1e-4, atol=1e-4)
    live = np.flatnonzero(jmp.pt_valid)
    np.testing.assert_array_equal(np.flatnonzero(mp.pt_valid), live)
    np.testing.assert_allclose(mp.pt_xyz[live], jmp.pt_xyz[live], rtol=1e-4, atol=1e-4)
    assert _pose_err(mp, poses_gt, range(1, 8)) < 0.5 * before
