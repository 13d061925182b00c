"""Shared driver of the whole-slice parity tests (test_torch_slice*.py): the
same rendered RGB-D room sequence through the JAX package's tracker
(Tracker(cfg, MapState, None, relocalizer=None), mapper off) and through the
port's System on the CPU with its mapper off in the same way; and the JAX
tracker's sweep map that the mapping tests start from.

Size: 320x240 with the focal length and baseline scaled from the bench's
640x480 (fx = 250, bf = 125: the same 0.5 m baseline and 12.5 m close-depth
threshold), 500 features over 8 levels. At this size the JAX tracker tracks
every frame of both sequences used here.
"""
import functools
import time

import numpy as np
import torch

from orbslam2_tpu import config as JC
from orbslam2_tpu.map.mapstate import MapState as JMap
from orbslam2_tpu.ops.features import padded_capacity
from orbslam2_tpu.tracking import Tracker as JTracker
from orbslam2_tpu_torch import config as TC
from orbslam2_tpu_torch.io import synth
from orbslam2_tpu_torch.system import System
from orbslam2_tpu_torch.utils.evaluation import ate_rmse, camera_centers

W, H, NF = 320, 240, 500

# Under pytest-xdist every worker imports every test module at collection,
# so this caps torch's CPU threads for all port tests of the run. The
# default (one OpenMP thread per core, in each of the workers) oversubscribes
# the cores: the slice files then took over 300 s each instead of about 30.
torch.set_num_threads(2)


def configs():
    f = 500.0 * W / 640
    cam = dict(fx=f, fy=f, cx=W / 2, cy=H / 2, width=W, height=H, bf=250.0 * W / 640)
    kw = dict(th_depth=25.0, local_points_cap=2048, max_points=8192, max_keyframes=64)
    cfg_j = JC.with_camera(JC.SlamConfig(sensor=JC.Sensor.RGBD,
                                         orb=JC.OrbParams(n_features=NF), **kw), **cam)
    cfg_t = TC.with_camera(TC.SlamConfig(sensor=TC.Sensor.RGBD,
                                         orb=TC.OrbParams(n_features=NF), **kw), **cam)
    return cfg_j, cfg_t


def render(gt):
    f = 500.0 * W / 640
    scene = synth.make_room(seed=0, width=W, height=H, fx=f, fy=f)
    return [(np.clip(synth.render_room(scene, gt[i], seed=i), 0, 255).astype(np.uint8),
             synth.depth_room(scene, gt[i])) for i in range(len(gt))]


def _result(tracked, tracker, gt, seconds):
    ts, est = tracker.trajectory()
    fids = np.round(np.asarray(ts) * 30).astype(int)
    ate = ate_rmse(camera_centers(est), camera_centers(gt[fids]), with_scale=False)
    return dict(tracked=tracked, ate=ate, poses=est, kfs=tracker.map.n_keyframes,
                points=tracker.map.n_points, seconds=seconds, tracker=tracker)


def run_both(gt):
    """Track the sequence with both packages; returns (jax, port) results."""
    cfg_j, cfg_t = configs()
    frames = render(gt)

    t0 = time.perf_counter()
    jt = JTracker(cfg_j, JMap(cfg_j, padded_capacity(NF)), None, relocalizer=None)
    tracked = sum(jt.process_image(img, i / 30.0, depth_map=d) is not None
                  for i, (img, d) in enumerate(frames))
    jres = _result(tracked, jt, gt, time.perf_counter() - t0)

    t0 = time.perf_counter()
    slam = System(cfg_t, device="cpu")
    slam.tracker.local_mapper = None  # mapper off, as the JAX tracker above
    tracked = slam.run_sequence(
        ((i / 30.0, {"image": img, "depth": d}) for i, (img, d) in enumerate(frames)),
        pipelined=False)
    tres = _result(tracked, slam.tracker, gt, time.perf_counter() - t0)
    tres["system"] = slam
    return jres, tres


@functools.lru_cache(maxsize=1)
def jax_sweep_map():
    """The JAX tracker's map (mapper off) after the 30-frame 0.15 m sweep:
    7 keyframes of depth-spawned points, the input of the mapping tests."""
    cfg_j, _ = configs()
    frames = render(synth.sweep_trajectory(30, step=0.15))
    jt = JTracker(cfg_j, JMap(cfg_j, padded_capacity(NF)), None, relocalizer=None)
    for i, (img, d) in enumerate(frames):
        assert jt.process_image(img, i / 30.0, depth_map=d) is not None
    return jt.map
