"""Shared driver of the whole-slice parity tests (test_torch_slice*.py): the
same rendered RGB-D room sequence through the JAX package's tracker
(Tracker(cfg, MapState, None, relocalizer=None), mapper off) and through the
port's System on the CPU with its mapper off in the same way; the JAX
tracker's sweep map that the mapping tests start from; for the stereo and
monocular slices, both packages' whole Systems on a rendered sequence of
that sensor (`run_systems`); and the cut RGB-D lap of the corridor circuit
that the loop-closing tests share (`LOOP_CUT`, `render_corridor`).

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


def configs(sensor: str = "RGBD"):
    """(JAX config, port config) of one sensor ("RGBD", "STEREO" or
    "MONOCULAR") at the test size, as bench.py sets them at full size:
    ThDepth 25 and the 0.5 m baseline with depth, ThDepth 35 and no
    baseline for monocular."""
    f = 500.0 * W / 640
    cam = dict(fx=f, fy=f, cx=W / 2, cy=H / 2, width=W, height=H)
    if sensor != "MONOCULAR":
        cam["bf"] = 250.0 * W / 640
    kw = dict(th_depth=35.0 if sensor == "MONOCULAR" else 25.0,
              local_points_cap=2048, max_points=8192, max_keyframes=64)
    cfg_j = JC.with_camera(JC.SlamConfig(sensor=JC.Sensor[sensor],
                                         orb=JC.OrbParams(n_features=NF), **kw), **cam)
    cfg_t = TC.with_camera(TC.SlamConfig(sensor=TC.Sensor[sensor],
                                         orb=TC.OrbParams(n_features=NF), **kw), **cam)
    return cfg_j, cfg_t


def render_sequence(gt, sensor: str):
    """The sequence items of one sensor, as bench.py renders them: the right
    image from the pose shifted by the baseline along the camera's x axis,
    with seed 10000 + i."""
    f = 500.0 * W / 640
    scene = synth.make_room(seed=0, width=W, height=H, fx=f, fy=f)
    baseline = 250.0 / 500.0

    def u8(T, seed):
        return np.clip(synth.render_room(scene, T, seed=seed), 0, 255).astype(np.uint8)

    items = []
    for i in range(len(gt)):
        data = {"image": u8(gt[i], i)}
        if sensor == "RGBD":
            data["depth"] = synth.depth_room(scene, gt[i])
        elif sensor == "STEREO":
            T_r = gt[i].copy()
            T_r[:, 3] = T_r[:, 3] - np.array([baseline, 0, 0], np.float32)
            data["right"] = u8(T_r, 10_000 + i)
        items.append((i / 30.0, data))
    return items


def run_systems(gt, sensor: str, with_scale: bool, pipelined: bool = True):
    """The sequence through the JAX package's System (mapper inline, the
    default vocabulary, keyframe database, relocalizer, loop closer and
    global BA on) and through the port's System on the CPU, which builds the
    same pieces by default. Returns (jax, port) results with the ATE
    (Sim(3)-aligned when with_scale) and the index of the first OK frame."""
    from orbslam2_tpu.system import System as JSystem
    cfg_j, cfg_t = configs(sensor)
    items = render_sequence(gt, sensor)

    def result(slam, tracked, seconds):
        ts, est = slam.tracker.trajectory()
        fids = np.round(np.asarray(ts) * 30).astype(int)
        ate = ate_rmse(camera_centers(est), camera_centers(gt[fids]),
                       with_scale=with_scale)
        states = [r.state for r in slam.metrics.records]
        first_ok = states.index("OK") if "OK" in states else len(states)
        return dict(tracked=tracked, ate=ate, kfs=slam.map.n_keyframes,
                    points=slam.map.n_points, seconds=seconds, first_ok=first_ok,
                    states=states, system=slam)

    t0 = time.perf_counter()
    js = JSystem(cfg_j)
    jres = result(js, js.run_sequence(iter(items), pipelined=pipelined),
                  time.perf_counter() - t0)
    t0 = time.perf_counter()
    ts = System(cfg_t, device="cpu")
    tres = result(ts, ts.run_sequence(iter(items), pipelined=pipelined),
                  time.perf_counter() - t0)
    return jres, tres


# the cut lap of the corridor circuit at the test size: (frames, lap radius,
# outer and inner half-widths of the corridor, image noise). The full-size
# lap is 240 frames of radius 8 in make_corridor's default 10 m / 5 m
# circuit (tests/test_loop_closure_e2e.py); this one is the shortest found
# on which both packages close a loop at 320x240 with the mapper inline.
LOOP_CUT = (80, 4.0, 5.5, 2.5, 2.5)


@functools.lru_cache(maxsize=1)
def render_corridor(n_frames: int, radius: float, outer: float, inner: float,
                    noise: float):
    """(ground truth [F,3,4], RGB-D items) of a lap of the corridor circuit
    (synth.make_corridor, seed 3) at the test size, rendered with `noise`
    and seed i."""
    f = 500.0 * W / 640
    scene = synth.make_corridor(seed=3, width=W, height=H, fx=f, fy=f,
                                outer=outer, inner=inner)
    gt = synth.corridor_trajectory(n_frames, radius=radius)
    items = [(i / 30.0, {"image": np.clip(synth.render_room(scene, gt[i], noise=noise,
                                                            seed=i), 0, 255).astype(np.uint8),
                         "depth": synth.depth_room(scene, gt[i])})
             for i in range(n_frames)]
    return gt, items


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
    # mapper and relocalizer off, as the JAX tracker above
    slam.tracker.local_mapper = slam.tracker.relocalizer = None
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
