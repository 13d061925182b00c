"""The rest of io/synth.py in the port against the JAX package's, on the
CPU: the scene of textured squares (make_scene, render, make_sequence), the
zig-zag sweep, and the two-ring world (make_corridor_rings,
waypoint_trajectory, rings_trajectory). All are numpy copies, so every
array is held equal to the bit, at a small size."""
import numpy as np
import pytest

from orbslam2_tpu.io import synth as jsynth
from orbslam2_tpu_torch.io import synth as tsynth


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_make_scene_and_render():
    kw = dict(seed=4, n_pts=60, width=96, height=72, fx=80.0, fy=80.0)
    js, ts = jsynth.make_scene(**kw), tsynth.make_scene(**kw)
    for f in ("pts", "subtex", "size_world", "K"):
        _same(getattr(js, f), getattr(ts, f))
    assert (js.width, js.height) == (ts.width, ts.height)
    _same(js.intensity, ts.intensity)
    for T in jsynth.orbit_trajectory(3):
        for noise in (0.0, 1.5):
            _same(jsynth.render(js, T, noise=noise, seed=7),
                  tsynth.render(ts, T, noise=noise, seed=7))


def test_make_sequence():
    kw = dict(seed=2, n_pts=40, width=64, height=48, fx=60.0, fy=60.0)
    (js, jp, jf), (ts, tp, tf) = (jsynth.make_sequence(4, **kw),
                                  tsynth.make_sequence(4, **kw))
    _same(jp, tp)
    _same(js.pts, ts.pts)
    assert len(jf) == len(tf) == 4
    for a, b in zip(jf, tf):
        _same(a, b)


@pytest.mark.parametrize("kw", [dict(), dict(one_way=False),
                                dict(one_way=False, amplitude=0.3, step=0.1),
                                dict(step=0.12)])
def test_sweep_trajectory(kw):
    _same(jsynth.sweep_trajectory(50, **kw), tsynth.sweep_trajectory(50, **kw))


def test_two_ring_world():
    kw = dict(seed=1, width=48, height=36, fx=36.0, fy=36.0)
    js, ts = jsynth.make_corridor_rings(**kw), tsynth.make_corridor_rings(**kw)
    assert len(js.planes) == len(ts.planes)
    for pj, pt in zip(js.planes, ts.planes):
        for a, b in zip(pj[:5], pt[:5]):
            _same(np.asarray(a), np.asarray(b))
        assert pj[5:] == pt[5:]
    gj, gt = jsynth.rings_trajectory(120), tsynth.rings_trajectory(120)
    _same(gj, gt)
    for T in gj[::40]:
        _same(jsynth.render_room(js, T, seed=3), tsynth.render_room(ts, T, seed=3))
        _same(jsynth.depth_room(js, T), tsynth.depth_room(ts, T))


def test_waypoint_trajectory():
    wp = [[0, 0, 0], [2, 0, 0], [2, 0, 0], [2, 0, 3], [-1, 0.2, 3]]
    for kw in (dict(), dict(smooth=11, y_wobble=0.0)):
        _same(jsynth.waypoint_trajectory(wp, 90, **kw),
              tsynth.waypoint_trajectory(wp, 90, **kw))


def test_room_renders_equal_jax_in_any_order_of_poses():
    """The port keeps each thread's last ray cast (an image and its depth
    map of one pose cast the rays once): renders and depth maps of poses
    taken in any order, repeated, and of a second scene between them, equal
    the JAX package's, which casts every time."""
    kw = dict(seed=3, width=64, height=48, fx=48.0, fy=48.0)
    js, ts = jsynth.make_corridor(**kw), tsynth.make_corridor(**kw)
    ts2 = tsynth.make_corridor(**dict(kw, seed=5))
    js2 = jsynth.make_corridor(**dict(kw, seed=5))
    gt = jsynth.corridor_trajectory(24, radius=8.0)
    for i in (0, 0, 7, 3, 7):
        _same(jsynth.depth_room(js, gt[i]), tsynth.depth_room(ts, gt[i]))
        _same(jsynth.depth_room(js2, gt[i]), tsynth.depth_room(ts2, gt[i]))
        _same(jsynth.render_room(js, gt[i], seed=i), tsynth.render_room(ts, gt[i], seed=i))
        _same(jsynth.depth_room(js, gt[i]), tsynth.depth_room(ts, gt[i]))
        # the same pose in another dtype casts anew, to the same result
        _same(jsynth.depth_room(js, gt[i]), tsynth.depth_room(ts, gt[i].astype(np.float64)))
