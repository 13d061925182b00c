"""The port's viewer (orbslam2_tpu_torch/viz/) against the JAX package's.

- Scene parity: JAX's System maps the 30-frame 0.15 m RGB-D sweep of the
  320x240 room; its render_map_topdown and render_frame_overlay run with
  matplotlib's Axes.scatter, plot, annotate, set_title, set_xlim and
  set_ylim recording their arguments, and the port's scene functions, on the
  same map carried into the port (interop.map_from_numpy), the same
  trajectory and the same frame, give the same arrays: points and keypoints
  exactly, keyframe centres, arrow tips and trajectory within 1e-6, the
  covisibility segments as a set, the follow mode's limits within 1e-6.
- The raster: a world point lands on the pixel its transform computes; the
  PNG writer's files decode to the same pixels through io/png.read_png and
  cv2.imread.
- The live viewer through System(cfg, device="cpu", use_viewer=True): the
  assertions of tests/test_live_viewer.py (routes, toggles, the deferred
  reset, shutdown), on the RGB-D sweep.
- run_dataset and run_synth accept --viewer; the package renders with
  matplotlib unimportable.
"""
import dataclasses
import io
import json
import subprocess
import sys
import time
import urllib.error
import urllib.request

import cv2
import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")
from matplotlib.axes import Axes  # noqa: E402

import torch_slice_common as C  # noqa: E402
from orbslam2_tpu.system import System as JSystem  # noqa: E402
from orbslam2_tpu.viz import map_render as JR  # noqa: E402
from orbslam2_tpu_torch import interop  # noqa: E402
from orbslam2_tpu_torch.frontend.frame import Frame as TFrame  # noqa: E402
from orbslam2_tpu_torch.io import synth  # noqa: E402
from orbslam2_tpu_torch.io.png import read_png, write_png  # noqa: E402
from orbslam2_tpu_torch.system import System  # noqa: E402
from orbslam2_tpu_torch.viz import map_render as TR  # noqa: E402
from orbslam2_tpu_torch.viz.raster import Canvas, View  # noqa: E402

SWEEP = (30, 0.15)  # frames, step (m): 3 keyframes with covisibility edges
TOL = 1e-6


@pytest.fixture(scope="module")
def sweep():
    """The rendered sweep frames and the JAX System that mapped them."""
    cfg_j, _ = C.configs()
    frames = C.render(synth.sweep_trajectory(SWEEP[0], step=SWEEP[1]))
    js = JSystem(cfg_j)
    for i, (img, d) in enumerate(frames):
        js.track_rgbd(img, d, i / 30.0)
    js.shutdown()
    assert js.map.n_keyframes >= 3
    return frames, js


def _port_map(jmap):
    _, cfg_t = C.configs()
    arrays = {k: getattr(jmap, k) for k in jmap._ARRAY_FIELDS}
    arrays.update(n_feat=jmap.n_feat, next_kf_id=jmap.next_kf_id, next_pt_id=jmap.next_pt_id)
    return interop.map_from_numpy(arrays, cfg_t)


@pytest.fixture
def recorded(monkeypatch):
    """Every call of the recorded Axes methods, as (name, args, kwargs),
    each passed on to matplotlib."""
    calls = []
    for name in ("scatter", "plot", "annotate", "set_title", "set_xlim", "set_ylim"):
        orig = getattr(Axes, name)

        def rec(self, *args, _name=name, _orig=orig, **kw):
            calls.append((_name, args, kw))
            return _orig(self, *args, **kw)

        monkeypatch.setattr(Axes, name, rec)
    return calls


def _xy(args):
    return np.stack([np.asarray(args[0], np.float64), np.asarray(args[1], np.float64)], -1)


def test_map_scene_matches_jax(sweep, recorded):
    _, js = sweep
    _, est = js.tracker.trajectory()
    JR.render_map_topdown(js.map, trajectory=est, path=io.BytesIO())
    scatters = [c for c in recorded if c[0] == "scatter"]
    plots = [c for c in recorded if c[0] == "plot"]
    arrows = [c for c in recorded if c[0] == "annotate"]
    scene = TR.map_scene(_port_map(js.map), trajectory=est)

    assert np.array_equal(_xy(scatters[0][1]), scene["points"])
    assert scatters[0][2]["label"] == f"{scene['n_points']} points"
    assert np.abs(_xy(scatters[1][1]) - scene["kf_centers"]).max() <= TOL
    assert scatters[1][2]["label"] == f"{len(scene['kf_centers'])} keyframes"
    tips = np.array([c[2]["xy"] for c in arrows])
    tails = np.array([c[2]["xytext"] for c in arrows])
    assert np.abs(tips - scene["kf_tips"]).max() <= TOL
    assert np.abs(tails - scene["kf_centers"]).max() <= TOL

    def seg_set(segs):
        return {tuple(np.round(np.asarray(s, np.float64).ravel(), 5)) for s in segs}

    jax_covis = [np.array(c[1]).T for c in plots if c[2].get("c") == "tab:green"]
    assert len(jax_covis) >= 1 and seg_set(jax_covis) == seg_set(scene["covis"])
    (traj,) = [c for c in plots if c[2].get("label") == "trajectory"]
    assert np.abs(_xy(traj[1]) - scene["trajectory"]).max() <= TOL
    assert TR.draw_map(scene, TR.map_view(scene)).shape == (TR.MAP_PX, TR.MAP_PX, 3)


def test_map_scene_toggles_match_jax(sweep, recorded):
    """Points and covisibility off: JAX draws neither, the port's scene has
    neither."""
    _, js = sweep
    JR.render_map_topdown(js.map, path=io.BytesIO(), show_covisibility=False,
                          show_points=False)
    scene = TR.map_scene(_port_map(js.map), show_covisibility=False, show_points=False)
    assert [c[2].get("label") for c in recorded if c[0] == "scatter"] == [
        f"{js.map.n_keyframes} keyframes"]
    assert not [c for c in recorded if c[0] == "plot"]
    assert scene["points"] is None and len(scene["covis"]) == 0
    assert scene["trajectory"] is None


def test_follow_mode_limits(sweep, recorded):
    """center +- span on both axes, as JAX sets them; without a centre the
    view holds every drawn element."""
    _, js = sweep
    center = np.array([0.3, -0.2, 1.7], np.float32)
    JR.render_map_topdown(js.map, path=io.BytesIO(), center=center, span=2.5)
    # the render's own calls pass (lo, hi); matplotlib's autoscale passes one tuple
    (xlim,) = [c[1] for c in recorded if c[0] == "set_xlim" and len(c[1]) == 2]
    (ylim,) = [c[1] for c in recorded if c[0] == "set_ylim" and len(c[1]) == 2]
    scene = TR.map_scene(_port_map(js.map))
    (a_lo, a_hi), (b_lo, b_hi) = TR.map_view(scene, center, 2.5).limits()
    assert np.abs(np.array([a_lo, a_hi, b_lo, b_hi]) - np.array([*xlim, *ylim])).max() <= TOL
    view = TR.map_view(scene)
    (a_lo, a_hi), (b_lo, b_hi) = view.limits()
    for key in ("points", "kf_centers", "kf_tips"):
        xy = scene[key]
        assert (xy[:, 0] > a_lo).all() and (xy[:, 0] < a_hi).all()
        assert (xy[:, 1] > b_lo).all() and (xy[:, 1] < b_hi).all()


def _port_frame(jf):
    names = {f.name for f in dataclasses.fields(TFrame)}
    return TFrame(**{k: v for k, v in vars(jf).items() if k in names})


def test_frame_scene_matches_jax(sweep, recorded):
    frames, js = sweep
    jf = js.tracker.last_frame
    img = frames[-1][0]
    JR.render_frame_overlay(img, jf, io.BytesIO())
    (det, trk) = [c[1] for c in recorded if c[0] == "scatter"]
    (title,) = [c[1][0] for c in recorded if c[0] == "set_title"]
    scene = TR.frame_scene(_port_frame(jf))
    assert np.array_equal(_xy(det), scene["detected"])
    assert np.array_equal(_xy(trk), scene["tracked"])
    assert len(scene["tracked"]) > 50 and title == scene["title"]
    assert TR.draw_frame(img, scene).shape == (img.shape[0] + TR.TITLE_PX, img.shape[1], 3)

    # a lazy block-driver frame: the image and the title alone
    recorded.clear()
    lazy = dataclasses.replace(jf, xy_raw=None)
    JR.render_frame_overlay(img, lazy, io.BytesIO())
    assert not [c for c in recorded if c[0] == "scatter"]
    (title,) = [c[1][0] for c in recorded if c[0] == "set_title"]
    scene = TR.frame_scene(dataclasses.replace(_port_frame(jf), xy_raw=None))
    assert scene["detected"] is None and title == scene["title"]


def test_raster_geometry():
    """A world point lands on the pixel View.to_px computes, in a fitted and
    in a centred view, and in draw_map's plot area."""
    view = View.fit(np.array([-2.0, 3.0]), np.array([1.0, 2.0]), left=10, top=20, size=200)
    assert view.scale == pytest.approx(200 / (5.0 * 1.1))
    for v, inside in ((view, ((0.25, 1.5), (-1.1, 1.9), (3.0, 1.0))),
                      (View.centered(1.0, -1.0, 2.0, 5, 7, 101),
                       ((1.0, -1.0), (-0.9, 0.9), (2.5, -2.75)))):
        for a, b in inside:
            x, y = v.to_px(a, b)
            cv = Canvas(300, 300, background="#000000")
            cv.dots([x], [y], radius=0.0, color="#ffffff")
            lit = np.argwhere(cv.pixels()[..., 0] == 255)
            assert lit.tolist() == [[int(np.floor(y)), int(np.floor(x))]]
    # b grows upward, a to the right
    x0, y0 = view.to_px(0.0, 0.0)
    x1, y1 = view.to_px(1.0, 1.0)
    assert x1 > x0 and y1 < y0
    # a keyframe square of draw_map on its computed pixel
    scene = {"axes": (0, 2), "points": None, "n_points": 0, "covis": np.zeros((0, 2, 2)),
             "kf_centers": np.array([[1.0, 2.0], [-3.0, -1.0]]),
             "kf_tips": np.array([[1.0, 2.12], [-3.0, -0.88]]), "trajectory": None}
    view = TR.map_view(scene)
    img = TR.draw_map(scene, view)
    for a, b in scene["kf_centers"]:
        x, y = view.to_px(a, b)
        assert img[int(np.floor(y)), int(np.floor(x))].tolist() == [0x1f, 0x77, 0xb4]


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
def test_png_round_trip(tmp_path, kind):
    rng = np.random.default_rng(3)
    img = {"gray8": lambda: rng.integers(0, 256, (37, 53), dtype=np.uint8),
           "rgb8": lambda: rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
           "gray16": lambda: rng.integers(0, 65536, (37, 53), dtype=np.uint16)}[kind]()
    path = tmp_path / "x.png"
    write_png(path, img)
    buf = io.BytesIO()
    write_png(buf, img)
    assert buf.getvalue() == path.read_bytes()
    want = img[..., ::-1] if img.ndim == 3 else img  # both readers return BGR
    got = read_png(path, unchanged=True)
    assert got.dtype == img.dtype and np.array_equal(got, want)
    assert np.array_equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED), want)
    with pytest.raises(ValueError):
        write_png(tmp_path / "bad.png", img.astype(np.float32))


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.read()


def test_viewer_serves_and_toggles(sweep):
    """tests/test_live_viewer.py's assertions through the port's System on
    the RGB-D sweep."""
    frames, _ = sweep
    _, cfg_t = C.configs()
    slam = System(cfg_t, device="cpu", use_viewer=True)
    port = slam.viewer.port
    try:
        for i, (img, d) in enumerate(frames):
            slam.track_rgbd(img, d, i / 30.0)
        deadline = time.time() + 30
        while time.time() < deadline:
            if slam.viewer._map_png and slam.viewer._frame_png:
                break
            time.sleep(0.25)

        st, body = _get(port, "/")
        assert st == 200 and b"orbslam2_tpu" in body
        st, body = _get(port, "/map.png")
        assert st == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
        st, body = _get(port, "/frame.png")
        assert st == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
        st, body = _get(port, "/stats.json")
        stats = json.loads(body)
        assert stats["keyframes"] >= 2 and stats["points"] > 50
        assert stats == {**slam.map_stats(), "menu": dict(follow=1, points=1, graph=1,
                                                          localization=0)}
        with pytest.raises(urllib.error.HTTPError, match="404"):
            _get(port, "/nothing")

        # menu toggles (src/Viewer.cpp:73-79): localization mode flips the
        # tracker; reset is deferred to the tracking thread
        _get(port, "/set?localization=1&points=0&graph=0&follow=0")
        assert slam.tracker.localization_only is True
        assert slam.viewer.show_points is False and slam.viewer.follow is False
        _get(port, "/set?localization=0")
        assert slam.tracker.localization_only is False

        _get(port, "/reset")
        assert slam._reset_pending is True
        old = slam.map
        # the next frame applies the reset on the tracking thread; an RGB-D
        # map starts again from that frame
        slam.track_rgbd(*frames[0], len(frames) / 30.0)
        assert slam._reset_pending is False and slam.map is not old
        assert slam.map.n_keyframes == 1
    finally:
        slam.shutdown()
    assert slam.viewer is None  # shutdown stopped the viewer
    assert slam.tracker.localization_only is False


def test_drivers_accept_viewer(tmp_path, monkeypatch, capsys):
    """run_dataset and run_synth take --viewer, start the viewer (it prints
    its address) and stop it at the end."""
    import functools

    from orbslam2_tpu_torch import run_dataset, run_synth
    W, H, f = C.W, C.H, 500.0 * C.W / 640
    scene = synth.make_room(seed=0, width=W, height=H, fx=f, fy=f)
    gt = synth.orbit_trajectory(4)
    seq = tmp_path / "seq"
    (seq / "rgb").mkdir(parents=True)
    (seq / "depth").mkdir()
    lines = []
    for i in range(len(gt)):
        ts = f"{i / 30.0:.6f}"
        write_png(seq / f"rgb/{ts}.png",
                  np.clip(synth.render_room(scene, gt[i], seed=i), 0, 255).astype(np.uint8))
        write_png(seq / f"depth/{ts}.png",
                  (synth.depth_room(scene, gt[i]) * 5000.0).astype(np.uint16))
        lines.append(f"{ts} rgb/{ts}.png {ts} depth/{ts}.png")
    (seq / "associations.txt").write_text("\n".join(lines) + "\n")
    settings = tmp_path / "settings.yaml"
    settings.write_text(
        "%YAML:1.0\n" + "".join(f"Camera.{k}: {v}\n" for k, v in dict(
            fx=f, fy=f, cx=W / 2, cy=H / 2, k1=0.0, k2=0.0, p1=0.0, p2=0.0, width=W,
            height=H, fps=30.0, bf=f * 0.5, RGB=1).items())
        + "ThDepth: 25.0\nDepthMapFactor: 5000.0\nORBextractor.nFeatures: 500\n")
    out = tmp_path / "out"
    rc = run_dataset.main(["rgbd_tum", str(settings), str(seq), str(seq / "associations.txt"),
                           "--out-dir", str(out), "--device", "cpu", "--viewer"])
    assert rc == 0 and "[viewer] http://127.0.0.1:" in capsys.readouterr().out
    assert len(np.loadtxt(out / "CameraTrajectory.txt")) == len(gt)

    monkeypatch.setattr(synth, "make_room", functools.partial(
        synth.make_room, width=W, height=H, fx=f, fy=f))
    rc = run_synth.main(["2", "--device", "cpu", "--viewer"])
    text = capsys.readouterr().out
    assert rc in (0, 1) and "[viewer] http://127.0.0.1:" in text and "frame   1" in text


def test_renders_without_matplotlib(tmp_path):
    """With matplotlib unimportable, the port's viewer modules import and
    render both PNGs."""
    code = f"""
import sys
sys.modules["matplotlib"] = None
import numpy as np
from orbslam2_tpu_torch import SlamConfig
from orbslam2_tpu_torch.frontend.frame import Frame
from orbslam2_tpu_torch.io.png import read_png
from orbslam2_tpu_torch.map.mapstate import MapState
from orbslam2_tpu_torch.viz import live_viewer  # noqa: F401
from orbslam2_tpu_torch.viz.map_render import render_frame_overlay, render_map_topdown
mp = MapState(SlamConfig(max_points=64, max_keyframes=4), 16)
mp.add_points(np.random.default_rng(0).normal(size=(10, 3)).astype(np.float32),
              np.zeros((10, 8), np.int32), ref_kf=0, first_kf=0)
render_map_topdown(mp, trajectory=np.tile(np.eye(3, 4, dtype=np.float32), (3, 1, 1)),
                   path=r"{tmp_path / 'map.png'}")
n = 16
xy = np.random.default_rng(1).uniform(0, 60, (n, 2)).astype(np.float32)
fr = Frame(frame_id=3, timestamp=0.1, xy=xy, xy_raw=xy, octave=np.zeros(n, np.int32),
           angle=np.zeros(n, np.float32), response=np.ones(n, np.float32),
           desc=np.zeros((n, 8), np.int32), valid=np.ones(n, bool),
           depth=np.full(n, -1.0, np.float32), ur=np.full(n, -1.0, np.float32))
fr.pt_idx[:5] = np.arange(5)
render_frame_overlay(np.full((64, 80), 128, np.uint8), fr, r"{tmp_path / 'frame.png'}")
assert "matplotlib" not in [m.split(".")[0] for m, v in sys.modules.items() if v is not None]
print(read_png(r"{tmp_path / 'map.png'}", unchanged=True).shape,
      read_png(r"{tmp_path / 'frame.png'}", unchanged=True).shape)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["(900,", "900,", "3)", "(78,", "80,", "3)"]
