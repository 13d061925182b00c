"""The port's package boundary and host pieces: it imports without JAX, keeps
TF32 off, runs every call an earlier step of the port refused (the live
viewer the last of them), runs what is ported (map files, the three entry
points, each refused on a System of another sensor; an empty sequence; a
tracker with a mapper and with a relocalizer; a mapper with a keyframe
database and with a loop closer; localization mode; the vocabulary
argument),
and its host code (settings, interop, native map ops, the device mirror of
the point table, host-to-device uploads) agrees with the JAX package."""
import dataclasses
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import orbslam2_tpu_torch as P
from orbslam2_tpu import config as JC
from orbslam2_tpu_torch import interop, native
from orbslam2_tpu_torch.map.mapstate import MapState
from orbslam2_tpu_torch.tracking import Tracker

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "orbslam2_tpu_torch"


def test_import_leaves_jax_out():
    modules = sorted("orbslam2_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
                     for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            "import orbslam2_tpu_torch\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'orbslam2_tpu' or m.startswith('orbslam2_tpu.')\n"
            "       or m == 'cv2' or m.startswith('cv2.')]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_full_f32_matmuls():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _rgbd_cfg():
    return P.with_camera(P.SlamConfig(sensor=P.Sensor.RGBD, max_points=256,
                                      max_keyframes=4), bf=250.0)


def _mapper_with(**hooks):
    from orbslam2_tpu_torch.local_mapping import LocalMapper
    cfg = _rgbd_cfg()
    return LocalMapper(cfg, MapState(cfg, 1024), device="cpu", **hooks)


def _localization_mode(s):
    assert not s.localization_mode_active
    s.activate_localization_mode()
    assert s.localization_mode_active and s.tracker.localization_only
    s.deactivate_localization_mode()
    assert not s.localization_mode_active
    assert s.tracking_state.name == "NOT_INITIALIZED"


def _mapper_takes(hook):
    lm = _mapper_with(**{hook: len})
    assert getattr(lm, hook) is len
    lm.register_keyframe(0)  # one hook alone registers nothing
    assert lm.counters["kfs_registered"] == 0


def _tracker_takes_relocalizer(s):
    reloc = object()
    assert Tracker(s.cfg, s.map, None, relocalizer=reloc, device="cpu").relocalizer is reloc
    assert s.tracker.relocalizer is s.relocalizer is not None
    assert s.local_mapper.kf_db is s.kf_db is s.relocalizer.db


def _system_closes_loops(s):
    """The System builds the loop closer and the global BA and hands the
    closer to its mapper; a mapper takes a closer of its own."""
    lc = object()
    assert _mapper_with(loop_closer=lc).loop_closer is lc
    assert s.local_mapper.loop_closer is s.loop_closer
    assert s.loop_closer.global_ba is s.global_ba and not s.global_ba.running
    assert s.loop_closer.device == s.global_ba.device == s.device
    assert s.map_stats()["loops"] == 0 == s.loop_closer.n_loops_closed


def _save_map(s):
    """save_map writes one npz of the map's checkpoint arrays."""
    with tempfile.TemporaryDirectory() as d:
        s.save_map(Path(d) / "map.npz")
        with np.load(Path(d) / "map.npz") as z:
            assert set(MapState._ARRAY_FIELDS) <= set(z.files)
            assert z["kf_desc"].dtype == np.uint32 and int(z["next_kf_id"]) == 0


def _load_map(s):
    """load_map rebuilds the System on the file's map and leaves it LOST."""
    s.map.pt_valid[:3] = True
    s.map.next_pt_id = 3
    with tempfile.TemporaryDirectory() as d:
        s.save_map(Path(d) / "map.npz")
        s.load_map(Path(d) / "map.npz")
    assert s.map.n_points == 3 and s.map.n_keyframes == 0
    assert s.tracking_state.name == "LOST" and s.tracker.map is s.map
    assert s.local_mapper.map is s.relocalizer.map is s.kf_db.map is s.map


def _system_serves_a_viewer(s):
    """System(use_viewer=True) serves its page on viewer_port (0: a free
    one) and shutdown() stops it (tests/test_torch_viz.py drives it)."""
    import urllib.request
    v = P.System(s.cfg, device="cpu", use_viewer=True, viewer_port=0)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{v.viewer.port}/", timeout=30) as r:
            assert r.status == 200 and b"orbslam2_tpu" in r.read()
    finally:
        v.shutdown()
    assert v.viewer is None


# (call, still refused): every call that an earlier step of the port refused.
# Those that are ported since (refused=False) are held to their behaviour
# instead; the test keeps its name so that its cases keep theirs
@pytest.mark.parametrize("call,refused", [
    (_localization_mode, False),
    (_save_map, False),
    (_load_map, False),
    (_system_closes_loops, False),
    (lambda s: _mapper_takes("kf_db"), False),
    (lambda s: _mapper_takes("bow_encode"), False),
    (_tracker_takes_relocalizer, False),
    (_system_serves_a_viewer, False),
], ids=[f"call{i}" for i in range(8)])
def test_not_ported_yet_raises_naming_the_roadmap(call, refused):
    s = P.System(_rgbd_cfg(), device="cpu")
    if not refused:
        call(s)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(s)


def _cfg(sensor):
    cfg = P.SlamConfig(sensor=sensor, max_points=256, max_keyframes=4)
    return cfg if sensor == P.Sensor.MONOCULAR else P.with_camera(cfg, bf=250.0)


_IMG = np.zeros((480, 640), np.uint8)
_ENTRY = {
    P.Sensor.MONOCULAR: lambda s: s.track_monocular(_IMG, 0.0),
    P.Sensor.STEREO: lambda s: s.track_stereo(_IMG, _IMG, 0.0),
    P.Sensor.RGBD: lambda s: s.track_rgbd(_IMG, np.ones((480, 640), np.float32), 0.0),
}


@pytest.mark.parametrize("sensor", list(_ENTRY), ids=lambda s: s.name)
def test_every_entry_point_runs_on_its_own_sensor(sensor):
    """track_monocular and track_stereo no longer raise: a featureless
    frame goes through the extraction (and, for stereo, the matcher) and
    leaves the system uninitialized."""
    s = P.System(_cfg(sensor), device="cpu")
    assert _ENTRY[sensor](s) is None
    assert s.tracker.state.name == "NOT_INITIALIZED"
    assert len(s.metrics.records) == 1


@pytest.mark.parametrize("system,entry", [(a, b) for a in _ENTRY for b in _ENTRY if a != b],
                         ids=lambda s: s.name)
def test_entry_point_of_another_sensor_is_refused(system, entry):
    s = P.System(_cfg(system), device="cpu")
    with pytest.raises(ValueError, match=system.name):
        _ENTRY[entry](s)


@pytest.mark.parametrize("system,item", [
    (P.Sensor.RGBD, {"image": _IMG}),
    (P.Sensor.RGBD, {"image": _IMG, "right": _IMG}),
    (P.Sensor.STEREO, {"image": _IMG}),
    (P.Sensor.STEREO, {"image": _IMG, "depth": np.ones((480, 640), np.float32)}),
], ids=["rgbd-mono-item", "rgbd-stereo-item", "stereo-mono-item", "stereo-rgbd-item"])
@pytest.mark.parametrize("pipelined", [True, False])
def test_run_sequence_refuses_an_item_without_what_the_sensor_needs(system, item, pipelined):
    s = P.System(_cfg(system), device="cpu")
    with pytest.raises(ValueError, match="needs"):
        s.run_sequence(iter([(0.0, item)]), pipelined=pipelined)


@pytest.mark.parametrize("call", [
    lambda s: s.run_sequence(iter([])),
    lambda s: s.run_sequence(iter([]), pipelined=False),
    lambda s: sum(1 for _ in s.tracker.run_blocked(iter([]), s._gray)),
])
def test_empty_sequence_tracks_nothing(call):
    s = P.System(_rgbd_cfg(), device="cpu", async_mapping=True)
    assert call(s) == 0
    s.shutdown()


def test_a_failed_mapping_worker_surfaces_at_shutdown():
    s = P.System(_rgbd_cfg(), device="cpu", async_mapping=True)

    def fail(kf):
        raise ValueError(f"keyframe {kf}")

    s.local_mapper.process = fail
    for kf in range(5):  # more keyframes than the queue holds
        s._proxy.process(kf)
    with pytest.raises(RuntimeError, match="mapping worker") as err:
        s.shutdown()
    assert isinstance(err.value.__cause__, ValueError)


def test_wait_for_mapping_drains_without_stopping_the_worker():
    s = P.System(_rgbd_cfg(), device="cpu", async_mapping=True)
    done = []
    s.local_mapper.process = done.append
    for kf in (1, 2):
        s._proxy.process(kf)
    s.wait_for_mapping()
    assert done == [1, 2] and s._worker.is_alive() and s._proxy.idle()
    s.shutdown()
    assert s._worker is None
    P.System(_rgbd_cfg(), device="cpu").wait_for_mapping()  # inline: nothing to wait for


def test_tracker_takes_a_mapper():
    from orbslam2_tpu_torch.local_mapping import LocalMapper
    cfg = _rgbd_cfg()
    mp = MapState(cfg, 1024)
    lm = LocalMapper(cfg, mp, device="cpu")
    assert Tracker(cfg, mp, lm, device="cpu").local_mapper is lm


def test_relocalizer_is_refused():
    """Named when the tracker refused a relocalizer; now the relocalizer is
    taken, a LOST frame goes to it (and to the reference keyframe without
    one), and it is the relocalizer's refusal of the frame that keeps the
    tracker LOST."""
    from orbslam2_tpu_torch.tracking import TrackState
    cfg = _rgbd_cfg()
    seen = []

    class Reloc:
        def relocalize(self, frame):
            seen.append(frame.frame_id)
            return False

    t = Tracker(cfg, MapState(cfg, 1024), None, relocalizer=Reloc(), device="cpu")
    t.state = TrackState.LOST
    img = np.full((cfg.camera.height, cfg.camera.width), 128, np.uint8)
    depth = np.ones(img.shape, np.float32)
    assert t.process_image(img, 0.0, depth_map=depth) is None
    assert seen == [0] and t.state == TrackState.LOST and t.last_reloc_frame_id == -1


def test_vocabulary_argument(tmp_path):
    """None loads the shipped vocabulary once for every System; a path or a
    Vocabulary is taken as given, and reset() rebuilds database and
    relocalizer on it."""
    from orbslam2_tpu_torch.io import vocabulary as V
    a, b = P.System(_rgbd_cfg(), device="cpu"), P.System(_rgbd_cfg(), device="cpu")
    assert a.vocabulary is b.vocabulary is V.default_vocabulary()
    small = V.train_vocabulary(np.random.default_rng(0).integers(
        0, 2 ** 32, (400, 8), dtype=np.uint32), k=4, levels=2, seed=0)
    small.save(tmp_path / "small.npz")
    for given in (small, tmp_path / "small.npz", str(tmp_path / "small.npz")):
        s = P.System(_rgbd_cfg(), device="cpu", vocabulary=given)
        assert s.vocabulary.n_words == small.n_words == s.kf_db.n_words
    db, reloc = s.kf_db, s.relocalizer
    s.reset()
    assert s.kf_db is not db and s.relocalizer is not reloc
    assert s.relocalizer.voc is s.vocabulary and s.kf_db.map is s.map
    assert s.local_mapper.kf_db is s.kf_db and s.tracker.relocalizer is s.relocalizer


def test_track_rgbd_needs_an_rgbd_system():
    s = P.System(P.SlamConfig(max_points=256, max_keyframes=4), device="cpu")
    with pytest.raises(ValueError):
        s.track_rgbd(np.zeros((480, 640), np.uint8), np.ones((480, 640), np.float32), 0.0)


def test_mono_keyframes_are_as_wide_as_the_init_frames():
    """Monocular initialization extracts twice the feature budget, and its
    two frames become keyframes: the map's keyframe rows hold them."""
    mono = P.System(_cfg(P.Sensor.MONOCULAR), device="cpu")
    rgbd = P.System(_rgbd_cfg(), device="cpu")
    assert mono.map.kf_xy.shape[1] == 2 * rgbd.map.kf_xy.shape[1] == 2048
    assert mono.tracker.init_builder.orb.n_features == 2000
    assert mono.tracker.builder.orb.n_features == 1000
    assert rgbd.tracker.init_builder is rgbd.tracker.builder


def test_load_settings_parity(tmp_path):
    yaml = tmp_path / "cam.yaml"
    yaml.write_text(
        "%YAML:1.0\n"
        "Camera.fx: 535.4\nCamera.fy: 539.2\nCamera.cx: 320.1\nCamera.cy: 247.6\n"
        "Camera.k1: 0.1\nCamera.k2: -0.2\nCamera.p1: 0.0\nCamera.p2: 0.0\n"
        "Camera.width: 640\nCamera.height: 480\nCamera.fps: 30.0\nCamera.bf: 40.0\n"
        "Camera.RGB: 1\nThDepth: 40.0\nDepthMapFactor: 5000.0\n"
        "ORBextractor.nFeatures: 1000\nORBextractor.scaleFactor: 1.2\n"
        "ORBextractor.nLevels: 8\nORBextractor.iniThFAST: 20\n"
        "ORBextractor.minThFAST: 7\n")
    for sensor in (0, 2):
        j = JC.load_settings(yaml, JC.Sensor(sensor))
        t = P.load_settings(yaml, P.Sensor(sensor))
        assert dataclasses.asdict(t.camera) == dataclasses.asdict(j.camera)
        assert dataclasses.asdict(t.orb) == dataclasses.asdict(j.orb)
        assert (t.th_depth, t.depth_map_factor, t.fps, t.rgb_order) == \
            (j.th_depth, j.depth_map_factor, j.fps, j.rgb_order)
        assert t.close_depth_threshold == j.close_depth_threshold


def test_descriptor_interop_round_trip():
    u = np.random.default_rng(0).integers(0, 2 ** 32, (5, 8), dtype=np.uint32)
    i = interop.desc_u32_to_i32(u)
    assert i.dtype == np.int32
    np.testing.assert_array_equal(interop.desc_i32_to_u32(i), u)
    assert (i < 0).any()  # high bits land in the sign


def test_native_map_ops_match_numpy_fallback():
    assert native.available()  # g++ builds mapops.cpp into build/
    rng = np.random.default_rng(1)
    cfg = P.SlamConfig(max_points=512, max_keyframes=8)
    mp = MapState(cfg, 64)
    mp.kf_valid[:6] = True
    mp.kf_pt[:6] = np.where(rng.random((6, 64)) < 0.6, rng.integers(0, 200, (6, 64)), -1)
    mp.pt_valid[:200] = True
    w_native = mp.covisibility_weights(2)
    seen = np.zeros(512, bool)
    seen[mp.kf_pt[2][mp.kf_pt[2] >= 0]] = True
    w_np = (seen[np.clip(mp.kf_pt, 0, None)] & (mp.kf_pt >= 0)).sum(1)
    w_np[2] = 0
    w_np[~mp.kf_valid] = 0
    np.testing.assert_array_equal(w_native, w_np)
    descs = rng.integers(-2 ** 31, 2 ** 31, (9, 8)).astype(np.int32)
    med = native.medoid_descriptors(descs, np.array([0, 4, 9]))
    for g, (a, b) in enumerate([(0, 4), (4, 9)]):
        d = descs[a:b]
        x = d[:, None, :] ^ d[None, :, :]
        dist = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).sum(-1)
        assert med[g] == a + np.argmin(dist)


def test_point_mirror_follows_the_map():
    """Dirty rows are copied into the device mirror in place (index_copy_);
    a grown table is uploaded whole."""
    cfg = _rgbd_cfg()
    mp = MapState(cfg, 1024)
    tr = Tracker(cfg, mp, device="cpu")
    ids = mp.add_points(np.ones((10, 3), np.float32),
                        np.arange(80, dtype=np.int32).reshape(10, 8) - 40, 0, 0)
    tr._refresh_mirror()
    mirror0 = tr._mirror[0]
    mp.pt_xyz[ids[3]] = (7.0, 8.0, 9.0)
    mp.mark_points_dirty([ids[3]])
    tr._refresh_mirror()
    assert tr._mirror[0] is mirror0  # updated in place
    np.testing.assert_array_equal(tr._mirror[0].numpy(), mp.pt_xyz)
    np.testing.assert_array_equal(tr._mirror[1].numpy(), mp.pt_desc)
    mp.add_points(np.zeros((300, 3), np.float32), np.zeros((300, 8), np.int32), 0, 0)
    tr._refresh_mirror()  # capacity doubled: full upload
    assert tr._mirror[0].shape[0] == mp.pt_xyz.shape[0] == 512
    np.testing.assert_array_equal(tr._mirror[6].numpy(), mp.pt_valid)


def _bench_configs(sensor: str):
    """(JAX, port) configuration of one of bench.py's full-system rows
    (bench.py:46-56), the JAX one built here as the bench builds it."""
    from orbslam2_tpu.io import synth as JS
    from orbslam2_tpu_torch.io import synth as TS
    from orbslam2_tpu_torch.utils.profile_frame import bench_config
    scene = JS.make_room(seed=0)
    j = JC.with_camera(
        JC.SlamConfig(sensor=JC.Sensor[sensor],
                      th_depth=25.0 if sensor != "MONOCULAR" else 35.0),
        fx=float(scene.K[0, 0]), fy=float(scene.K[1, 1]),
        cx=float(scene.K[0, 2]), cy=float(scene.K[1, 2]),
        k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
        width=scene.width, height=scene.height)
    if sensor != "MONOCULAR":
        j = dataclasses.replace(j, camera=dataclasses.replace(j.camera, bf=250.0))
    return j, bench_config(TS.make_room(seed=0), P.Sensor[sensor])


def _assert_same_config(j, t):
    assert dataclasses.asdict(t.camera) == dataclasses.asdict(j.camera)
    assert dataclasses.asdict(t.orb) == dataclasses.asdict(j.orb)
    assert (t.sensor.value, t.th_depth, t.local_points_cap, t.max_points) == \
        (j.sensor.value, j.th_depth, j.local_points_cap, j.max_points)


def test_bench_rgbd_config_matches_the_bench():
    """The frame profiler's and chip_smoke.py's configuration is bench.py's
    RGB-D row, built here with the JAX package."""
    _assert_same_config(*_bench_configs("RGBD"))


@pytest.mark.parametrize("sensor", ["STEREO", "MONOCULAR"])
def test_bench_config_matches_the_bench_rows(sensor):
    j, t = _bench_configs(sensor)
    _assert_same_config(j, t)
    assert t.close_depth_threshold == j.close_depth_threshold


def test_frame_profiler_needs_a_card():
    from orbslam2_tpu_torch.utils import profile_frame
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a CUDA device")
    with pytest.raises(SystemExit, match="CUDA"):
        profile_frame.main([])


def test_upload_never_aliases_the_host_array():
    """On the CPU an upload is a copy: the mapping thread may write the
    host map while a device program still reads its input."""
    from orbslam2_tpu_torch.utils.device import constant, upload
    a = np.arange(6, dtype=np.float32)
    t = upload(a, torch.device("cpu"))
    a[0] = 7.0
    assert t[0].item() == 0.0
    c1 = constant("probe", lambda: np.ones(3, np.float32), torch.device("cpu"))
    c2 = constant("probe", lambda: np.zeros(3, np.float32), torch.device("cpu"))
    assert c1 is c2  # built once per key and device
