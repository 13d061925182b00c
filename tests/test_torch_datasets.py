"""The port's dataset drivers against the JAX package's, on the CPU: its PNG
reader, the TUM / KITTI / EuRoC iterators, the EuRoC stereo rectification
and the run_dataset command.

The port decodes PNGs itself (io/png.py; the card's machine has no OpenCV),
so the readers are held to cv2.imread and to the JAX iterators exactly:
every pixel, dtype and timestamp. The rectification maps are held within
1e-3 px of cv2.initUndistortRectifyMap's, and the remapped image within one
gray level of JAX's (cv2.remap) at every pixel whose source window lies
inside the image. run_dataset runs a 320x240 TUM RGB-D and KITTI stereo
directory under the gates of tests/test_run_dataset.py.
"""
import struct
import zlib

import numpy as np
import pytest
import torch

from orbslam2_tpu.io import datasets as JD
from orbslam2_tpu.io.rectify import load_rectification as j_load_rectification
from orbslam2_tpu_torch.io import datasets as TD
from orbslam2_tpu_torch.io import synth
from orbslam2_tpu_torch.io.png import read_png
from orbslam2_tpu_torch.io.rectify import load_rectification, undistort_rectify_map
from orbslam2_tpu_torch.run_dataset import main as run_dataset

cv2 = pytest.importorskip("cv2")
import test_rectify as TR  # noqa: E402  (its YAML writer and distortion)
import torch_slice_common  # noqa: E402,F401  (caps torch's CPU threads)

_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def write_png(path, px: np.ndarray, colour: int, depth: int, filt: int):
    """A PNG of `px` (samples in file order: gray, RGB, gray-alpha, RGBA)
    with every scanline under filter `filt`, or filter r % 5 on row r when
    `filt` is -1."""
    h, w = px.shape[:2]
    ch = _CHANNELS[colour]
    raw = px.astype(">u2").tobytes() if depth == 16 else px.astype(np.uint8).tobytes()
    bpp = ch * depth // 8
    rows = np.frombuffer(raw, np.uint8).reshape(h, w * bpp).astype(np.int32)
    prev = np.zeros(w * bpp, np.int32)
    lines = []
    for r in range(h):
        f = filt if filt >= 0 else r % 5
        x = rows[r]
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        p = a + prev - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, ul))
        pred = [0, a, prev, (a + prev) >> 1, paeth][f]
        lines.append(bytes([f]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = x

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(b"".join(lines)))
                 + chunk(b"IEND", b""))


@pytest.mark.parametrize("colour,depth", [(0, 8), (2, 8), (4, 8), (6, 8), (0, 16)])
@pytest.mark.parametrize("filt", [-1, 0, 1, 2, 3, 4])
def test_png_reader_matches_imread(tmp_path, colour, depth, filt):
    """Every filter, colour type and bit depth the reader takes, as
    cv2.imread reads them in gray and unchanged; 1-pixel-wide and -high
    images too."""
    rng = np.random.default_rng(colour * 100 + depth + filt)
    for h, w in ((37, 53), (1, 9), (11, 1)):
        shape = (h, w) if _CHANNELS[colour] == 1 else (h, w, _CHANNELS[colour])
        path = tmp_path / "x.png"
        write_png(path, rng.integers(0, 2 ** depth, shape), colour, depth, filt)
        for flag, unchanged in ((cv2.IMREAD_GRAYSCALE, False),
                                (cv2.IMREAD_UNCHANGED, True)):
            ref, got = cv2.imread(str(path), flag), read_png(path, unchanged)
            assert (ref.shape, ref.dtype) == (got.shape, got.dtype)
            np.testing.assert_array_equal(got, ref)


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    path = tmp_path / "x.png"
    write_png(path, np.zeros((4, 4, 3), np.uint16), 2, 16, 0)
    with pytest.raises(ValueError, match="16 bits"):
        read_png(path)
    data = bytearray((tmp_path / "x.png").read_bytes())
    data[40] ^= 1  # inside IHDR's CRC span
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        read_png(path)
    with pytest.raises(FileNotFoundError):
        read_png(tmp_path / "missing.png")


def _img(rng, colour=False):
    shape = (48, 64, 3) if colour else (48, 64)
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _layouts(root):
    """Short sequences in the six layouts, written by cv2.imwrite: colour
    PNGs where the dataset has colour, u16 depth at factor 5000."""
    rng = np.random.default_rng(0)
    tum = root / "tum"
    for d in ("rgb", "depth"):
        (tum / d).mkdir(parents=True)
    rgb_lines, assoc = ["# color images", "# timestamp filename"], []
    for i in range(4):
        ts = 1305031102.175304 + i / 30.0
        cv2.imwrite(str(tum / f"rgb/{ts:.6f}.png"), _img(rng, colour=True))
        cv2.imwrite(str(tum / f"depth/{ts:.6f}.png"),
                    rng.integers(0, 40000, (48, 64)).astype(np.uint16))
        rgb_lines.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        # depth first on odd lines: the reader takes either order
        pair = [f"{ts:.6f} rgb/{ts:.6f}.png", f"{ts + 0.01:.6f} depth/{ts:.6f}.png"]
        assoc.append(" ".join(pair if i % 2 == 0 else pair[::-1]))
    (tum / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (tum / "associations.txt").write_text("\n".join(assoc) + "\n\n")
    kitti = root / "kitti"
    for d in ("image_0", "image_1"):
        (kitti / d).mkdir(parents=True)
        for i in range(3):
            cv2.imwrite(str(kitti / d / f"{i:06d}.png"), _img(rng))
    (kitti / "times.txt").write_text("0.000000e+00\n1.036223e-01\n2.072446e-01\n")
    mav0 = root / "mav0"
    stamps = [1403636579763555584 + 50_000_000 * i for i in range(4)]
    for cam in ("cam0", "cam1"):
        (mav0 / cam / "data").mkdir(parents=True)
        lines = ["#timestamp [ns],filename"]
        for i, ns in enumerate(stamps):
            if cam == "cam1" and i == 2:
                continue  # a left image without its right one is skipped
            cv2.imwrite(str(mav0 / cam / "data" / f"{ns}.png"), _img(rng))
            lines.append(f"{ns},{ns}.png")
        (mav0 / cam / "data.csv").write_text("\n".join(lines) + "\n")
    return tum, kitti, mav0


def _same_items(jit, tit):
    j, t = list(jit), list(tit)
    assert len(j) == len(t) > 0
    for (jts, jd), (tts, td) in zip(j, t):
        assert jts == tts and jd.keys() == td.keys()
        for k in jd:
            assert (jd[k].dtype, jd[k].shape) == (td[k].dtype, td[k].shape), k
            np.testing.assert_array_equal(td[k], jd[k])
    return len(t)


def test_iterators_match_jax(tmp_path):
    """The six layouts item for item: timestamps, arrays and dtypes."""
    tum, kitti, mav0 = _layouts(tmp_path)
    assert TD.load_tum_rgb(tum) == JD.load_tum_rgb(tum)
    assert TD.load_tum_associations(tum) == JD.load_tum_associations(tum)
    assert TD.load_kitti_times(kitti) == JD.load_kitti_times(kitti)
    assert TD._euroc_stamps(mav0 / "cam0") == JD._euroc_stamps(mav0 / "cam0")
    counts = [
        _same_items(JD.iter_tum_mono(tum), TD.iter_tum_mono(tum)),
        _same_items(JD.iter_tum_rgbd(tum), TD.iter_tum_rgbd(tum)),
        _same_items(JD.iter_tum_rgbd(tum, tum / "associations.txt", depth_factor=2e-4),
                    TD.iter_tum_rgbd(tum, tum / "associations.txt", depth_factor=2e-4)),
        _same_items(JD.iter_kitti_mono(kitti), TD.iter_kitti_mono(kitti)),
        _same_items(JD.iter_kitti_stereo(kitti), TD.iter_kitti_stereo(kitti)),
        _same_items(JD.iter_euroc(mav0), TD.iter_euroc(mav0)),
        _same_items(JD.iter_euroc(mav0, stereo=True), TD.iter_euroc(mav0, stereo=True)),
    ]
    assert counts == [4, 4, 4, 3, 3, 4, 3]
    depth = next(iter(TD.iter_tum_rgbd(tum)))[1]["depth"]
    assert depth.dtype == np.uint16  # sensor units: the tracker scales them


def test_rectification_matches_jax(tmp_path):
    """The maps within 1e-3 px of cv2's, the remapped images within one
    gray level of JAX's (cv2.remap) wherever the source window lies inside
    the image, and the rectified intrinsics equal."""
    yaml = tmp_path / "stereo.yaml"
    TR._write_settings(yaml)
    ours, theirs = load_rectification(yaml), j_load_rectification(yaml)
    assert ours[2:] == theirs[2:]
    for D in (TR.D, TR.D[:4], np.array([-0.3, 0.1, 1e-3, -2e-3, 0.02])):
        R = cv2.Rodrigues(np.array([0.01, -0.02, 0.005]))[0]
        m1, m2 = cv2.initUndistortRectifyMap(TR.K, D, R, TR.P_L[:3, :3], (TR.W, TR.H),
                                             cv2.CV_32F)
        u, v = undistort_rectify_map(TR.K, D, R, TR.P_L, (TR.W, TR.H))
        assert np.abs(u - m1).max() < 1e-3 and np.abs(v - m2).max() < 1e-3
    rng = np.random.default_rng(1)
    m1, m2 = cv2.initUndistortRectifyMap(TR.K, TR.D, np.eye(3), TR.P_L[:3, :3],
                                         (TR.W, TR.H), cv2.CV_32F)
    inside = (m1 >= 0) & (m1 <= TR.W - 1) & (m2 >= 0) & (m2 <= TR.H - 1)
    assert inside.mean() > 0.5
    for side in (0, 1):
        for img in (rng.integers(0, 256, (TR.H, TR.W), dtype=np.uint8),
                    TR._distort(np.clip(synth.render_room(
                        synth.make_room(seed=0, width=TR.W, height=TR.H, fx=240.0,
                                        fy=240.0), synth.orbit_trajectory(2)[1]),
                        0, 255).astype(np.uint8))):
            diff = np.abs(ours[side](img).astype(int) - theirs[side](img).astype(int))
            assert diff[inside].max() <= 1, diff[inside].max()


def test_rectification_straightens_epipolar_lines(tmp_path):
    """tests/test_rectify.py's stripes on the port: a boundary bent by tens
    of pixels in the raw image comes back straight (< 1 px), where the ideal
    rectified image puts it; a YAML without the blocks gives None."""
    yaml = tmp_path / "stereo.yaml"
    TR._write_settings(yaml)
    rect_l = load_rectification(yaml)[0]
    stripes = (255 * ((np.arange(TR.H)[:, None] // 24) % 2)
               * np.ones((1, TR.W))).astype(np.uint8)
    raw = TR._distort(stripes)

    def edge_spread(img, lo, hi):
        rows = []
        f = img.astype(float)
        for c in range(8, TR.W - 8):
            g = np.diff(f[:, c])
            r = int(np.argmax(np.abs(g[lo:hi]))) + lo
            w = np.abs(g[r - 2:r + 3])
            rows.append((w * np.arange(r - 2, r + 3)).sum() / max(w.sum(), 1e-9))
        return float(np.ptp(rows))

    assert edge_spread(raw, 36, 60) > 10.0
    out = rect_l(raw)
    assert edge_spread(out, 36, 60) < 1.0
    assert np.abs(out[40:-40, 40:-40].astype(int)
                  - stripes[40:-40, 40:-40].astype(int)).mean() < 15.0
    plain = tmp_path / "plain.yaml"
    plain.write_text("%YAML:1.0\nCamera.fx: 500.0\n")
    assert load_rectification(plain) is None


W, H, F = 320, 240, 250.0


def _settings(path, fps, extra=""):
    path.write_text(
        "%YAML:1.0\n"
        f"Camera.fx: {F}\nCamera.fy: {F}\nCamera.cx: {W / 2}\nCamera.cy: {H / 2}\n"
        "Camera.k1: 0.0\nCamera.k2: 0.0\nCamera.p1: 0.0\nCamera.p2: 0.0\n"
        f"Camera.width: {W}\nCamera.height: {H}\nCamera.fps: {fps}\n"
        f"Camera.bf: {F * 0.5}\nCamera.RGB: 1\nThDepth: 25.0\n{extra}"
        "ORBextractor.nFeatures: 500\nORBextractor.scaleFactor: 1.2\n"
        "ORBextractor.nLevels: 8\nORBextractor.iniThFAST: 20\n"
        "ORBextractor.minThFAST: 7\n")
    return path


def test_run_dataset_rgbd_tum(tmp_path):
    """tests/test_run_dataset.py's TUM RGB-D case at 320x240 on the CPU."""
    n = 12
    scene = synth.make_room(seed=0, width=W, height=H, fx=F, fy=F)
    gt = synth.orbit_trajectory(n)
    seq = tmp_path / "seq"
    (seq / "rgb").mkdir(parents=True)
    (seq / "depth").mkdir()
    lines = []
    for i in range(n):
        ts = i / 30.0
        img = np.clip(synth.render_room(scene, gt[i], seed=i), 0, 255).astype(np.uint8)
        cv2.imwrite(str(seq / f"rgb/{ts:.6f}.png"), img)
        cv2.imwrite(str(seq / f"depth/{ts:.6f}.png"),
                    (synth.depth_room(scene, gt[i]) * 5000.0).astype(np.uint16))
        lines.append(f"{ts:.6f} rgb/{ts:.6f}.png {ts:.6f} depth/{ts:.6f}.png")
    (seq / "associations.txt").write_text("\n".join(lines) + "\n")
    settings = _settings(tmp_path / "settings.yaml", 30.0, "DepthMapFactor: 5000.0\n")
    out = tmp_path / "out"
    rc = run_dataset(["rgbd_tum", str(settings), str(seq), str(seq / "associations.txt"),
                      "--out-dir", str(out), "--device", "cpu"])
    assert rc == 0
    traj = np.loadtxt(out / "CameraTrajectory.txt")
    assert traj.shape[1] == 8 and len(traj) >= n - 4
    kf = np.atleast_2d(np.loadtxt(out / "KeyFrameTrajectory.txt"))
    assert kf.shape[0] >= 1 and kf.shape[1] == 8
    assert traj[-1, 1] > traj[0, 1] + 0.1


def test_run_dataset_stereo_kitti(tmp_path):
    """tests/test_run_dataset.py's KITTI stereo case at 320x240 on the CPU."""
    n = 14
    scene = synth.make_room(seed=0, width=W, height=H, fx=F, fy=F)
    gt = synth.orbit_trajectory(n)
    seq = tmp_path / "00"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir()
    for i in range(n):
        right = gt[i].copy()
        right[:, 3] -= np.array([0.5, 0, 0], np.float32)
        for d, T, seed in (("image_0", gt[i], i), ("image_1", right, 10_000 + i)):
            img = np.clip(synth.render_room(scene, T, seed=seed), 0, 255).astype(np.uint8)
            cv2.imwrite(str(seq / d / f"{i:06d}.png"), img)
    (seq / "times.txt").write_text("\n".join(f"{i / 10.0:.6e}" for i in range(n)) + "\n")
    settings = _settings(tmp_path / "settings.yaml", 10.0)
    out = tmp_path / "out"
    rc = run_dataset(["stereo_kitti", str(settings), str(seq),
                      "--out-dir", str(out), "--device", "cpu"])
    assert rc == 0
    traj = np.loadtxt(out / "CameraTrajectory.txt")
    assert traj.ndim == 2 and traj.shape[1] == 8 and len(traj) >= n - 2
    assert np.all(np.isfinite(traj))
    kt = np.loadtxt(out / "CameraTrajectoryKITTI.txt")
    assert kt.ndim == 2 and kt.shape[1] == 12
    R = kt[-1].reshape(3, 4)[:, :3]
    assert np.allclose(R @ R.T, np.eye(3), atol=1e-4)
    assert traj[-1, 1] > traj[0, 1] + 0.1


def test_run_dataset_needs_the_card_or_the_cpu_asked_for(tmp_path, monkeypatch, capsys):
    """The default device is the card: without one the command fails
    (nothing is written) unless --device cpu is given; --viewer is accepted
    (the device check still decides)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    settings = _settings(tmp_path / "settings.yaml", 30.0)
    out = tmp_path / "out"
    args = ["mono_tum", str(settings), str(tmp_path), "--out-dir", str(out)]
    assert run_dataset(args) == 2
    assert "no CUDA device" in capsys.readouterr().err and not out.exists()
    assert run_dataset(args + ["--viewer"]) == 2
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "viewer" not in err and not out.exists()
